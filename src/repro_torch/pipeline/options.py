"""``CompileOptions`` for the torch port: a copy of
``repro.pipeline.options`` (``src/repro/pipeline/options.py``).

One frozen, hashable dataclass holds every option that shapes the
emitted kernel.  It

* normalizes dict-valued fields (``blocks``, ``item_bytes``) into sorted
  tuples at construction, so two equal option sets compare and hash
  equal whatever the dict's insertion order;
* is hashable: model layers key their per-shape kernel ``lru_cache``s on
  it, and the serving engine's kernels are keyed by it;
* hashes into the kernel-cache key: ``cache_opts()`` gives the canonical
  opts tuple ``CacheKey`` embeds, the single source of truth for "which
  options make two compiles distinct".

Problem *shape* stays out of the options: ``dims`` / ``dim_candidates``
say what is compiled, ``CompileOptions`` says how.

One of the reference's fields is not here: ``interpret``.  The port
places a kernel by its tensors' device (``core/runtime.py``): CPU tensors
run the plain version, CUDA tensors launch the kernel, so no option
chooses between them.  ``resilience`` (the degradation-ladder policy) is
keyed only when it is not the default, as the reference keys it, so a
default-policy key is the one made before the field existed.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

_MAP_FIELDS = ("blocks", "item_bytes")


def _norm_map(value) -> Optional[Tuple[Tuple[str, Any], ...]]:
    """dict | tuple-of-pairs | None -> canonical sorted tuple of pairs."""
    if value is None:
        return None
    if isinstance(value, Mapping):
        return tuple(sorted(value.items()))
    return tuple(sorted(tuple(value)))


@dataclass(frozen=True)
class CompileOptions:
    """Everything that decides *how* a block program compiles.

    ``backend`` is ``"py"`` (the numpy interpreter), ``"torch"`` (the
    plain lowering) or ``"cuda"`` (one emitted CUDA kernel per region
    group; needs ``blocks``).  See the driver's docstring for the rest.
    ``blocks`` / ``item_bytes`` accept plain dicts and are stored as
    sorted tuples, so the instance is hashable and order-insensitive.
    """

    backend: str = "torch"
    # per-dim block sizes (cuda backend): dict accepted, stored as a
    # sorted tuple of (dim, size) pairs
    blocks: Optional[Tuple[Tuple[str, int], ...]] = None
    # cost-model per-item-kind byte overrides
    item_bytes: Optional[Tuple[Tuple[str, int], ...]] = None
    fused: bool = True
    jit: Any = True                    # True | False | "per-op" (torch)
    stabilize: Optional[bool] = None   # None = auto (softmax-bearing)
    autotune: str = "analytic"         # analytic | measured
    top_k: int = 3
    measure_repeats: int = 3
    group: bool = True                 # cuda region-group megakernels
    # calibration profile override (CalibrationProfile); takes part in
    # hashing and equality by its digest, not by object identity
    profile: Optional[Any] = None
    # degradation-ladder policy (resilience.ResiliencePolicy): how far a
    # failing compile may demote (grouped -> ungrouped -> torch ->
    # interpreter), the per-attempt timeout, the retry budget and the
    # health-ledger breaker knobs.  None = the default policy (full
    # ladder, no timeout, no retries, threshold-3 breaker)
    resilience: Optional[Any] = None

    def __post_init__(self):
        for name in _MAP_FIELDS:
            object.__setattr__(self, name, _norm_map(getattr(self, name)))

    # -- dict views ---------------------------------------------------------
    @property
    def blocks_dict(self) -> Optional[Dict[str, int]]:
        return dict(self.blocks) if self.blocks is not None else None

    @property
    def item_bytes_dict(self) -> Optional[Dict[str, int]]:
        return dict(self.item_bytes) if self.item_bytes is not None else None

    # -- identity -----------------------------------------------------------
    def _profile_digest(self) -> Optional[str]:
        return self.profile.digest() if self.profile is not None else None

    def _policy(self):
        """The effective ResiliencePolicy (``None`` -> the default)."""
        from repro_torch import resilience as RZ
        return (self.resilience if self.resilience is not None
                else RZ.DEFAULT_POLICY)

    def key(self) -> Tuple:
        """Canonical value tuple: what equality and hashing mean."""
        return (self.backend, self.blocks, self.item_bytes, self.fused,
                self.jit if self.jit == "per-op" else bool(self.jit),
                self.stabilize, self.autotune, int(self.top_k),
                int(self.measure_repeats), bool(self.group),
                self._profile_digest(), self._policy().key())

    def __hash__(self) -> int:
        return hash(self.key())

    def __eq__(self, other) -> bool:
        if not isinstance(other, CompileOptions):
            return NotImplemented
        return self.key() == other.key()

    def replace(self, **changes) -> "CompileOptions":
        """``dataclasses.replace`` that re-normalizes dict fields."""
        return dataclasses.replace(self, **changes)

    # -- the cache-key contribution -----------------------------------------
    def cache_opts(self, *, stabilized: bool, autotuned: bool,
                   profile=None, vmem_budget: Optional[int] = None,
                   measure_device: Optional[str] = None) -> Tuple:
        """The opts tuple ``CacheKey`` embeds: every option that changes
        the emitted kernel or the selection plan, nothing that doesn't.

        ``stabilized`` is the *resolved* stabilization decision (the
        ``None`` auto-detect already applied), ``autotuned`` says whether
        a ``dim_candidates`` sweep is in play (the autotune mode matters
        only then), ``profile`` is the *effective* calibration profile
        (the driver may have loaded one), and ``vmem_budget`` the resolved
        grouping budget when grouping shapes a cuda plan.  The decisions
        are the reference's, with ``torch`` for its ``jax`` backend and
        ``cuda`` for its ``pallas``, less the ``interpret`` flag, plus
        ``measure_device``: the kind of device a measured sweep times on
        (``timing.device_kind``), which the reference leaves out; a sweep
        timed on the CPU's plain versions picks another winner than one
        timed on the card, and must never serve it.
        """
        from repro_torch.core import calibrate as CAL
        opts: Tuple = ()
        if stabilized:
            opts += (("stabilize", True),)
        if self.backend == "torch":
            opts += (("jit", self.jit if self.jit == "per-op"
                      else bool(self.jit)),)
        if self.backend == "cuda":
            opts += (("jit", bool(self.jit)),)
            if not self.group:
                opts += (("group", False),)
            else:
                # the budget shapes the grouping, so a plan cached under
                # one budget must never serve another (its kernel ids and
                # launches would describe kernels that no longer exist)
                opts += (("vmem_budget", vmem_budget),)
        if self.item_bytes:
            opts += (("item_bytes", self.item_bytes),)
        if autotuned and self.autotune != "analytic":
            opts += (("autotune", self.autotune),)
            if measure_device is not None:
                opts += (("measure_device", measure_device),)
        if (profile is not None
                and profile.digest() != CAL.DEFAULT_PROFILE.digest()):
            # another calibration profile can select another snapshot or
            # dims: never serve its plan under the default's key
            opts += (("profile", profile.digest()),)
        from repro_torch import resilience as RZ
        policy = self._policy()
        if policy != RZ.DEFAULT_POLICY:
            # a bounded ladder or a timeout can change which rung's
            # kernel is cached in-process; keyed only when non-default,
            # so default keys stay byte-identical
            opts += (("resilience", policy.key()),)
        return opts


#: the defaults, shared: ``CompileOptions()`` allocates nothing new
DEFAULT_OPTIONS = CompileOptions()
