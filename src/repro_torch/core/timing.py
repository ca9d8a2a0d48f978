"""Kernel timing of the torch port: the port of ``repro.core.timing``,
the measurement half of the predict -> run -> measure -> recalibrate loop.

* :func:`time_callable` — the harness every measurement goes through:
  warmup calls first, then median-of-K timed calls on the host clock,
  each fenced: on the card by ``torch.cuda.synchronize()`` (PyTorch
  returns before the device finishes), on CPU tensors by nothing (the
  call has finished when it returns).
* :func:`region_times` — per-kernel timing of a compiled
  ``pipeline.CompiledKernel`` on the ``cuda`` backend: each emitted
  kernel (a region-group megakernel counts once) is timed standalone
  with inputs threaded exactly as the real execution threads them.  On
  the card each sample is CUDA events around a run of back-to-back
  launches after warmup; on CPU tensors (the kernels' plain versions) it
  is :func:`time_callable`.  Entries carry the kernel id;
  :func:`pair_region_times` matches them with
  ``CompiledKernel.region_costs`` *by id*, :func:`pair_region_features`
  with ``calibrate.group_features`` rows (the samples
  ``calibrate.fit_profile`` fits), and :func:`stage_time_attribution`
  splits a megakernel's time across its member regions.
* :func:`synth_inputs` — synthetic merged inputs for a program at given
  dims and block extents (position vectors get ``arange``, data gets
  scaled normals from an explicit ``torch.Generator``), on any device.
* :func:`measured` — a process-wide measurement memo keyed by
  ``(fingerprint, dims, backend, device, ...)`` so the autotuner never
  times the same configuration twice.
* :func:`spearman` — rank agreement between predicted and measured
  orderings (the calibration acceptance metric).

There is no jit step: the emitted kernels are compiled before they run.
"""

from __future__ import annotations

import platform
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.blocks import merged_shape
from repro_torch.core.graph import Graph

# names that carry global positions, not data (the attention programs'
# query/key position vectors): synthetic inputs must keep them ordinal
POSITION_INPUTS = ("QP", "KP")


def _tensors(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors(o)]
    return []


def _on_card(out) -> bool:
    return any(t.is_cuda for t in _tensors(out))


def _sync(out) -> None:
    """Wait until ``out`` (a tensor, or a dict, tuple or list of them) is
    computed: a device synchronize when any of it lies on the card."""
    if _on_card(out):
        torch.cuda.synchronize()


def device_kind(device) -> str:
    """The identity measurements on ``device`` are keyed by: the card's
    name for a CUDA device, else the machine's name."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("measuring on the card needs one: torch "
                               "sees no CUDA device (pass device='cpu' to "
                               "time the kernels' plain versions)")
        return torch.cuda.get_device_name(dev)
    return platform.machine() or "cpu"


@dataclass(frozen=True)
class TimingResult:
    times_s: Tuple[float, ...]

    @property
    def median_s(self) -> float:
        return float(np.median(self.times_s))

    @property
    def best_s(self) -> float:
        return float(min(self.times_s))


def time_callable(fn: Callable, *args, warmup: int = 1, repeats: int = 5,
                  **kwargs) -> TimingResult:
    """Median-of-``repeats`` wall time of ``fn(*args, **kwargs)`` after
    ``warmup`` untimed calls; every call is fenced."""
    for _ in range(max(warmup, 0)):
        _sync(fn(*args, **kwargs))
    times = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        _sync(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return TimingResult(tuple(times))


def time_launches(fn: Callable, *args, warmup: int = 3, repeats: int = 5,
                  launches: int = 20) -> TimingResult:
    """Device seconds per call of ``fn(*args)`` on the card: each of
    ``repeats`` samples is CUDA events around ``launches`` back-to-back
    calls, after ``warmup`` calls, over the count.  A kernel shorter than
    its launch is timed at the host's enqueue rate."""
    for _ in range(max(warmup, 0)):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(max(repeats, 1)):
        start.record()
        for _ in range(max(launches, 1)):
            fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / max(launches, 1))
    return TimingResult(tuple(times))


# ---------------------------------------------------------------------------
# Synthetic inputs
# ---------------------------------------------------------------------------

def stack_dims(g: Graph) -> frozenset:
    """Dims that appear as leading stack axes of some program input: the
    ``cuda`` backend requires block size 1 for them."""
    out = set()
    for nid in g.input_ids:
        vt = g.nodes[nid].vtype
        out.update(vt.dims[:vt.lead_dims])
    return frozenset(out)


def synth_blocks(g: Graph, dims: Dict[str, int],
                 item: int = 8) -> Dict[str, int]:
    """A valid per-dim block-extent map for ``g``: ``item`` everywhere,
    1 on stack dims."""
    sd = stack_dims(g)
    return {d: (1 if d in sd else item) for d in dims}


def synth_inputs(g: Graph, dims: Dict[str, int],
                 blocks: Optional[Dict[str, int]] = None, *,
                 item: int = 8, device="cpu",
                 generator: Optional[torch.Generator] = None,
                 seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random merged float32 inputs for ``g`` at ``dims`` with per-dim
    block extents ``blocks`` (default: :func:`synth_blocks`), on
    ``device``.  Data inputs are normals scaled by the contraction width,
    drawn on the CPU from ``generator`` (default: one seeded with
    ``seed``), so a device gets the same values as the CPU; position
    inputs get ``arange`` so causal masks stay meaningful."""
    gen = (generator if generator is not None
           else torch.Generator().manual_seed(seed))
    blocks = blocks if blocks is not None else synth_blocks(g, dims, item)
    out = {}
    for nid in g.input_ids:
        node = g.nodes[nid]
        vt = node.vtype
        ish = tuple(blocks.get(d, item) for d in vt.dims[vt.lead_dims:])
        shape = merged_shape(vt, ish, dims)
        if node.name in POSITION_INPUTS:
            t = torch.arange(shape[0], dtype=torch.float32)
        else:
            t = (torch.randn(shape, generator=gen, dtype=torch.float32)
                 / max(shape[-1], 1) ** 0.5)
        out[node.name] = t.to(device)
    return out


# ---------------------------------------------------------------------------
# Per-kernel timing of a compiled plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RegionTime:
    label: str
    result: TimingResult
    gid: str = ""  # id of the emitted kernel (codegen_cuda.KernelRun)

    @property
    def median_s(self) -> float:
        return self.result.median_s


def region_times(kern, inputs: Dict[str, Any], *, warmup: int = 1,
                 repeats: int = 5, launches: int = 20,
                 instances: int = 0) -> Optional[List[RegionTime]]:
    """Time of each emitted kernel of a compiled ``cuda``-backend
    ``CompiledKernel``: one entry per launched kernel (a region-group
    megakernel serving several regions is one entry), each carrying the
    kernel id (``gid``); pair with ``kern.region_costs`` by
    :func:`pair_region_times`, never by position.

    The kernels run in launch order with the real intermediates threaded
    between them (what ``kern(inputs)`` does), and each is then timed
    standalone: on CUDA inputs by :func:`time_launches` (``repeats``
    samples of ``launches`` launches; ``warmup`` at least 1), on CPU
    inputs by :func:`time_callable`.  Returns ``None`` for kernels that
    expose no region runners (the ``py`` and ``torch`` backends)."""
    raw = getattr(getattr(kern, "_fn", None), "raw_program", None)
    runners = getattr(raw, "region_runners", None)
    if runners is None:
        return None
    merged = [inputs[nm] for nm in kern.in_names]
    env: Dict[Tuple[int, int], Any] = dict(zip(raw.input_refs, merged))
    card = _on_card(merged)
    out: List[RegionTime] = []
    for spec, fn in runners:
        args = [env[r] for r in spec.in_refs]

        def call(fn=fn, args=args):
            return fn(*args, instances=instances)

        # the first call is the real execution whose outputs thread into
        # the kernels downstream
        outs = call()
        _sync(outs)
        for ref, o in zip(spec.out_refs, outs):
            env[ref] = o
        res = (time_launches(call, warmup=max(warmup, 1), repeats=repeats,
                             launches=launches) if card
               else time_callable(call, warmup=max(warmup - 1, 0),
                                  repeats=repeats))
        out.append(RegionTime(spec.label, res, getattr(spec, "gid", "")))
    return out


def pair_region_times(kern, times: Sequence[RegionTime]
                      ) -> List[Tuple[str, float, float]]:
    """Id-based pairing of measured kernel times with the driver's
    per-kernel cost attribution: ``(gid, predicted cost, measured
    seconds)`` for every kernel present in both
    ``kern.kernel_ids``/``kern.region_costs`` and ``times``."""
    ids = getattr(kern, "kernel_ids", None)
    costs = getattr(kern, "region_costs", None)
    if not ids or not costs or len(ids) != len(costs):
        return []
    cost_of = dict(zip(ids, costs))
    out = []
    for t in times:
        if t.gid in cost_of:
            out.append((t.gid, float(cost_of[t.gid]), t.median_s))
    return out


def pair_region_features(times: Sequence[RegionTime],
                         features: Sequence[Tuple[str, Dict[str, float]]]
                         ) -> List[Tuple[str, Dict[str, float], float]]:
    """Id-based pairing of measured kernel times with per-kernel
    *feature rows* (``calibrate.group_features`` output: item counts,
    per-class ``work_*`` FLOPs, launches): ``(gid, features, seconds)``
    for every kernel present in both.  These pairs are what
    ``calibrate.fit_profile`` consumes."""
    feat_of = {gid: f for gid, f in features}
    out = []
    for t in times:
        if t.gid in feat_of:
            out.append((t.gid, feat_of[t.gid], t.median_s))
    return out


def stage_time_attribution(kern, times: Sequence[RegionTime]
                           ) -> List[Tuple[str, str, float]]:
    """Attribute each measured kernel time to the *regions* it serves:
    ``(gid, region label, seconds)`` rows where a megakernel's time is
    split across its member regions in proportion to their analytic
    standalone costs (``selection.snapshot_cost`` of each region graph:
    a model-based attribution, since the stages inside one kernel cannot
    be fenced apart).  Single-region kernels get their full time."""
    report = getattr(kern, "lowering_report", None)
    if report is None:
        return []
    labels_of: Dict[str, List[str]] = {}
    for r in report.regions:
        labels_of.setdefault(r.group, []).append(r.label)
    weights_of: Dict[str, List[float]] = {}
    from repro_torch.core import regions as R
    from repro_torch.core import selection as SEL
    try:
        gp = R.group_plan(R.plan_program(kern.graph), kern.dims,
                          kern.blocks)
    except R.RegionError:  # un-partitionable kernel graph: equal split
        gp = None
    # trust the re-derived grouping only when it reproduces the kernel's
    # own ids (it may not, e.g. under another grouping budget)
    if gp is not None and (tuple(grp.gid for grp in gp.groups)
                           == tuple(kern.kernel_ids or ())):
        for grp in gp.groups:
            labels_of[grp.gid] = [m.label for m in grp.members]
            weights_of[grp.gid] = [SEL.snapshot_cost(m.graph, kern.dims)
                                   for m in grp.members]
    out = []
    for t in times:
        labels = labels_of.get(t.gid, [t.label])
        weights = weights_of.get(t.gid, [1.0] * len(labels))
        total = sum(weights) or 1.0
        for lbl, w in zip(labels, weights):
            out.append((t.gid, lbl, t.median_s * w / total))
    return out


# ---------------------------------------------------------------------------
# Measurement memo
# ---------------------------------------------------------------------------

_MEASUREMENTS: Dict[Tuple, float] = {}


def measured(key: Tuple, thunk: Callable[[], float]) -> float:
    """Process-wide memo: run ``thunk`` (seconds) once per ``key``.
    Keys embed everything the measurement depends on (graph
    fingerprint, dims, backend, device, problem extents), so re-sweeps
    and overlapping top-K sets never re-time a configuration."""
    if key not in _MEASUREMENTS:
        _MEASUREMENTS[key] = float(thunk())
    return _MEASUREMENTS[key]


def clear_measurements() -> None:
    """Drop the memo (tests)."""
    _MEASUREMENTS.clear()


def measurement_count() -> int:
    return len(_MEASUREMENTS)


# ---------------------------------------------------------------------------
# Rank agreement
# ---------------------------------------------------------------------------

def _ranks(v: Sequence[float]) -> np.ndarray:
    a = np.asarray(v, dtype=np.float64)
    order = np.argsort(a, kind="stable")
    ranks = np.empty(len(a), dtype=np.float64)
    ranks[order] = np.arange(len(a), dtype=np.float64)
    # average ties so equal values cannot fake agreement
    for val in np.unique(a):
        m = a == val
        if m.sum() > 1:
            ranks[m] = ranks[m].mean()
    return ranks


def spearman(pred: Sequence[float], meas: Sequence[float]) -> float:
    """Spearman rank correlation between a predicted and a measured
    ordering.  Fewer than two samples is vacuous agreement (1.0); one
    constant side against a varying one is no agreement (0.0)."""
    if len(pred) != len(meas):
        raise ValueError("length mismatch")
    if len(pred) < 2:
        return 1.0
    rp, rm = _ranks(pred), _ranks(meas)
    sp, sm = rp.std(), rm.std()
    if sp == 0.0 and sm == 0.0:
        return 1.0
    if sp == 0.0 or sm == 0.0:
        return 0.0
    return float(np.corrcoef(rp, rm)[0, 1])
