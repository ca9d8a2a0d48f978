"""Per-rank cost of one step from its op stream: collective traffic,
FLOPs, bytes, memory and roofline terms.  The port's counterpart of
``repro.runtime.hlo_analysis``, which reads XLA's ``cost_analysis()``,
``memory_analysis()`` and the partitioned HLO text; eager PyTorch has no
compiled module, so :func:`analyze_step` runs the step once under a
``TorchDispatchMode`` (:class:`OpRecorder`) and counts what each rank
runs.

Under a mesh the step's tensors are DTensors (``runtime.sharding``; the
dry-run's are on the ``meta`` device).  The recorder steps aside for an
op on DTensors, so DTensor redistributes its inputs and runs the op on
the local tensors, and those local ops come back to the recorder: every
count is at the shapes one rank computes on, never the global ones.  The
``FakeTensor`` ops DTensor's sharding propagation runs at the global
shapes are not counted.

  FLOPs   ``torch.utils.flop_counter``'s formulas (the products, the
          convolutions, attention) on each local op's shapes
  bytes   each local op's inputs read plus its outputs written; a view
          moves nothing.  The eager op stream is unfused, so this is an
          upper bound on the traffic, where XLA's "bytes accessed" counts
          the fused program
  memory  ``argument_size_in_bytes`` the arguments' local bytes;
          ``temp_size_in_bytes`` the peak of the bytes the step holds
          beyond them (each new storage counted from the op that makes it
          until it is freed: autograd's saved tensors count, because they
          are live); ``output_size_in_bytes`` the results' local bytes

Collectives are recorded as ``(kind, bytes)`` from the c10d ops: the
functional ``_c10d_functional.*`` ops DTensor issues, the in-place
``c10d.*`` ops ``runtime.collectives`` calls, and DTensor's
``_dtensor.shard_dim_alltoall``.  An async op and its wait count once, at
the op.  :func:`collective_bytes` sums them with the reference's
conventions (bytes that cross links, per device):

  all-reduce         2 x size   (ring: reduce-scatter + all-gather)
  all-gather         1 x result size
  reduce-scatter     1 x operand size
  all-to-all         1 x size
  collective-permute 1 x size

Roofline terms, per rank, against an NVIDIA H100 80GB HBM3 (SXM, 700 W):

  compute    = flops / peak_flops          (bfloat16 dense)
  memory     = hbm_bytes / hbm_bw
  collective = coll_bytes / link_bw        (NVLink, each way)

On plain tensors, with no mesh, every count is the same: a world of one,
on the CPU or the card.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 80GB HBM3 (SXM5, 700 W): the hopper-kernels guide's table
PEAK_FLOPS = 989e12      # bfloat16 dense FLOP/s
HBM_BW = 3.35e12         # bytes/s
LINK_BW = 450e9          # bytes/s, NVLink 4, each way
HBM_BYTES = 80e9         # device memory

_SCALE = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
          "all-to-all": 1.0, "collective-permute": 1.0}

#: c10d op name -> (kind, which size counts: "in" the operand, "out" the
#: result)
_COLLECTIVES = {
    "_c10d_functional.all_reduce": ("all-reduce", "in"),
    "_c10d_functional.all_reduce_": ("all-reduce", "in"),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "out"),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "in"),
    "_c10d_functional.all_to_all_single": ("all-to-all", "in"),
    "_dtensor.shard_dim_alltoall": ("all-to-all", "in"),
    "c10d.allreduce_": ("all-reduce", "in"),
    "c10d.allgather_": ("all-gather", "out"),
    "c10d._allgather_base_": ("all-gather", "out"),
    "c10d.reduce_scatter_": ("reduce-scatter", "in"),
    "c10d._reduce_scatter_base_": ("reduce-scatter", "in"),
    "c10d.alltoall_base_": ("all-to-all", "in"),
}

#: ops that allocate without writing, or only pair a collective
_NO_TRAFFIC = {"aten.empty", "aten.empty_strided", "aten.new_empty",
               "aten.new_empty_strided", "aten.empty_like",
               "_c10d_functional.wait_tensor"}


def collective_bytes(records) -> Dict[str, float]:
    """Sum ``(kind, bytes)`` collective records by kind, each scaled by
    its convention (module docstring)."""
    out: Dict[str, float] = {}
    for kind, size in records:
        out[kind] = out.get(kind, 0.0) + size * _SCALE[kind]
    return out


@dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: Dict[str, float] = field(default_factory=dict)
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW

    @property
    def total_coll(self) -> float:
        return sum(self.coll_bytes.values())

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.total_coll / self.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def fraction_of_roofline(self, model_flops_per_chip: float) -> float:
        """useful-FLOPs time / bound time: how close the *model* math runs
        to the hardware bound if perfectly overlapped."""
        if self.t_bound == 0:
            return 0.0
        return (model_flops_per_chip / self.peak_flops) / self.t_bound

    def summary(self) -> Dict[str, float]:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.total_coll,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
        }


def model_flops(n_params_active: float, tokens: float,
                kind: str = "train") -> float:
    """6·N·D for training; 2·N·D for a forward/serve step (per global
    batch)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens


def _local(t):
    """The tensor one rank holds: a DTensor's local shard, else ``t``."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_bytes(tree) -> int:
    """The local bytes of every tensor leaf of ``tree``."""
    return sum(_nbytes(_local(t)) for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


class OpRecorder(TorchDispatchMode):
    """Counts the local ops run under it (module docstring): ``flops``,
    ``hbm_bytes``, collective ``records``, the op count ``n_ops``, and the
    live bytes of the storages the ops make (``peak_bytes``: their
    largest sum)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.records: List[Tuple[str, int]] = []
        self.n_ops = 0
        self.live = 0
        self.peak_bytes = 0
        self._storages: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = [a for a in pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out        # DTensor's propagation at global shapes
        self._count(func, ins, outs, args, kwargs, out)
        return out

    def _count(self, func, ins, outs, args, kwargs, out) -> None:
        self.n_ops += 1
        name = func._overloadpacket._qualified_op_name.replace("::", ".")
        coll = _COLLECTIVES.get(name)
        if coll is not None:
            kind, which = coll
            src = ins[:1] if which == "in" else outs
            self.records.append((kind, sum(_nbytes(t) for t in src)))
        in_keys = {_storage_key(t) for t in ins}
        new = [o for o in outs if _storage_key(o) not in in_keys]
        for o in new:
            self._track(o)
        if coll is None and name not in _NO_TRAFFIC:
            self.hbm_bytes += _traffic(func, name, args, kwargs, ins, outs,
                                       new)
        from torch.utils.flop_counter import flop_registry
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)


#: in-place ops that write only the elements their source gives
_SCATTERS = {"aten.index_copy_", "aten.index_put_", "aten._index_put_impl_",
             "aten.index_add_", "aten.scatter_", "aten.scatter_add_",
             "aten.scatter_reduce_", "aten.masked_scatter_"}


def _traffic(func, name, args, kwargs, ins, outs, new) -> int:
    """The bytes one op moves: its inputs read and its outputs written.
    A view (no new storage, nothing mutated) moves nothing; an in-place
    op writes its mutated argument once (a scatter only the elements of
    its source) and reads the others."""
    written = [a for a, arg in zip(args, func._schema.arguments)
               if isinstance(a, torch.Tensor) and arg.alias_info is not None
               and arg.alias_info.is_write]
    if not new and not written:
        return 0
    if not written:
        return sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
    keys = {_storage_key(t) for t in written}
    read = [t for t in ins if _storage_key(t) not in keys]
    if name in _SCATTERS:
        src = max((t for t in read if t.is_floating_point()
                   or t.dtype == written[0].dtype), key=_nbytes,
                  default=None)
        wrote = _nbytes(src) if src is not None else 0
    else:
        wrote = sum(map(_nbytes, written))
    return sum(map(_nbytes, read)) + wrote


@dataclass
class StepAnalysis:
    """One step's per-rank counts: the :class:`Roofline` and the memory
    keys of the reference's ``memory_analysis()``."""
    roofline: Roofline
    argument_size_in_bytes: int
    temp_size_in_bytes: int
    output_size_in_bytes: int
    n_ops: int

    def memory(self) -> Dict[str, int]:
        return {"argument_size_in_bytes": self.argument_size_in_bytes,
                "output_size_in_bytes": self.output_size_in_bytes,
                "temp_size_in_bytes": self.temp_size_in_bytes}


def analyze_step(step, args) -> StepAnalysis:
    """Run ``step(*args)`` once under an :class:`OpRecorder` and return
    its per-rank :class:`StepAnalysis` (module docstring).  Under a mesh
    the caller runs this inside ``runtime.sharding.use_mesh`` (and
    DTensor's ``implicit_replication`` where the layers mix in plain
    constants)."""
    rec = OpRecorder()
    with rec:
        out = step(*args)
    return StepAnalysis(
        roofline=Roofline(flops=float(rec.flops),
                          hbm_bytes=float(rec.hbm_bytes),
                          coll_bytes=collective_bytes(rec.records)),
        argument_size_in_bytes=local_bytes(args),
        temp_size_in_bytes=rec.peak_bytes,
        output_size_in_bytes=local_bytes(out),
        n_ops=rec.n_ops)
