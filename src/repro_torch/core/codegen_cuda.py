"""Emit CUDA C++ kernels for Hopper from any fusion snapshot: the port of
``repro.core.codegen_pallas``.

It keeps the reference's lowering and its reports.  ``regions.plan_program``
splits the selected snapshot into spine regions and ``regions.group_plan``
packs them into groups under the reference's default budget, so the
:class:`LoweringReport` (regions, grid dims, ``red_dim``, launches,
resident edges, group ids) is the reference's for the same program.  Then
each group of several regions becomes one kernel (:func:`emit_group`,
which replaces the ``pallas_call`` at codegen_pallas.py:712), and each
one-region group one kernel (:func:`emit_region`, which replaces the one at
codegen_pallas.py:616).

How a kernel lies on the card (:class:`LaunchPlan`, fixed at emit time).
The reference's grid is the group's shrunk parallel spine, which ran as a
sequential loop on the TPU; at the serving shapes it is one cell.  Two
steps spread a kernel over the H100's 132 SMs without changing the region
or group plan:

* *grid lifting*: a dim that a member has in its spine but the group's
  grid dropped goes back on the launch grid, unless a member reduces over
  it, loops over it inside the block, or consumes a list over it that
  another member produced (:func:`lift_refusals`).  A member that does not
  touch a lifted dim is recomputed in every block, and only the blocks at
  index 0 of that dim write its outputs;
* *cluster split*: the block body's last reduction, when it is an ADD or
  MAX reduce or a serial map of such accumulators followed only by a
  column-wise epilogue, is split over a thread-block cluster of
  ``cluster_size`` ranks along ``blockIdx.x`` (the divisor of its trip
  count that brings the blocks closest to the SMs, at most 16; for a
  tensor-core loop, below, :func:`fill_cluster`'s size).  Each rank
  reduces its share of the trips into its own shared memory; after
  ``cluster.sync()`` each rank adds one column window of all ranks'
  partials through distributed shared memory, in rank order, and runs the
  epilogue on that window.  Coupled carries (``+@k``, online softmax) are
  never split.

What a kernel does.  Each block runs one launch cell (times the cluster
ranks), times up to two leading *instance* axes on ``blockIdx.y/z``, which
stand in for the ``jax.vmap`` the model layers wrap around a compiled
kernel: every input and output has a stride per instance axis, and a
stride of 0 means "shared".  Inside the block the region graphs are
walked in order:

* a map over a launch dim is the block's own coordinate;
* every other map is an in-kernel loop that computes its operands'
  offsets into the merged arrays (list outputs are written per step,
  straight to their destination);
* a serial map's reduced ports are float32 accumulators in shared memory
  (in registers inside ``tiles::dot_k_sum``, below), advanced with the
  two-phase coupled update of
  ``ops.serial_accum_step``: all new maxima are computed before any
  accumulator is written, and ``+@k`` is
  ``acc * exp(z_old - z_new) + step * exp(m - z_new)``;
* functional operators call the tile templates of ``csrc/tiles.cuh``
  (elementwise expressions, row-wise scales, shifts, outer products and
  causal masks are translated to C with ``ast``); their results live in
  shared memory, and values that cross regions inside a group stay there;
* a serial map whose reduced ports are all ``+`` accumulators of tile
  products sharing one operand, contiguous along k, at 16 rows or more and
  inside no loop with coupled carries (the SwiGLU's gate/up and down
  projections from 16 rows on) is one ``tiles::dot_k_sum`` for the whole
  loop (:meth:`_Emitter.sum_operands`): the sums stay in registers as
  ``mma.sync`` fragments, a cp.async ring of 3-4 stages streams the
  operands' k-slices across the trips (the shared one once for all
  products), the products run in 3xTF32 on the tensor cores (each k8's
  three summed in a fresh fragment, then added in float32: the tensor
  cores round a sum toward zero), and the accumulators are written to
  shared memory once, after the loop;
* any other tile product whose operands are contiguous along the
  contraction axis (the strides are literals here) is ``tiles::dot_k``:
  operands in device memory are staged by 16-byte ``cp.async`` copies,
  double-buffered, and multiplied from shared memory on the CUDA cores
  (warp shuffles at R <= 8 rows, register micro-tiles above); any other
  product reads its operands in place (``tiles::dot``).

Each kernel's ``product_path`` (and its source header) says which:
``"tc3xtf32"`` when every tile product runs in ``tiles::dot_k_sum``,
``"fma"`` otherwise.  A kernel on the tensor-core path has
``__launch_bounds__(256, b)`` with b the blocks an SM holds at its shared
memory (2 at most: :func:`resident_blocks`), and where its split
candidate is the tensor-core loop the cluster is :func:`fill_cluster`'s:
the size of least modelled time over the card's 132 x b block slots
(:func:`sum_time`: whole waves of clusters, each block a rank's share of
whole trips plus a fixed cost), ranks taking the trips as evenly as they
split; every other kernel keeps :func:`cluster_size`'s plan.

What bounds it.  Float32 throughout (one TF32 pass would break the 2e-4
tolerance; 3xTF32 keeps it).  At decode sizes the SwiGLU kernels are bound
by the bytes of the weights they read once; from 16 rows on they stream
them through the ring of every resident block (qwen2-7b's gate/up at 32
rows: 1036 blocks, 2 an SM), below 16 rows through 72-148 blocks of
CUDA-core FMAs.  At prefill the 64-row blocks are bound by the tensor
cores' 3xTF32 rate (mma.sync, not wgmma), the attention kernels by their
CUDA-core FMA rate; launches under ~0.1 ms by the host's enqueue path
(:meth:`CudaKernel.launch` validates a signature once and then only
builds the pointer array).

On a CUDA tensor a kernel launches or raises; it takes its plain version
(``codegen_torch.region_runner``/``group_runner``) only for tensors on
the CPU.  Kernels are built on first use by ``core/cuda_build.py``.
"""

from __future__ import annotations

import ast
import ctypes
import hashlib
import math
import re
import time
import warnings
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tracing as T
from repro_torch.core import codegen_torch as CT
from repro_torch.core import cuda_build as CB
from repro_torch.core import ops as O
from repro_torch.core import regions as R
from repro_torch.core.runtime import (current_device, current_stream,
                                      placement)
from repro_torch.core.blocks import merged_shape
from repro_torch.core.graph import (FuncNode, Graph, InputNode, MapNode,
                                    OutputNode, Ref, ReduceNode, VType)
from repro_torch.core.regions import ProgramPlan, RegionError, RegionSpec
from repro_torch.pipeline import packing as P

THREADS = 256
SMEM_LIMIT = 232448   # bytes of shared memory one H100 block may opt into
MAX_INSTANCE_AXES = 2
SMS = 132             # streaming multiprocessors of an H100 SXM
MAX_CLUSTER = 16      # blocks per cluster with the non-portable opt-in
PORTABLE_CLUSTER = 8  # blocks per cluster without it
GPCS, GPC_SMS = 8, 16  # the H100 SXM's GPCs, and the SMs of each at least
CHUNK_BYTES = 32768   # one staged chunk of a dot_k's b operand, at most
STAGE_LIMIT = 98304   # a dot_k's staging or a dot_k_sum's ring, at most
SM_SMEM = 233472      # bytes of shared memory of one H100 SM (228 KB)
BLOCK_SMEM_RESERVED = 1024   # of them, the runtime's own per resident block
#: the least blocks an SM holds of a kernel on the tensor-core path, its
#: ``__launch_bounds__`` minimum: registers at most 65536 / (256 x 2) = 128
#: a thread
MIN_BLOCKS = 2
SUM_STAGES = 4        # a dot_k_sum ring's stages, at most (3 at least)
SUM_ACC_REGS = 64     # a dot_k_sum's accumulator registers a thread, at most
#: the product paths of an emitted kernel (``CudaKernel.product_path``)
TENSOR_PATH, FMA_PATH = "tc3xtf32", "fma"


# ---------------------------------------------------------------------------
# Reports (as in the reference)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RegionReport:
    label: str
    grid_dims: Tuple[str, ...]
    red_dim: Optional[str]
    n_outputs: int
    group: str = ""                 # id of the kernel serving this region


@dataclass(frozen=True)
class KernelRun:
    """One emitted kernel: the unit the executor launches."""

    gid: str
    label: str
    in_refs: Tuple[Ref, ...]
    out_refs: Tuple[Ref, ...]


@dataclass
class LoweringReport:
    """Provenance of one ``emit_program`` call: the regions emitted, the
    kernels launched (grouped regions share one), the cross-region
    values kept on chip, and each planned group the emitter could not
    express and split into per-region kernels (``degraded``: ``"<gid>:
    <reason>"``).  Its ``summary()`` is the reference's."""

    regions: List[RegionReport] = field(default_factory=list)
    launches: int = 0
    resident_edges: int = 0
    degraded: List[str] = field(default_factory=list)

    @property
    def n_regions(self) -> int:
        return len(self.regions)

    def summary(self) -> str:
        parts = []
        for r in self.regions:
            grid = ",".join(r.grid_dims)
            tail = f"+{r.red_dim}*" if r.red_dim else ""
            tag = f"@{r.group}" if r.group else ""
            parts.append(f"{r.label}[{grid}{tail}]{tag}")
        return (f"{self.n_regions} regions in {self.launches} kernels "
                f"({self.resident_edges} resident edges): "
                + "; ".join(parts))


def plan(g: Graph) -> ProgramPlan:
    """Partition ``g`` into its region DAG (no codegen)."""
    return R.plan_program(g)


# ---------------------------------------------------------------------------
# Views: where a value lives and how its items are addressed
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _View:
    """A value inside the kernel: a base pointer, an element offset (a C
    expression), its remaining list dims with their element strides
    (outermost first), and its item's shape and element strides."""

    ptr: str
    off: str
    lists: Tuple[Tuple[str, int], ...]
    shape: Tuple[int, ...]
    strides: Tuple[int, ...]
    align: int = 0   # every offset the view takes is a multiple (0: only 0)

    def index(self, dim: str, idx: str) -> "_View":
        if not self.lists or self.lists[0][0] != dim:
            raise RegionError(f"map[{dim}] indexes a value listed over "
                              f"{[d for d, _ in self.lists]}")
        stride = self.lists[0][1]
        off = self.off if stride == 0 else f"{self.off} + {idx} * {stride}"
        return replace(self, off=off, lists=self.lists[1:],
                       align=math.gcd(self.align, stride))

    @property
    def device(self) -> bool:
        """The value lies in device memory (a kernel input or output)."""
        return self.ptr != "smem"

    @property
    def addr(self) -> str:
        return self.ptr if self.off == "0" else f"({self.ptr} + {self.off})"

    def as2d(self) -> Tuple[int, int, int, int]:
        """(rows, cols, row stride, col stride): vectors are one row."""
        if len(self.shape) == 2:
            return (self.shape[0], self.shape[1],
                    self.strides[0], self.strides[1])
        if len(self.shape) == 1:
            return 1, self.shape[0], 0, self.strides[0]
        return 1, 1, 0, 0


def _as2d(shape: Sequence[int]) -> Tuple[int, int]:
    """(rows, cols) of an item as the tile templates see it."""
    if len(shape) == 2:
        return int(shape[0]), int(shape[1])
    return (1, int(shape[0])) if len(shape) == 1 else (1, 1)


def _kpad(k: int) -> int:
    """The row stride at which ``tiles::dot_k`` stages a k-long operand:
    k plus 4 or 8 floats, so rows stay 16-byte aligned and the stride's
    quarter is odd (float4 reads of 8 neighbouring rows hit 8 distinct
    bank groups)."""
    return k + 4 if (k // 4) % 2 == 0 else k + 8


def _sum_ring(rows: int, cols: int, k: int, nb: int
              ) -> Optional[Tuple[int, int]]:
    """``(bk, stages)`` of a ``tiles::dot_k_sum`` ring within
    ``STAGE_LIMIT`` for an a of ``rows`` x ``k`` and ``nb`` b of ``cols``
    x ``k``: the wider k-slice, 32 floats and then 16, that divides ``k``
    and leaves room for 3 stages or more (``SUM_STAGES`` at most); None
    when neither does."""
    rp = -(-rows // 16) * 16
    for bk in (32, 16):
        stages = min(SUM_STAGES,
                     STAGE_LIMIT // ((rp + nb * cols) * (bk + 4) * 4))
        if k % bk == 0 and stages >= 3:
            return bk, stages
    return None


def _row_major(shape: Sequence[int]) -> Tuple[int, ...]:
    strides, acc = [], 1
    for s in reversed(shape):
        strides.append(acc)
        acc *= int(s)
    return tuple(reversed(strides))


def _merged_view(ptr: str, vt: VType, item: Sequence[int],
                 dims: Dict[str, int]) -> _View:
    """A kernel input or output in the merged layout (``blocks``): lead
    list dims are stack axes, the next list dims split the item's axes."""
    lead = max(len(vt.dims) - len(item), 0)
    full = merged_shape(vt, item, dims)
    st = _row_major(full)
    lists = [(d, st[j]) for j, d in enumerate(vt.dims[:lead])]
    lists += [(d, item[j] * st[lead + j])
              for j, d in enumerate(vt.dims[lead:])]
    strides = tuple(st[lead + i] for i in range(len(item)))
    return _View(ptr, "0", tuple(lists), tuple(item), strides)


def _bcast2d(v: _View, rows: int, cols: int) -> Tuple[str, int, int]:
    """(address, row stride, col stride) of ``v`` broadcast along numpy's
    trailing rule against a (rows, cols) result."""
    r, c, rs, cs = v.as2d()
    if r == 1 and rows != 1:
        rs = 0
    if c == 1 and cols != 1:
        cs = 0
    return v.addr, rs, cs


def _rowwise(v: _View, like: _View) -> Tuple[str, int, int]:
    """``ops.bcast_to``: a row-wise factor against a higher-rank value
    (trailing singleton axes appended)."""
    if len(v.shape) == 1 and len(like.shape) == 2:
        return v.addr, v.strides[0], 0
    rows, cols, _, _ = like.as2d()
    return _bcast2d(v, rows, cols)


# ---------------------------------------------------------------------------
# Elementwise expressions -> C
# ---------------------------------------------------------------------------

_C_FUNCS = {"exp": "expf", "log": "logf", "sqrt": "sqrtf",
            "maximum": "fmaxf", "minimum": "fminf", "abs": "fabsf",
            "tanh": "tanhf", "sign": "tiles::sign"}
_C_BINOPS = {ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/"}
_C_CMPS = {ast.Gt: ">", ast.Lt: "<", ast.GtE: ">=", ast.LtE: "<=",
           ast.Eq: "==", ast.NotEq: "!="}


def _flit(v: float) -> str:
    v = float(v)
    if math.isnan(v):
        return "NAN"
    if math.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    lit = repr(v)
    if "e" not in lit and "." not in lit:
        lit += ".0"
    return f"({lit}f)" if v < 0 else f"{lit}f"


def expr_to_c(op: O.Elementwise) -> str:
    """The C expression of an ``Elementwise`` op over floats ``x0..xn``."""
    consts = dict(op.consts)

    def rec(n) -> str:
        if isinstance(n, ast.BinOp):
            a, b = rec(n.left), rec(n.right)
            if isinstance(n.op, ast.Pow):
                return f"powf({a}, {b})"
            sym = _C_BINOPS.get(type(n.op))
            if sym is None:
                raise RegionError(f"operator {type(n.op).__name__} in "
                                  f"{op.expr!r}")
            return f"({a} {sym} {b})"
        if isinstance(n, ast.UnaryOp):
            a = rec(n.operand)
            if isinstance(n.op, ast.USub):
                return f"(-{a})"
            if isinstance(n.op, ast.UAdd):
                return a
            if isinstance(n.op, ast.Not):
                return f"({a} == 0.0f ? 1.0f : 0.0f)"
        if isinstance(n, ast.Compare) and len(n.ops) == 1:
            sym = _C_CMPS.get(type(n.ops[0]))
            if sym is not None:
                return (f"({rec(n.left)} {sym} {rec(n.comparators[0])} "
                        "? 1.0f : 0.0f)")
        if isinstance(n, ast.IfExp):
            return (f"({rec(n.test)} != 0.0f ? {rec(n.body)} : "
                    f"{rec(n.orelse)})")
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name):
            args = [rec(a) for a in n.args]
            if n.func.id == "where" and len(args) == 3:
                return f"({args[0]} != 0.0f ? {args[1]} : {args[2]})"
            fn = _C_FUNCS.get(n.func.id)
            if fn is not None:
                return f"{fn}({', '.join(args)})"
        if isinstance(n, ast.Name):
            m = re.fullmatch(r"a(\d+)", n.id)
            if m and int(m.group(1)) < op.n_in:
                return f"x{m.group(1)}"
            if n.id in consts:
                return _flit(consts[n.id])
            if n.id == "pi":
                return _flit(math.pi)
        if isinstance(n, ast.Constant) and isinstance(n.value,
                                                      (int, float)):
            return _flit(n.value)
        raise RegionError(f"cannot translate {ast.dump(n)} in {op.expr!r}")

    return rec(ast.parse(op.expr, mode="eval").body)


# ---------------------------------------------------------------------------
# Item shapes (static): the shape rule of every operator
# ---------------------------------------------------------------------------

def _op_shape(op: O.Op, shapes: Sequence[Tuple[int, ...]]):
    if isinstance(op, (O.Dot, O.Outer)):
        return (shapes[0][0], shapes[1][0])
    if isinstance(op, (O.RowScale, O.RowShift, O.CausalMask)):
        return tuple(shapes[0])
    if isinstance(op, (O.RowSum, O.RowMax)):
        return (shapes[0][0],)
    if isinstance(op, O.Elementwise):
        return tuple(np.broadcast_shapes(*[tuple(s) for s in shapes]))
    raise RegionError(f"operator {op!r} has no CUDA tile template")


def _shapes(g: Graph, in_shapes: Sequence[Tuple[int, ...]]
            ) -> Dict[Ref, Tuple[int, ...]]:
    """Item shape of every value of ``g`` (one level)."""
    sh: Dict[Ref, Tuple[int, ...]] = {
        (iid, 0): tuple(s) for iid, s in zip(g.input_ids, in_shapes)}
    for nid in g.topo():
        node = g.nodes[nid]
        if isinstance(node, (InputNode, OutputNode)):
            continue
        ins = [sh[(e.src, e.sp)] for e in g.in_edges(nid)]
        if isinstance(node, FuncNode):
            sh[(nid, 0)] = _op_shape(node.op, ins)
        elif isinstance(node, ReduceNode):
            sh[(nid, 0)] = ins[0]
        elif isinstance(node, MapNode):
            inner = _shapes(node.inner, ins)
            for p, oid in enumerate(node.inner.output_ids):
                e = node.inner.in_edge(oid, 0)
                sh[(nid, p)] = inner[(e.src, e.sp)]
        else:
            raise RegionError(f"{node.label()} has no CUDA lowering")
    return sh


# ---------------------------------------------------------------------------
# The launch plan: how a kernel lies on the card
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LaunchPlan:
    """How one emitted kernel lies on the card.

    ``grid`` is the group's grid (the reference's, from
    ``regions.group_plan``) and ``lifted`` the dims put back on the launch
    grid beside it, so the kernel has ``cells`` launch cells over
    ``launch_dims``.  Each cell runs as one thread-block cluster of
    ``cluster_size`` blocks along ``blockIdx.x``, whose ranks split the
    trips of the reduction over ``cluster_dim``; ``split`` locates that
    node: the member's index and the node ids from the member's graph down
    through its grid maps.  ``blocks`` counts one instance."""

    grid: Tuple[str, ...]
    lifted: Tuple[str, ...] = ()
    cells: int = 1
    cluster_dim: Optional[str] = None
    cluster_size: int = 1
    split: Optional[Tuple[int, Tuple[int, ...]]] = None

    @property
    def launch_dims(self) -> Tuple[str, ...]:
        return self.grid + self.lifted

    @property
    def blocks(self) -> int:
        return self.cells * self.cluster_size


def _dim_uses(g: Graph, d: str, spine: Sequence[str],
              depth: Optional[int] = 0) -> List[str]:
    """Every use ``g`` makes of ``d`` other than a spine map over it;
    ``depth`` counts the spine maps around ``g`` (None: below a map off
    the spine)."""
    uses = []
    types = g.infer_types()
    for nid in g.topo():
        node = g.nodes[nid]
        if isinstance(node, ReduceNode):
            e = g.in_edge(nid, 0)
            if types[(e.src, e.sp)].dims[:1] == (d,):
                uses.append("reduces over")
        elif isinstance(node, MapNode):
            on_spine = (depth is not None and not node.serial
                        and depth < len(spine) and node.dim == spine[depth])
            if node.dim == d and node.serial:
                uses.append("loops serially over")
            elif node.dim == d and not on_spine:
                uses.append("loops inside the block over")
            uses += _dim_uses(node.inner, d, spine,
                              depth + 1 if on_spine else None)
    return uses


def lift_refusals(members: Sequence[RegionSpec], d: str,
                  types: Dict[Ref, VType]) -> List[str]:
    """Why ``d`` may not go on the launch grid of the kernel that runs
    ``members`` in sequence; empty when it may.

    Lifting gives each block one coordinate of ``d``.  That is wrong for a
    member that reduces over ``d`` (a reduce, or a serial map), that loops
    over it inside the block (a map over it off the member's spine), or
    that consumes a list over it another member produced (the producer's
    block holds only its own cell of that list)."""
    reasons, produced = [], {}
    for i, spec in enumerate(members):
        for r in spec.in_refs:
            if r in produced and d in types[r].dims:
                reasons.append(f"member {i} consumes the list over {d} "
                               f"that member {produced[r]} produced")
        reasons += [f"member {i} {use} {d}"
                    for use in _dim_uses(spec.graph, d, spec.grid_dims)]
        produced.update((r, i) for r in spec.out_refs)
    return reasons


def cluster_size(trips: int, cells: int) -> int:
    """The divisor of ``trips``, at most ``MAX_CLUSTER``, that brings
    ``cells`` x it blocks closest to the ``SMS``; the smaller on a tie."""
    best = 1
    for cs in range(2, min(trips, MAX_CLUSTER) + 1):
        if trips % cs == 0 and abs(cells * cs - SMS) < abs(cells * best
                                                             - SMS):
            best = cs
    return best


def resident_blocks(smem_bytes: int) -> int:
    """Blocks of a tensor-core-path kernel one SM holds: as many as its
    shared memory allows, at most the ``MIN_BLOCKS`` its
    ``__launch_bounds__`` budgets registers for."""
    return max(1, min(MIN_BLOCKS,
                      SM_SMEM // (smem_bytes + BLOCK_SMEM_RESERVED)))


def wave_clusters(cs: int, resident: int) -> int:
    """Clusters of ``cs`` blocks the card runs at once, ``resident``
    blocks an SM.  A cluster's blocks share one GPC: up to the portable 8
    ranks they pack the card's ``SMS`` x ``resident`` slots; past it a
    GPC (16 SMs at least, ``GPC_SMS``) holds whole clusters only, with
    gaps (on an H100 SXM, qwen2-7b's g2 at 32 rows took 0.172 ms in
    9-rank clusters against 0.129 in 8: PERF.md)."""
    if cs <= PORTABLE_CLUSTER:
        return SMS * resident // cs
    return GPCS * (GPC_SMS * resident // cs)


def sum_time(trips: int, cells: int, cs: int, resident: int) -> int:
    """The modelled time of a tensor-core reduction of ``trips`` in each
    of ``cells`` cells over clusters of ``cs`` ranks, in trips: its waves
    (:func:`wave_clusters`) times a rank's largest share (``trips / cs``
    rounded up) plus one for the block's fixed cost (the ring's fill, the
    cluster's exchange, the epilogue: about a trip's time at the serving
    shapes)."""
    waves = -(-cells // wave_clusters(cs, resident))
    return waves * (-(-trips // cs) + 1)


def fill_cluster(trips: int, cells: int, resident: int) -> int:
    """The cluster size of a reduction on the tensor-core path: of 1 to
    ``MAX_CLUSTER`` ranks (none more than ``trips``; a rank takes
    ``trips / cs`` of them, rounded either way), the one of least
    :func:`sum_time`; the smaller on a tie."""
    best = 1
    for cs in range(2, min(trips, MAX_CLUSTER) + 1):
        if (sum_time(trips, cells, cs, resident)
                < sum_time(trips, cells, best, resident)):
            best = cs
    return best


#: tile operators that act on each column of a tile on its own
_COLUMN_OPS = (O.Elementwise, O.RowScale, O.RowShift, O.Outer, O.CausalMask)


def _split_candidate(spec: RegionSpec, launch_dims: Sequence[str],
                     in_shapes: Sequence[Tuple[int, ...]]):
    """``(path, dim)`` of the reduction of ``spec`` (the kernel's
    last member) that a cluster may split, or None.

    It is the block body's last accumulating node, at its top level (inside
    maps over launch dims only): a reduce with ADD or MAX, or a serial map
    whose ports are all ADD or MAX accumulators (no list ports, no coupled
    ``+@k`` carries), with items of one (rows, cols) shape and no list
    axes.  Everything after it is column-wise tile operators of that shape
    (``_COLUMN_OPS``), and the outputs of the graphs around it come from it
    or from them, so each rank can finish one column window."""
    seq = []   # the body in emission order: (level graph, nid, shapes)

    def walk(g, shapes_in, path):
        shapes = _shapes(g, shapes_in)
        for nid in g.topo():
            node = g.nodes[nid]
            if isinstance(node, (InputNode, OutputNode)):
                continue
            if (isinstance(node, MapNode) and not node.serial
                    and node.dim in launch_dims):
                seq.append((g, nid, path, None))      # a grid map opens
                walk(node.inner, [shapes[(e.src, e.sp)]
                                  for e in g.in_edges(nid)], path + (nid,))
            else:
                seq.append((g, nid, path, shapes))

    walk(spec.graph, in_shapes, ())
    accs = [i for i, (g, nid, _, sh) in enumerate(seq)
            if sh is not None and not isinstance(g.nodes[nid], FuncNode)]
    if not accs:
        return None
    g, nid, path, shapes = seq[accs[-1]]
    node, types = g.nodes[nid], g.infer_types()
    if isinstance(node, ReduceNode):
        e = g.in_edge(nid, 0)
        tags, d = [node.op], types[(e.src, e.sp)].dims[0]
    elif isinstance(node, MapNode):
        tags, d = node.reduced, node.dim
    else:
        return None
    ports = range(len(tags))
    if (any(t not in (O.REDUCE_ADD, O.REDUCE_MAX) for t in tags)
            or any(types[(nid, p)].dims for p in ports)
            or len({_as2d(shapes[(nid, p)]) for p in ports}) != 1
            or d in launch_dims):
        return None
    tile = _as2d(shapes[(nid, 0)])
    epilogue = {id(g): {nid}}     # per level graph: the split and after
    for g2, nid2, _, sh2 in seq[accs[-1] + 1:]:
        if (sh2 is None or not isinstance(g2.nodes[nid2].op, _COLUMN_OPS)
                or _as2d(sh2[(nid2, 0)]) != tile):
            return None
        epilogue.setdefault(id(g2), set()).add(nid2)
    level = spec.graph
    for step in path + (None,):
        ok = epilogue.get(id(level), set()) | {step}
        if any(level.in_edge(o, 0).src not in ok for o in level.output_ids):
            return None
        if step is not None:
            level = level.nodes[step].inner
    return path + (nid,), d


def clustered(plan: LaunchPlan, cand, n_members: int,
              dims: Dict[str, int], resident: int = 0) -> LaunchPlan:
    """The launch plan of a kernel of ``n_members`` members from its plan
    without a cluster and its last member's split candidate ``cand``
    (:func:`plan_and_candidate`): the reduction is split over a cluster
    when the rule gives it more than one rank: :func:`cluster_size`, or,
    when that reduction runs on the tensor cores (``tiles::dot_k_sum``)
    in ``resident`` blocks an SM, :func:`fill_cluster`.  ``split`` is set
    only with a cluster."""
    if cand is None:
        return plan
    path, d = cand
    cs = (fill_cluster(dims[d], plan.cells, resident) if resident
          else cluster_size(dims[d], plan.cells))
    if cs == 1:
        return plan
    return replace(plan, cluster_dim=d, cluster_size=cs,
                   split=(n_members - 1, path))


def plan_and_candidate(members: Sequence[RegionSpec], grid: Sequence[str],
                       types: Dict[Ref, VType], in_refs: Sequence[Ref],
                       in_item_shapes: Sequence[Tuple[int, ...]],
                       dims: Dict[str, int]):
    """The plan, without a cluster, of the kernel that runs ``members``
    (in sequence) over the group grid ``grid`` (every dim
    :func:`lift_refusals` allows is lifted), and the last member's split
    candidate (:func:`_split_candidate`) or None."""
    grid = tuple(grid)
    lifted: List[str] = []
    for spec in members:
        for d in spec.grid_dims:
            if (d not in grid and d not in lifted
                    and not lift_refusals(members, d, types)):
                lifted.append(d)
    launch = grid + tuple(lifted)
    cells = int(np.prod([dims[d] for d in launch]))
    shapes = dict(zip(in_refs, in_item_shapes))
    for spec in members[:-1]:
        sh = _shapes(spec.graph, [shapes[r] for r in spec.in_refs])
        for oid, r in zip(spec.graph.output_ids, spec.out_refs):
            e = spec.graph.in_edge(oid, 0)
            shapes[r] = sh[(e.src, e.sp)]
    last = members[-1]
    cand = _split_candidate(last, launch,
                            [shapes[r] for r in last.in_refs])
    return LaunchPlan(grid, tuple(lifted), cells), cand


def _split_node(members: Sequence[RegionSpec], split):
    """The node ``split`` (a plan's: the member's index and the node ids
    down to it) locates, or None."""
    if split is None:
        return None
    mi, path = split
    g = members[mi].graph
    for nid in path[:-1]:
        g = g.nodes[nid].inner
    return g.nodes[path[-1]]


# ---------------------------------------------------------------------------
# The emitter
# ---------------------------------------------------------------------------

def _cname(dim: str) -> str:
    return re.sub(r"[^A-Za-z0-9_]", "_", dim)


class _Emitter:
    """Walks region graphs and writes the body of one ``__global__``
    kernel over the launch dims ``grid``.  Shared memory is a bump
    allocator that releases a loop body's buffers when the body ends.

    Device-memory writes carry ``guards``, the conditions under which this
    block writes: ``g_d == 0`` for each lifted dim the current member does
    not touch, and ``rank == 0`` before the cluster's split.  A guarded
    block computes such values in shared memory and copies them out under
    the guard, so that it never reads back memory it did not write.  After
    the split, ``window`` holds the (rows, cols) tile whose column window
    ``[wc0, wc1)`` this rank finishes.

    ``products`` collects the product paths the body takes (none inside
    a serial map with coupled carries, such as online softmax, takes the
    tensor cores);
    ``summed_candidate`` says whether ``candidate`` (the node a cluster
    may split) took ``tiles::dot_k_sum``."""

    def __init__(self, dims: Dict[str, int], grid: Sequence[str],
                 split_node=None, cluster: int = 1, candidate=None):
        self.dims = dims
        self.grid = tuple(grid)
        self.split_node = split_node
        self.cluster = cluster
        self.candidate = candidate
        self.summed_candidate = False
        self.coupled = 0   # serial maps with coupled carries around here
        self.products: set = set()
        self.member_guards: Tuple[str, ...] = ()
        self.rank_guard = split_node is not None
        self.window: Optional[Tuple[int, int]] = None
        self.aligned_inputs: set = set()   # inputs staged by cp.async
        self.lines: List[str] = []
        self.depth = 1
        self.smem = 0
        self.peak = 0
        self.count = 0
        self._types: Dict[int, Dict] = {}
        # float operations per block: dot products count 2 per
        # multiply-add, every other tile operation 1 per element
        self.flops = 0
        self._trips = [1]

    # -- plumbing -----------------------------------------------------------
    def emit(self, line: str) -> None:
        self.lines.append("  " * self.depth + line)

    def fresh(self, prefix: str) -> str:
        self.count += 1
        return f"{prefix}{self.count}"

    def types(self, g: Graph):
        if id(g) not in self._types:
            self._types[id(g)] = g.infer_types()
        return self._types[id(g)]

    @property
    def guards(self) -> Tuple[str, ...]:
        return self.member_guards + (("rank == 0",) if self.rank_guard
                                     else ())

    def store(self, out: _View, line: str) -> None:
        """Emit ``line``, which writes ``out``, under the write guards
        when ``out`` is in device memory (the guards are block-uniform, so
        the templates' barriers stay uniform too)."""
        if out.device and self.guards:
            line = f"if ({' && '.join(self.guards)}) {line}"
        self.emit(line)

    def dest(self, v: Optional[_View]) -> Optional[_View]:
        """``v`` if the walk may compute straight into it: not a
        device-memory destination while this block's writes are
        guarded."""
        if v is not None and v.device and self.guards:
            return None
        return v

    def alloc(self, list_dims: Sequence[str], shape: Sequence[int]
              ) -> _View:
        """A shared-memory value: list axes outermost (grid dims take no
        room: a block only ever holds its own cell), item row-major."""
        n = int(np.prod(shape)) if shape else 1
        lists = []
        for d in reversed(tuple(list_dims)):
            if d in self.grid:
                lists.append((d, 0))
            else:
                lists.append((d, n))
                n *= self.dims[d]
        off = self.smem
        self.smem += n
        self.peak = max(self.peak, self.smem)
        return _View("smem", str(off), tuple(reversed(lists)),
                     tuple(shape), _row_major(shape), align=off)

    def loop(self, dim: str, split: bool = False) -> str:
        """Open a loop over an off-grid dim (only this rank's share of it
        when ``split``: the trips [rank T / cs, (rank + 1) T / cs)), or
        bind the block's own coordinate of a grid dim; returns the index
        expression."""
        if dim in self.grid:
            return f"g_{_cname(dim)}"
        i = self.fresh("i")
        n, cs = self.dims[dim], self.cluster
        if split and n % cs == 0:
            n //= cs
            self.emit(f"for (int {i} = rank * {n}; {i} < (rank + 1) * {n}; "
                      f"++{i}) {{")
        elif split:       # ranks take the trips as dot_k_sum's do
            self.emit(f"for (int {i} = rank * {n} / {cs}; "
                      f"{i} < (rank + 1) * {n} / {cs}; ++{i}) {{")
            n /= cs
        else:
            self.emit(f"for (int {i} = 0; {i} < {n}; ++{i}) {{")
        self.depth += 1
        self._trips.append(self._trips[-1] * n)
        return i

    def close(self, dim: str) -> None:
        if dim not in self.grid:
            self.depth -= 1
            self._trips.pop()
            self.emit("}")

    def count_flops(self, n: int) -> None:
        self.flops += n * self._trips[-1]

    def combine(self, accs: Sequence[_View], maxes: Sequence[bool]) -> None:
        """The cluster's exchange after the split reduction: every rank's
        partial accumulators are complete (``cluster_sync``), this rank
        combines its column window of all of them in rank order, and no
        rank leaves before all have read (``cluster_sync``).  The rest of
        the body runs on the window."""
        rows, cols = _as2d(accs[0].shape)
        cs = self.cluster
        self.emit("tiles::cluster_sync();")
        self.emit(f"const int wc0 = rank * {cols} / {cs}, "
                  f"wc1 = (rank + 1) * {cols} / {cs};")
        for acc, is_max in zip(accs, maxes):
            _, _, rs, ccs = acc.as2d()
            self.count_flops(rows * cols * (cs - 1) // cs)
            self.emit(f"tiles::cluster_combine<{rows}, {cols}, {cs}, "
                      f"{'true' if is_max else 'false'}>({acc.addr}, {rs}, "
                      f"{ccs}, wc0, wc1);")
        self.emit("tiles::cluster_sync();")
        self.window = (rows, cols)
        self.rank_guard = False

    # -- item-level code ----------------------------------------------------
    def ew(self, out: _View, args: Sequence[Tuple[str, int, int]],
           expr: str) -> None:
        """out[r, c] = expr over x_i = args_i[r * rs + c * cs] (on the
        column window only, after a cluster split)."""
        rows, cols, ors, ocs = out.as2d()
        win = ""
        n = rows * cols
        if self.window is not None:
            if (rows, cols) != self.window:
                raise RegionError(f"a ({rows}, {cols}) tile after the "
                                  f"split of a {self.window} reduction")
            win = ", wc0, wc1"
            n //= self.cluster
        if args:
            self.count_flops(n)
        loads = " ".join(f"const float x{i} = {a}[r * {rs} + c * {cs}];"
                         for i, (a, rs, cs) in enumerate(args))
        self.store(out, f"tiles::ew<{rows}, {cols}>({out.addr}, {ors}, "
                   f"{ocs}, [&](int r, int c) {{ {loads} return {expr}; }}"
                   f"{win});")

    def over_items(self, views: Sequence[_View], fn) -> None:
        """Apply ``fn(items)`` to every item of equally-listed values."""
        if not views[0].lists:
            fn(list(views))
            return
        d = views[0].lists[0][0]
        i = self.loop(d)
        self.over_items([v.index(d, i) for v in views], fn)
        self.close(d)

    def copy(self, src: _View, dst: _View) -> None:
        def item(vs):
            s, t = vs
            rows, cols, _, _ = t.as2d()
            self.ew(t, [_bcast2d(s, rows, cols)], "x0")
        self.over_items([src, dst], item)

    def fill(self, dst: _View, value: float) -> None:
        self.over_items([dst], lambda vs: self.ew(vs[0], [], _flit(value)))

    def func(self, op: O.Op, ins: Sequence[_View], out: _View) -> None:
        rows, cols, ors, ocs = out.as2d()
        if isinstance(op, O.Elementwise):
            self.ew(out, [_bcast2d(v, rows, cols) for v in ins],
                    expr_to_c(op))
        elif isinstance(op, O.Outer):
            a, b = ins
            self.ew(out, [(a.addr, a.strides[0], 0), (b.addr, 0,
                                                      b.strides[0])],
                    "(x0 * x1)")
        elif isinstance(op, (O.RowScale, O.RowShift)):
            a, c = ins
            _, _, ars, acs = a.as2d()
            cs = c.strides[0] if c.shape else 0
            sym = "*" if isinstance(op, O.RowScale) else "+"
            self.ew(out, [(a.addr, ars, acs), (c.addr, cs, 0)],
                    f"(x0 {sym} x1)")
        elif isinstance(op, O.CausalMask):
            a, rv, cv = ins
            _, _, ars, acs = a.as2d()
            self.ew(out, [(a.addr, ars, acs), (rv.addr, rv.strides[0], 0),
                          (cv.addr, 0, cv.strides[0])],
                    "(x1 >= x2 ? x0 : tiles::NEG_MASK)")
        elif isinstance(op, O.Dot):
            a, b = ins
            _, k, _, _ = a.as2d()
            self.count_flops(rows * cols * 2 * k)
            self.dot(out, a, b, k)
        elif isinstance(op, (O.RowSum, O.RowMax)):
            a = ins[0]
            ar, ac, ars, acs = a.as2d()
            self.count_flops(rows * cols)
            name = "row_sum" if isinstance(op, O.RowSum) else "row_max"
            self.store(out, f"tiles::{name}<{ar}, {ac}>({out.addr}, "
                       f"{out.strides[0]}, {a.addr}, {ars}, {acs});")
        else:
            raise RegionError(f"operator {op!r} has no CUDA tile template")

    def dot(self, out: _View, a: _View, b: _View, k: int) -> None:
        """``out = a @ b.T``: ``tiles::dot_k`` when both operands are
        contiguous along k (those in device memory 16-byte aligned) and
        its staging fits ``STAGE_LIMIT``, else ``tiles::dot``."""
        rows, cols, ors, ocs = out.as2d()
        _, _, ars, acs = a.as2d()
        _, _, brs, bcs = b.as2d()
        o = f"{out.addr}, {ors}, {ocs}"
        self.products.add(FMA_PATH)
        sp = _kpad(k)
        cc = min(cols, max(8, CHUNK_BYTES // (4 * sp) // 8 * 8))
        floats = (rows + (2 if cols > cc else 1) * cc) * sp
        staged = [v for v in (a, b) if v.ptr.startswith("in")]
        if (k % 4 == 0 and acs == 1 and bcs == 1
                and floats * 4 <= STAGE_LIMIT
                and all(v.align % 4 == 0 and rs % 4 == 0 for v, rs in
                        ((a, ars), (b, brs)) if v in staged)):
            at = -(-self.smem // 4) * 4      # 16-byte aligned, released
            self.peak = max(self.peak, at + floats)
            self.aligned_inputs.update(int(v.ptr[2:]) for v in staged)
            flags = ", ".join("true" if v in staged else "false"
                              for v in (a, b))
            self.store(out, f"tiles::dot_k<{rows}, {cols}, {k}, {cc}, {sp}, "
                       f"{flags}>({o}, {a.addr}, {ars}, {b.addr}, {brs}, "
                       f"smem + {at});")
        else:
            self.store(out, f"tiles::dot<{rows}, {cols}, {k}>({o}, "
                       f"{a.addr}, {ars}, {acs}, {b.addr}, {brs}, {bcs});")

    def sum_operands(self, node: MapNode, ins: Sequence[_View], shapes,
                     vtypes):
        """The operands of ``tiles::dot_k_sum`` for the serial map
        ``node`` over ``ins``, or None, where the map keeps its loop of
        ``tiles::dot_k`` products and ``tiles::ew`` adds.

        The map lies in no serial map with coupled carries (``+@k``,
        max); every reduced port is a ``+`` accumulator of one product
        (``O.Dot``) of two of the map's inputs, the products share their
        first operand ``a`` and the body holds nothing else; every operand
        is contiguous along k and, in device memory, 16-byte aligned at
        every trip (as ``dot_k`` stages it); ``a`` has 16 rows or more;
        the accumulators are plain (rows, cols) tiles within
        ``SUM_ACC_REGS`` registers a thread, and the ring fits
        (:func:`_sum_ring`).  Returns ``(a, a_step, [(b, b_step), ...],
        (bk, stages))``: each operand's view at trip 0 and its element
        stride per trip (0: the same every trip)."""
        inner = node.inner
        if (self.coupled or any(r != O.REDUCE_ADD for r in node.reduced)
                or any(vt.dims for vt in vtypes)):
            return None
        pos = {iid: j for j, iid in enumerate(inner.input_ids)}
        dots = [inner.in_edge(oid, 0).src for oid in inner.output_ids]
        if len(set(dots)) != len(dots) or any(
                not isinstance(n, (InputNode, OutputNode)) and i not in dots
                for i, n in inner.nodes.items()):
            return None
        pairs = []
        for i in dots:
            n = inner.nodes[i]
            src = [e.src for e in inner.in_edges(i)]
            if not (isinstance(n, FuncNode) and isinstance(n.op, O.Dot)
                    and all(s in pos for s in src)):
                return None
            pairs.append([pos[s] for s in src])
        if len({p[0] for p in pairs}) != 1:
            return None
        views = {}
        for j in {x for p in pairs for x in p}:
            v, step = ins[j], 0
            if node.mapped[j]:
                if not v.lists or v.lists[0][0] != node.dim:
                    return None
                step = v.lists[0][1]
                v = replace(v, lists=v.lists[1:],
                            align=math.gcd(v.align, step))
            if v.lists or len(v.shape) != 2 or v.strides[1] != 1:
                return None
            if v.ptr.startswith("in"):
                if v.align % 4 or v.strides[0] % 4 or step % 4:
                    return None
            elif v.device:          # an output, never read back
                return None
            views[j] = (v, step)
        a, a_step = views[pairs[0][0]]
        bs = [views[p[1]] for p in pairs]
        rows, k = a.shape
        cols = bs[0][0].shape[0]
        staged = {b.ptr.startswith("in") for b, _ in bs}
        if (rows < 16 or cols % 8 or len(staged) != 1
                or any(b.shape != (cols, k) for b, _ in bs)
                or any(_as2d(s) != (rows, cols) for s in shapes)):
            return None
        warp_tiles = -(-(cols // 8) // (THREADS // 32))
        if -(-rows // 16) * warp_tiles * len(bs) * 4 > SUM_ACC_REGS:
            return None
        ring = _sum_ring(rows, cols, k, len(bs))
        return None if ring is None else (a, a_step, bs, ring)

    def dot_k_sum(self, node: MapNode, summed, accs: Sequence[_View],
                  base: int, split: bool) -> None:
        """The whole loop of the serial map ``node`` as one
        ``tiles::dot_k_sum`` (operands from :meth:`sum_operands`) into
        ``accs``, its ring from ``base`` (the accumulators' first float)
        on; a split rank takes the trips [rank T / cs, (rank + 1) T / cs)."""
        a, a_step, bs, (bk, stages) = summed
        rows, k = a.shape
        cols, nb = bs[0][0].shape[0], len(bs)
        trips = self.dims[node.dim]
        share = trips / self.cluster if split else trips
        t0, nt = "0", str(trips)
        if split:
            t0 = f"rank * {trips} / {self.cluster}"
            nt = f"(rank + 1) * {trips} / {self.cluster} - {t0}"
        # float operations as the loop of dot_k products and adds counts
        self.count_flops(int(share * nb * (2 * rows * cols * k
                                           + rows * cols)))
        at = -(-base // 4) * 4               # 16-byte aligned
        rp = -(-rows // 16) * 16
        self.peak = max(self.peak, at + stages * (rp + nb * cols) * (bk + 4))
        ops = [a] + [b for b, _ in bs]
        self.aligned_inputs.update(int(v.ptr[2:]) for v in ops
                                   if v.ptr.startswith("in"))
        self.products.add(TENSOR_PATH)

        def flag(v):
            return "true" if v.ptr.startswith("in") else "false"

        def braced(items):
            return "{" + ", ".join(str(x) for x in items) + "}"

        self.emit(
            f"tiles::dot_k_sum<{rows}, {cols}, {k}, {nb}, {bk}, {stages}, "
            f"{flag(a)}, {flag(bs[0][0])}>({braced(v.addr for v in accs)}, "
            f"{cols}, {a.addr}, {a.strides[0]}, {a_step}, "
            f"{braced(b.addr for b, _ in bs)}, "
            f"{braced(b.strides[0] for b, _ in bs)}, "
            f"{braced(s for _, s in bs)}, {t0}, {nt}, smem + {at});")

    # -- graph-level code ---------------------------------------------------
    def graph(self, g: Graph, ins: Sequence[_View],
              dests: Sequence[Optional[_View]]) -> List[_View]:
        """Emit ``g`` on input views; output ``k`` lands in ``dests[k]``
        when one is given.  Returns the output views."""
        types = self.types(g)
        shapes = _shapes(g, [v.shape for v in ins])
        env: Dict[Ref, _View] = {(iid, 0): v
                                 for iid, v in zip(g.input_ids, ins)}
        want: Dict[Ref, _View] = {}
        src_of = []
        for oid, dst in zip(g.output_ids, dests):
            e = g.in_edge(oid, 0)
            ref = (e.src, e.sp)
            src_of.append(ref)
            if dst is not None and ref not in want and ref not in env:
                want[ref] = dst
        for nid in g.topo():
            node = g.nodes[nid]
            if isinstance(node, (InputNode, OutputNode)):
                continue
            ins_v = [env[(e.src, e.sp)] for e in g.in_edges(nid)]
            if isinstance(node, FuncNode):
                out = (self.dest(want.get((nid, 0)))
                       or self.alloc((), shapes[(nid, 0)]))
                self.func(node.op, ins_v, out)
                env[(nid, 0)] = out
            elif isinstance(node, ReduceNode):
                env[(nid, 0)] = self.reduce(node, ins_v[0],
                                            want.get((nid, 0)))
            elif isinstance(node, MapNode):
                ports = range(node.n_out())
                outs = self.map(g, nid, node, ins_v,
                                {p: want.get((nid, p)) for p in ports},
                                [shapes[(nid, p)] for p in ports],
                                [types[(nid, p)] for p in ports])
                for p, v in enumerate(outs):
                    env[(nid, p)] = v
            else:
                raise RegionError(f"{node.label()} has no CUDA lowering")
        result = []
        for ref, dst in zip(src_of, dests):
            v = env[ref]
            if dst is not None and v is not dst:
                self.copy(v, dst)
                v = dst
            result.append(v)
        return result

    def reduce(self, node: ReduceNode, x: _View,
               dest: Optional[_View]) -> _View:
        if node.op not in (O.REDUCE_ADD, O.REDUCE_MAX):
            raise RegionError(f"unsupported reduce {node.op!r}")
        d = x.lists[0][0]
        if d in self.grid:
            raise RegionError(f"reduce over grid dim {d}")
        split = node is self.split_node
        acc = ((None if split else self.dest(dest))
               or self.alloc([l for l, _ in x.lists[1:]], x.shape))
        is_max = node.op == O.REDUCE_MAX
        self.fill(acc, -math.inf if is_max else 0.0)
        i = self.loop(d, split)
        expr = "fmaxf(x0, x1)" if is_max else "(x0 + x1)"

        def item(vs):
            a, v = vs
            rows, cols, _, _ = a.as2d()
            self.ew(a, [_bcast2d(a, rows, cols), _bcast2d(v, rows, cols)],
                    expr)
        self.over_items([acc, x.index(d, i)], item)
        self.close(d)
        if split:
            self.combine([acc], [is_max])
        return acc

    def map(self, g: Graph, nid: int, node: MapNode, ins: Sequence[_View],
            dests: Dict[int, Optional[_View]], shapes, vtypes) -> List[_View]:
        d = node.dim
        if node.serial and d in self.grid:
            raise RegionError(f"serial map[{d}] over a grid-selected dim")
        split = node is self.split_node
        if d not in self.grid:   # a grid map's body picks its own
            dests = {p: self.dest(v) for p, v in dests.items()}
        summed = (self.sum_operands(node, ins, shapes, vtypes)
                  if node.serial else None)
        base = self.smem
        outs: Dict[int, Optional[_View]] = {}
        for p, r in enumerate(node.reduced):
            if r is None:
                if dests[p] is not None:
                    outs[p] = dests[p]
                elif g.out_edges(nid, p):
                    outs[p] = self.alloc(vtypes[p].dims, shapes[p])
                else:
                    outs[p] = None  # dead port: computed, never stored
            else:
                outs[p] = self.alloc(vtypes[p].dims, shapes[p])
                if summed is None:
                    self.fill(outs[p],
                              -math.inf if r == O.REDUCE_MAX else 0.0)
        if summed is not None:
            self.dot_k_sum(node, summed, [outs[p] for p in outs], base,
                           split)
            self.summed_candidate |= node is self.candidate
        else:
            idx = self.loop(d, split)
            mark = self.smem
            body_in = [v.index(d, idx) if m else v
                       for v, m in zip(ins, node.mapped)]
            body_dst = [outs[p].index(d, idx)
                        if r is None and outs[p] is not None else None
                        for p, r in enumerate(node.reduced)]
            coupled = node.serial and any(
                r not in (None, O.REDUCE_ADD) for r in node.reduced)
            self.coupled += coupled
            res = self.graph(node.inner, body_in, body_dst)
            self.coupled -= coupled
            if node.serial:
                self.accumulate(node, outs, res)
            self.smem = mark
            self.close(d)
        if split:
            self.combine([outs[p] for p in range(len(node.reduced))],
                         [r == O.REDUCE_MAX for r in node.reduced])
        result = []
        for p, r in enumerate(node.reduced):
            v = outs[p]
            if r is not None and dests[p] is not None:
                self.copy(v, dests[p])
                v = dests[p]
            result.append(v)
        return result

    def accumulate(self, node: MapNode, accs: Dict[int, _View],
                   vals: Sequence[_View]) -> None:
        """The two-phase coupled carry update (ops.serial_accum_step):
        every new running max is computed before any carry is written."""
        tags = node.reduced
        for p, r in enumerate(tags):
            if r is not None and r != O.REDUCE_ADD and accs[p].lists:
                raise RegionError("list-valued coupled accumulator")
        z_new: Dict[int, _View] = {}
        for p, r in enumerate(tags):
            if r == O.REDUCE_MAX:
                z_new[p] = self.alloc((), accs[p].shape)
                rows, cols, _, _ = accs[p].as2d()
                self.ew(z_new[p], [_bcast2d(accs[p], rows, cols),
                                   _bcast2d(vals[p], rows, cols)],
                        "fmaxf(x0, x1)")
        for p, r in enumerate(tags):
            if r is None or r == O.REDUCE_MAX:
                continue
            acc = accs[p]
            if r == O.REDUCE_ADD:
                def item(vs):
                    a, v = vs
                    rows, cols, _, _ = a.as2d()
                    self.ew(a, [_bcast2d(a, rows, cols),
                                _bcast2d(v, rows, cols)], "(x0 + x1)")
                self.over_items([acc, vals[p]], item)
                continue
            k = O.rescaled_ref(r)
            if k is None or k not in z_new:
                raise RegionError(f"unsupported reduced tag {r!r}")
            rows, cols, _, _ = acc.as2d()
            self.ew(acc, [_bcast2d(acc, rows, cols),
                          _bcast2d(vals[p], rows, cols),
                          _rowwise(accs[k], acc), _rowwise(z_new[k], acc),
                          _rowwise(vals[k], acc)],
                    "(x0 * expf(x2 - x3) + x1 * expf(x4 - x3))")
        for p, zn in z_new.items():
            self.copy(zn, accs[p])


# ---------------------------------------------------------------------------
# Kernel source and the launch wrapper
# ---------------------------------------------------------------------------

def _kernel_source(em: _Emitter, plan: LaunchPlan, kname: str, gid: str,
                   label: str, entry: str, n_in: int, n_out: int) -> str:
    smem = em.peak * 4
    cs = plan.cluster_size
    # a kernel with a tensor-core K loop budgets registers for the blocks
    # its shared memory lets an SM hold (the plan counts on them)
    tensor = TENSOR_PATH in em.products
    bounds = ((THREADS, resident_blocks(smem)) if tensor else (THREADS,))
    lifted = f", {list(plan.lifted)} lifted" if plan.lifted else ""
    cluster = (f"a cluster of {cs} blocks splits the {plan.cluster_dim} "
               f"reduction of each cell" if cs > 1 else "one block a cell")
    head = [
        f"// {entry} kernel {gid}: {label}",
        "// Emitted by repro_torch/core/codegen_cuda.py; replaces the "
        f"pallas_call of repro.core.codegen_pallas.{entry}.",
        f"// reference grid {list(plan.grid)}; launch grid "
        f"{list(plan.launch_dims)}{lifted} = {plan.cells} cells; {cluster}: "
        f"{plan.blocks} blocks x instances.",
        f"// {smem} bytes of shared memory and {em.flops} float operations "
        "per block; operands contiguous along k are staged by cp.async "
        "(tiles::dot_k), the rest read where they lie.",
        f"// product path: {_product_path(em)} ("
        + ("every tile product in tiles::dot_k_sum, 3xTF32 on the tensor "
           f"cores; {bounds[1]} blocks an SM" if tensor else
           "tile products, if any, as float32 FMAs on the CUDA cores")
        + ").",
        '#include "tiles.cuh"',
        "",
        f"struct KArgs {{ const float* in[{max(n_in, 1)}]; "
        f"float* out[{max(n_out, 1)}]; long long is[{max(n_in, 1)}][2]; "
        f"long long os[{max(n_out, 1)}][2]; }};",
        "",
        f"__global__ void __launch_bounds__({', '.join(map(str, bounds))}) "
        f"{kname}(const KArgs A) {{",
        "  extern __shared__ __align__(16) float smem[];",
        "  const long long u0 = blockIdx.y, u1 = blockIdx.z;",
    ]
    for j in range(n_in):
        head.append(f"  const float* in{j} = A.in[{j}] + u0 * A.is[{j}][0]"
                    f" + u1 * A.is[{j}][1];")
    for j in range(n_out):
        head.append(f"  float* out{j} = A.out[{j}] + u0 * A.os[{j}][0]"
                    f" + u1 * A.os[{j}][1];")
    if cs > 1:
        head += ["  const int rank = tiles::cluster_rank();",
                 f"  int cell = blockIdx.x / {cs};"]
    else:
        head.append("  int cell = blockIdx.x;")
    for d in reversed(plan.launch_dims):
        n = em.dims[d]
        head.append(f"  const int g_{_cname(d)} = cell % {n}; cell /= {n};")
    tail = [
        "}",
        "",
        'extern "C" int launch(void** ptrs, const long long* strides, '
        "int inst0, int inst1, void* stream) {",
        "  KArgs a;",
        "  cudaError_t e = cudaSuccess;",
    ]
    for j in range(n_in):
        tail.append(f"  a.in[{j}] = (const float*)ptrs[{j}]; "
                    f"a.is[{j}][0] = strides[{2 * j}]; "
                    f"a.is[{j}][1] = strides[{2 * j + 1}];")
    for j in range(n_out):
        k = n_in + j
        tail.append(f"  a.out[{j}] = (float*)ptrs[{k}]; "
                    f"a.os[{j}][0] = strides[{2 * k}]; "
                    f"a.os[{j}][1] = strides[{2 * k + 1}];")
    attrs = []
    if smem > 48 * 1024:  # dynamic shared memory past 48 KB is opt-in
        attrs.append(f"cudaFuncAttributeMaxDynamicSharedMemorySize, {smem}")
    if cs > PORTABLE_CLUSTER:
        attrs.append("cudaFuncAttributeNonPortableClusterSizeAllowed, 1")
    if attrs:  # once per device: the attributes stay with the function
        tail += [
            "  static unsigned long long ready = 0;",
            "  int dev = 0;",
            "  e = cudaGetDevice(&dev);",
            "  if (e != cudaSuccess) return (int)e;",
            "  if (!((ready >> dev) & 1ull)) {",
        ]
        for attr in attrs:
            tail += [f"    e = cudaFuncSetAttribute({kname}, {attr});",
                     "    if (e != cudaSuccess) return (int)e;"]
        tail += ["    ready |= 1ull << dev;", "  }"]
    if cs == 1:
        tail.append(f"  {kname}<<<dim3({plan.blocks}, inst0, inst1), "
                    f"{THREADS}, {smem}, (cudaStream_t)stream>>>(a);")
    else:
        tail += [
            "  cudaLaunchConfig_t cfg = {};",
            f"  cfg.gridDim = dim3({plan.blocks}, inst0, inst1);",
            f"  cfg.blockDim = dim3({THREADS}, 1, 1);",
            f"  cfg.dynamicSmemBytes = {smem};",
            "  cfg.stream = (cudaStream_t)stream;",
            "  cudaLaunchAttribute attr[1];",
            "  attr[0].id = cudaLaunchAttributeClusterDimension;",
            f"  attr[0].val.clusterDim.x = {cs};",
            "  attr[0].val.clusterDim.y = 1;",
            "  attr[0].val.clusterDim.z = 1;",
            "  cfg.attrs = attr;",
            "  cfg.numAttrs = 1;",
            f"  e = cudaLaunchKernelEx(&cfg, {kname}, a);",
            "  if (e != cudaSuccess) return (int)e;",
        ]
    tail += [
        "  return (int)cudaGetLastError();",
        "}",
        "",
    ]
    return "\n".join(head + em.lines + tail)


def _product_path(em: _Emitter) -> str:
    """``TENSOR_PATH`` when every tile product of the body runs in
    ``tiles::dot_k_sum``, else ``FMA_PATH`` (a body with no product, too)."""
    return TENSOR_PATH if em.products == {TENSOR_PATH} else FMA_PATH


def _trailing_contiguous(t: torch.Tensor, lead: int) -> bool:
    expect = 1
    for size, stride in zip(reversed(t.shape[lead:]),
                            reversed(t.stride()[lead:])):
        if size != 1 and stride != expect:
            return False
        expect *= size
    return True


class CudaKernel:
    """One emitted kernel: its CUDA source, its plain version, its
    :class:`LaunchPlan` and a launch counter.  ``kern(*merged,
    instances=k)`` takes merged arrays (each with ``k`` leading instance
    axes; size 1 is shared) and returns the merged outputs.

    ``blocks`` is the launch's blocks per instance (cells x cluster
    ranks), ``flops`` the float operations the launch executes per
    instance (recomputed members and the cluster's exchange included),
    ``aligned`` the inputs that ``tiles::dot_k`` or ``tiles::dot_k_sum``
    stages by 16-byte copies, ``product_path`` where its tile products run
    (``TENSOR_PATH``: all in ``tiles::dot_k_sum``, else ``FMA_PATH``)."""

    def __init__(self, gid: str, label: str, entry: str, kname: str,
                 source: str, runner: Callable, in_full, out_full,
                 smem_bytes: int, plan: LaunchPlan, flops: int = 0,
                 aligned: Sequence[int] = (), product_path: str = FMA_PATH):
        self.gid, self.label, self.entry = gid, label, entry
        self.kname = kname       # the name the profiler shows
        self.source = source
        self.runner = runner
        self.in_full = [tuple(s) for s in in_full]
        self.out_full = [tuple(s) for s in out_full]
        self.smem_bytes = smem_bytes
        self.plan = plan
        self.blocks = plan.blocks
        self.flops = flops
        self.aligned = tuple(aligned)
        self.product_path = product_path
        self.launcher = CB.Launcher(source, "launch",
                                    what=f"kernel {gid} ({label})")
        self._ptrs = ctypes.c_void_p * (len(in_full) + len(out_full))
        self._signatures: Dict[tuple, tuple] = {}

    def __repr__(self):
        return (f"<CudaKernel {self.gid} {self.label} blocks={self.blocks} "
                f"cluster={self.plan.cluster_size} smem={self.smem_bytes} "
                f"{self.product_path}>")

    @property
    def key(self) -> str:
        return self.launcher.key

    @property
    def launches(self) -> int:
        return self.launcher.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.launcher.launches = n

    @property
    def built(self) -> bool:
        return CB.library_path(self.key).exists()

    def build(self) -> None:
        self.launcher.build()

    def plain(self, *merged, instances: int = 0):
        """The plain PyTorch version of this kernel."""
        return self.runner(*merged, instances=instances)

    def __call__(self, *merged, instances: int = 0):
        if merged and merged[0].is_cuda:    # the others: checked by launch
            return self.launch(*merged, instances=instances)
        if placement(self.gid, *merged) == "cpu":
            return self.plain(*merged, instances=instances)
        return self.launch(*merged, instances=instances)

    def _signature(self, merged, instances: int) -> tuple:
        """Validate a call's inputs in full: ``(device, output shapes,
        the ctypes stride array, the two instance extents)``, cached per
        signature by :meth:`launch`."""
        if instances > MAX_INSTANCE_AXES:
            raise ValueError(f"{self.gid}: at most {MAX_INSTANCE_AXES} "
                             "instance axes")
        if len(merged) != len(self.in_full):
            raise ValueError(f"{self.gid}: {len(merged)} inputs, expected "
                             f"{len(self.in_full)}")
        dev = merged[0].device
        for j, (a, full) in enumerate(zip(merged, self.in_full)):
            if a.device != dev or a.dtype != torch.float32:
                raise ValueError(f"{self.gid}: input {j} is {a.dtype} on "
                                 f"{a.device}; expected float32 on {dev}")
            if tuple(a.shape[instances:]) != full or a.dim() != (
                    instances + len(full)):
                raise ValueError(f"{self.gid}: input {j} has shape "
                                 f"{tuple(a.shape)}, expected "
                                 f"(instances..., {full})")
            if not _trailing_contiguous(a, instances):
                raise ValueError(f"{self.gid}: input {j} is not contiguous "
                                 "in its merged axes")
            if j in self.aligned and any(
                    a.stride(k) % 4 for k in range(instances)
                    if a.shape[k] != 1):
                raise ValueError(f"{self.gid}: input {j} is staged by "
                                 "16-byte copies; its instance strides "
                                 "must be multiples of 4 elements")
        inst = tuple(torch.broadcast_shapes(
            *[tuple(a.shape[:instances]) for a in merged]))
        out_shapes = [inst + s for s in self.out_full]
        strides: List[int] = []
        for t_shape, t_strides in (
                [(tuple(a.shape), a.stride()) for a in merged]
                + [(s, _row_major(s)) for s in out_shapes]):
            st = [t_strides[k] if t_shape[k] != 1 else 0
                  for k in range(instances)]
            strides += st + [0] * (MAX_INSTANCE_AXES - instances)
        ext = list(inst) + [1] * (MAX_INSTANCE_AXES - instances)
        arr = (ctypes.c_longlong * len(strides))(*strides)
        return dev, out_shapes, arr, ext[0], ext[1]

    def launch(self, *merged, instances: int = 0):
        """Launch on CUDA tensors.  A call's signature (shapes, strides,
        types, devices) is validated in full the first time it is seen;
        later calls with it only allocate the outputs and build the
        pointer array.  While a profiler records, the launch path is a
        ``launch`` model span (``repro_torch.tracing``)."""
        with T.model_span("launch"):
            sig = (instances, *[(a.dtype, a.get_device(), a.shape,
                                 a.stride()) for a in merged])
            known = self._signatures.get(sig)
            if known is None:
                known = self._signatures[sig] = self._signature(merged,
                                                                instances)
            dev, out_shapes, strides, ext0, ext1 = known
            outs = [torch.empty(s, dtype=torch.float32, device=dev)
                    for s in out_shapes]
            ptrs = ([t.data_ptr() for t in merged]
                    + [o.data_ptr() for o in outs])
            for j in self.aligned:
                if ptrs[j] % 16:
                    raise ValueError(f"{self.gid}: input {j} is staged by "
                                     "16-byte copies and must be 16-byte "
                                     "aligned")
            if dev.index == current_device():
                self.launcher.launch(self._ptrs(*ptrs), strides, ext0,
                                     ext1, current_stream(dev.index))
            else:
                with torch.cuda.device(dev):
                    self.launcher.launch(self._ptrs(*ptrs), strides, ext0,
                                         ext1, current_stream(dev.index))
            return tuple(outs)


def build(kernels: Sequence[CudaKernel]) -> float:
    """Build and load every given kernel that is not loaded yet: one nvcc
    per source, all started together.  Returns the seconds it took."""
    todo = [k for k in kernels if not k.launcher.loaded]
    t0 = time.perf_counter()
    CB.build_many(list({k.key: k.source for k in todo}.items()))
    for k in todo:
        k.build()
    return time.perf_counter() - t0


def _emit_members(members: Sequence[RegionSpec], plan: LaunchPlan,
                  in_refs, out_refs, ref_types: Dict[Ref, VType],
                  in_item_shapes, out_item_shapes, dims: Dict[str, int],
                  gid: str, candidate=None) -> _Emitter:
    """The body of the kernel that runs ``members`` under ``plan``."""
    em = _Emitter(dims, plan.launch_dims, _split_node(members, plan.split),
                  plan.cluster_size, candidate)
    env: Dict[Ref, _View] = {}
    for j, (r, ish) in enumerate(zip(in_refs, in_item_shapes)):
        env[r] = _merged_view(f"in{j}", ref_types[r], ish, dims)
    spilled = {r: _merged_view(f"out{j}", ref_types[r], ish, dims)
               for j, (r, ish) in enumerate(zip(out_refs, out_item_shapes))}
    for i, spec in enumerate(members):
        em.member_guards = tuple(f"g_{_cname(d)} == 0" for d in plan.lifted
                                 if d not in spec.grid_dims)
        later = {r for m in members[i + 1:] for r in m.in_refs}
        ins = [env[r] for r in spec.in_refs]
        shapes = _shapes(spec.graph, [v.shape for v in ins])
        dests = []
        for oid, r in zip(spec.graph.output_ids, spec.out_refs):
            if r in spilled and not (em.guards and r in later):
                dests.append(spilled[r])
                continue
            # resident, or spilled by a guarded member and read again
            # here: this block keeps its own copy in shared memory
            e = spec.graph.in_edge(oid, 0)
            dests.append(em.alloc(ref_types[r].dims, shapes[(e.src, e.sp)]))
        for r, v in zip(spec.out_refs, em.graph(spec.graph, ins, dests)):
            if r in spilled and v.shape != spilled[r].shape:
                raise RegionError(f"{gid}: emitted item shape {v.shape} of "
                                  f"{r} disagrees with {spilled[r].shape}")
            if r in spilled and v is not spilled[r]:
                em.copy(v, spilled[r])
            env[r] = v
    if em.peak * 4 > SMEM_LIMIT:
        raise RegionError(f"{gid}: {em.peak * 4} bytes of shared memory "
                          f"exceed the block limit {SMEM_LIMIT}")
    return em


def _emit_kernel(members: Sequence[RegionSpec], grid: Sequence[str],
                 in_refs, out_refs, ref_types: Dict[Ref, VType],
                 in_item_shapes, out_item_shapes, dims: Dict[str, int],
                 gid: str, label: str, entry: str, runner: Callable
                 ) -> CudaKernel:
    """Plan and emit one kernel.  Where the reduction a cluster may split
    runs on the tensor cores (``tiles::dot_k_sum``), the cluster is chosen
    again by :func:`fill_cluster` from the blocks an SM holds at the
    emitted body's shared memory (which the cluster does not change), and
    the body emitted again under that plan."""
    bare, cand = plan_and_candidate(members, grid, ref_types, in_refs,
                                    in_item_shapes, dims)
    plan = clustered(bare, cand, len(members), dims)
    body = (in_refs, out_refs, ref_types, in_item_shapes, out_item_shapes,
            dims, gid)
    em = _emit_members(members, plan, *body, candidate=_split_node(
        members, (len(members) - 1, cand[0]) if cand else None))
    if em.summed_candidate:
        tuned = clustered(bare, cand, len(members), dims,
                          resident_blocks(em.peak * 4))
        if tuned != plan:
            plan = tuned
            em = _emit_members(members, plan, *body)
    # the name the profiler shows: the emitter, the group, and a digest of
    # the body (the same group at another shape gets another name)
    digest = hashlib.sha1("\n".join(em.lines).encode()).hexdigest()[:8]
    kname = f"{entry}_{_cname(gid)}_{digest}"
    source = _kernel_source(em, plan, kname, gid, label, entry,
                            len(in_refs), len(out_refs))
    in_full = [merged_shape(ref_types[r], ish, dims)
               for r, ish in zip(in_refs, in_item_shapes)]
    out_full = [merged_shape(ref_types[r], ish, dims)
                for r, ish in zip(out_refs, out_item_shapes)]
    return CudaKernel(gid, label, entry, kname, source, runner, in_full,
                      out_full, em.peak * 4, plan,
                      round(em.flops * plan.blocks),
                      sorted(em.aligned_inputs), _product_path(em))


# ---------------------------------------------------------------------------
# Region and group lowering
# ---------------------------------------------------------------------------

def emit_region(spec: RegionSpec, dims: Dict[str, int],
                in_item_shapes: List[Tuple[int, ...]], gid: str = ""):
    """Lower one region to one CUDA kernel.  Returns ``(kernel,
    out_item_shapes, report)``; the grid is the region's parallel spine
    and its serial ``red_dim`` a loop inside the kernel, whose trips the
    kernel's launch plan may split over a thread-block cluster."""
    rg = spec.graph
    for d in spec.grid_dims:
        if d not in dims:
            raise RegionError(f"grid dim {d} missing from dims")
    in_types = [rg.nodes[i].vtype for i in rg.input_ids]
    out_types = P.output_types(rg)
    runner = CT.region_runner(spec, dims)
    in_full = [merged_shape(vt, ish, dims)
               for vt, ish in zip(in_types, in_item_shapes)]
    out_items = CT.item_shapes(runner, in_full, out_types, dims)
    ref_types = dict(zip(spec.in_refs, in_types))
    ref_types.update(zip(spec.out_refs, out_types))
    kern = _emit_kernel([spec], spec.grid_dims, spec.in_refs,
                        spec.out_refs, ref_types, in_item_shapes, out_items,
                        dims, gid, spec.label, "emit_region", runner)
    report = RegionReport(spec.label, tuple(spec.grid_dims), spec.red_dim,
                          len(out_types))
    return kern, out_items, report


def emit_group(group, types: Dict[Ref, VType], dims: Dict[str, int],
               in_item_shapes: List[Tuple[int, ...]]):
    """Lower one region group to one CUDA kernel: the members run in
    sequence inside it, values that cross members stay in shared memory,
    and only the group's spilled ``out_refs`` are written out; the launch
    plan may put dims the group's grid dropped back on the launch grid and
    split the last member's reduction over a cluster.  Returns ``(kernel,
    out_item_shapes, reports)``."""
    for d in group.grid_dims:
        if d not in dims:
            raise RegionError(f"grid dim {d} missing from dims")
    out_types = [types[r] for r in group.out_refs]
    runner = CT.group_runner(group, dims)
    in_full = [merged_shape(types[r], ish, dims)
               for r, ish in zip(group.in_refs, in_item_shapes)]
    out_items = CT.item_shapes(runner, in_full, out_types, dims)
    kern = _emit_kernel(group.members, group.grid_dims, group.in_refs,
                        group.out_refs, types, in_item_shapes, out_items,
                        dims, group.gid, group.label, "emit_group", runner)
    reports = [RegionReport(spec.label, spec.grid_dims, spec.red_dim,
                            len(spec.out_refs), group=group.gid)
               for spec in group.members]
    return kern, out_items, reports


# ---------------------------------------------------------------------------
# Whole-program lowering
# ---------------------------------------------------------------------------

def emit_program(g: Graph, dims: Dict[str, int], blocks: Dict[str, int],
                 program_plan: Optional[ProgramPlan] = None,
                 grouped_plan=None, group: bool = True
                 ) -> Tuple[Callable[..., Tuple], LoweringReport]:
    """Lower every region of (the partition of) ``g``: one CUDA kernel
    per region group, as the reference emits one ``pallas_call`` per
    group.  Returns ``(fn, report)``: ``fn(*merged, instances=0)`` takes
    one merged array per program input and returns the merged outputs.

    A group the emitter cannot express (its shared memory past
    :data:`SMEM_LIMIT`, say) degrades to one kernel per member region,
    with a warning, the ids ``<gid>.<node>`` and a line in
    ``report.degraded``, as the reference's does (codegen_pallas.py:
    866-880); ``fn.emitted_kernels`` lists what each
    kernel serves (a ``RegionGroup`` or a ``RegionSpec``), from which the
    driver re-derives the per-kernel costs.  There is no plain fallback:
    a program the partitioner cannot split, or a region the emitter
    cannot express, raises ``RegionError`` here (the reference would run
    it as a jax region, codegen_pallas.py:786-804, 851-853)."""
    pp = program_plan if program_plan is not None else plan(g)
    gp = grouped_plan
    if gp is None:
        gp = (R.group_plan(pp, dims, blocks) if group
              else R.ungrouped_plan(pp))
    types = pp.graph.infer_types()
    report = LoweringReport()

    item_shapes: Dict[Ref, Tuple[int, ...]] = {}
    for iid in pp.graph.input_ids:
        vt = pp.graph.nodes[iid].vtype
        for d in vt.dims[:vt.lead_dims]:
            if blocks.get(d, 1) != 1:
                raise ValueError(
                    f"stack dim {d} of {vt!r} needs block size 1, got "
                    f"{blocks[d]}")
        item_shapes[(iid, 0)] = tuple(blocks[d]
                                      for d in vt.dims[vt.lead_dims:])

    lowered: List[Tuple[KernelRun, CudaKernel]] = []
    emitted: List[Tuple[str, Any]] = []

    def lower_one(spec: RegionSpec, gid: str) -> None:
        kern, out_items, rep = emit_region(
            spec, dims, [item_shapes[r] for r in spec.in_refs], gid)
        item_shapes.update(zip(spec.out_refs, out_items))
        lowered.append((KernelRun(gid, rep.label, tuple(spec.in_refs),
                                  tuple(spec.out_refs)), kern))
        emitted.append((gid, spec))
        report.regions.append(replace(rep, group=gid))

    for grp in gp.groups:
        if len(grp.members) == 1:
            lower_one(grp.members[0], grp.gid)
            continue
        try:
            kern, out_items, reps = emit_group(
                grp, types, dims, [item_shapes[r] for r in grp.in_refs])
        except RegionError as err:
            warnings.warn(f"grouped lowering of {grp.gid} fell back to "
                          f"per-region kernels ({err})", RuntimeWarning,
                          stacklevel=2)
            report.degraded.append(f"{grp.gid}: {err}")
            for spec in grp.members:
                lower_one(spec, f"{grp.gid}.{spec.node}")
            continue
        item_shapes.update(zip(grp.out_refs, out_items))
        lowered.append((KernelRun(grp.gid, grp.label, tuple(grp.in_refs),
                                  tuple(grp.out_refs)), kern))
        emitted.append((grp.gid, grp))
        report.regions.extend(reps)
        report.resident_edges += len(grp.resident)
    report.launches = len(lowered)

    out_refs = [(e.src, e.sp) for oid in pp.graph.output_ids
                for e in [pp.graph.in_edge(oid, 0)]]
    run = _chain(lowered, [(iid, 0) for iid in pp.graph.input_ids],
                 out_refs)
    run.emitted_kernels = emitted
    return run, report


def _chain(lowered, input_refs, out_refs) -> Callable:
    def run(*merged_inputs, instances: int = 0):
        env: Dict[Ref, Any] = dict(zip(input_refs, merged_inputs))
        for kr, fn in lowered:
            outs = fn(*[env[r] for r in kr.in_refs], instances=instances)
            for ref, o in zip(kr.out_refs, outs):
                env[ref] = o
        return tuple(env[r] for r in out_refs)

    run.region_runners = lowered
    run.input_refs = list(input_refs)
    run.output_refs = list(out_refs)
    return run
