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

What a kernel does.  One thread block runs per cell of the group's
parallel grid, times up to two leading *instance* axes, which stand in for
the ``jax.vmap`` the model layers wrap around a compiled kernel: every
input and output has a stride per instance axis, and a stride of 0 means
"shared".  Inside the block the region graph is walked in order:

* a map over a grid dim is the block's own coordinate;
* every other map is an in-kernel loop that computes its operands'
  offsets into the merged arrays (list outputs are written per step,
  straight to their destination);
* a serial map's reduced ports are float32 accumulators in shared memory,
  advanced with the two-phase coupled update of
  ``ops.serial_accum_step``: all new maxima are computed before any
  accumulator is written, and ``+@k`` is
  ``acc * exp(z_old - z_new) + step * exp(m - z_new)``;
* functional operators call the tile templates of ``csrc/tiles.cuh``
  (elementwise expressions are translated to C with ``ast``); their
  results live in shared memory, and values that cross regions inside a
  group stay there;
* kernel inputs are never copied whole on chip: every operator reads its
  tiles straight from device memory, tile by tile.

What bounds it.  These are the simple first kernels: threads stride over
the elements of each tile, and every operator ends with
``__syncthreads()``.  The work they do is matrix products at one block
per grid cell, so at decode sizes they are bound by the bytes of the
weights they read, and at the full smollm-135m widths the SwiGLU groups
run on 1 and 6 blocks of the card's 132 SMs: the grid, not the memory,
limits them (``PERF.md``).

On a CUDA tensor a kernel launches or raises; it takes its plain version
(``codegen_torch.region_runner``/``group_runner``) only for tensors on
the CPU.  Kernels are built on first use by ``core/cuda_build.py``.
"""

from __future__ import annotations

import ast
import ctypes
import math
import re
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import codegen_torch as CT
from repro_torch.core import cuda_build as CB
from repro_torch.core import ops as O
from repro_torch.core import regions as R
from repro_torch.core.runtime import current_stream, placement
from repro_torch.core.blocks import merged_shape
from repro_torch.core.graph import (FuncNode, Graph, InputNode, MapNode,
                                    OutputNode, Ref, ReduceNode, VType)
from repro_torch.core.regions import ProgramPlan, RegionError, RegionSpec
from repro_torch.pipeline import packing as P

THREADS = 256
SMEM_LIMIT = 232448   # bytes of shared memory one H100 block may opt into
MAX_INSTANCE_AXES = 2



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
    kernels launched (grouped regions share one) and the cross-region
    values kept on chip.  Its ``summary()`` is the reference's; the port
    has no fallbacks to report."""

    regions: List[RegionReport] = field(default_factory=list)
    launches: int = 0
    resident_edges: int = 0

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

    def index(self, dim: str, idx: str) -> "_View":
        if not self.lists or self.lists[0][0] != dim:
            raise RegionError(f"map[{dim}] indexes a value listed over "
                              f"{[d for d, _ in self.lists]}")
        stride = self.lists[0][1]
        off = self.off if stride == 0 else f"{self.off} + {idx} * {stride}"
        return replace(self, off=off, lists=self.lists[1:])

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


# ---------------------------------------------------------------------------
# The emitter
# ---------------------------------------------------------------------------

def _cname(dim: str) -> str:
    return re.sub(r"[^A-Za-z0-9_]", "_", dim)


class _Emitter:
    """Walks region graphs and writes the body of one ``__global__``
    kernel.  Shared memory is a bump allocator that releases a loop
    body's buffers when the body ends."""

    def __init__(self, dims: Dict[str, int], grid: Sequence[str]):
        self.dims = dims
        self.grid = tuple(grid)
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
                     tuple(shape), _row_major(shape))

    def loop(self, dim: str) -> str:
        """Open a loop over an off-grid dim (or bind the block's own
        coordinate of a grid dim); returns the index expression."""
        if dim in self.grid:
            return f"g_{_cname(dim)}"
        i = self.fresh("i")
        self.emit(f"for (int {i} = 0; {i} < {self.dims[dim]}; ++{i}) {{")
        self.depth += 1
        self._trips.append(self._trips[-1] * self.dims[dim])
        return i

    def close(self, dim: str) -> None:
        if dim not in self.grid:
            self.depth -= 1
            self._trips.pop()
            self.emit("}")

    def count_flops(self, n: int) -> None:
        self.flops += n * self._trips[-1]

    # -- item-level code ----------------------------------------------------
    def ew(self, out: _View, args: Sequence[Tuple[str, int, int]],
           expr: str) -> None:
        """out[r, c] = expr over x_i = args_i[r * rs + c * cs]."""
        rows, cols, ors, ocs = out.as2d()
        if args:
            self.count_flops(rows * cols)
        loads = " ".join(f"const float x{i} = {a}[r * {rs} + c * {cs}];"
                         for i, (a, rs, cs) in enumerate(args))
        self.emit(f"tiles::ew<{rows}, {cols}>({out.addr}, {ors}, {ocs}, "
                  f"[&](int r, int c) {{ {loads} return {expr}; }});")

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
        o = f"{out.addr}, {ors}, {ocs}"
        if isinstance(op, O.Elementwise):
            self.ew(out, [_bcast2d(v, rows, cols) for v in ins],
                    expr_to_c(op))
            return
        self.count_flops(rows * cols)
        if isinstance(op, O.Dot):
            a, b = ins
            _, k, ars, acs = a.as2d()
            _, _, brs, bcs = b.as2d()
            self.count_flops(rows * cols * (2 * k - 1))
            self.emit(f"tiles::dot<{rows}, {cols}, {k}>({o}, {a.addr}, "
                      f"{ars}, {acs}, {b.addr}, {brs}, {bcs});")
        elif isinstance(op, O.Outer):
            a, b = ins
            self.emit(f"tiles::outer<{rows}, {cols}>({o}, {a.addr}, "
                      f"{a.strides[0]}, {b.addr}, {b.strides[0]});")
        elif isinstance(op, (O.RowScale, O.RowShift)):
            a, c = ins
            _, _, ars, acs = a.as2d()
            cs = c.strides[0] if c.shape else 0
            name = "row_scale" if isinstance(op, O.RowScale) else "row_shift"
            self.emit(f"tiles::{name}<{rows}, {cols}>({o}, {a.addr}, {ars}, "
                      f"{acs}, {c.addr}, {cs});")
        elif isinstance(op, (O.RowSum, O.RowMax)):
            a = ins[0]
            ar, ac, ars, acs = a.as2d()
            name = "row_sum" if isinstance(op, O.RowSum) else "row_max"
            self.emit(f"tiles::{name}<{ar}, {ac}>({out.addr}, "
                      f"{out.strides[0]}, {a.addr}, {ars}, {acs});")
        elif isinstance(op, O.CausalMask):
            a, rv, cv = ins
            _, _, ars, acs = a.as2d()
            self.emit(f"tiles::causal_mask<{rows}, {cols}>({o}, {a.addr}, "
                      f"{ars}, {acs}, {rv.addr}, {rv.strides[0]}, "
                      f"{cv.addr}, {cv.strides[0]});")
        else:
            raise RegionError(f"operator {op!r} has no CUDA tile template")

    # -- graph-level code ---------------------------------------------------
    def shapes(self, g: Graph, in_shapes: Sequence[Tuple[int, ...]]
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
                inner = self.shapes(node.inner, ins)
                for p, oid in enumerate(node.inner.output_ids):
                    e = node.inner.in_edge(oid, 0)
                    sh[(nid, p)] = inner[(e.src, e.sp)]
            else:
                raise RegionError(f"{node.label()} has no CUDA lowering")
        return sh

    def graph(self, g: Graph, ins: Sequence[_View],
              dests: Sequence[Optional[_View]]) -> List[_View]:
        """Emit ``g`` on input views; output ``k`` lands in ``dests[k]``
        when one is given.  Returns the output views."""
        types = self.types(g)
        shapes = self.shapes(g, [v.shape for v in ins])
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
                out = want.get((nid, 0)) or self.alloc((), shapes[(nid, 0)])
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
        acc = dest or self.alloc([l for l, _ in x.lists[1:]], x.shape)
        is_max = node.op == O.REDUCE_MAX
        self.fill(acc, -math.inf if is_max else 0.0)
        i = self.loop(d)
        expr = "fmaxf(x0, x1)" if is_max else "(x0 + x1)"

        def item(vs):
            a, v = vs
            rows, cols, _, _ = a.as2d()
            self.ew(a, [_bcast2d(a, rows, cols), _bcast2d(v, rows, cols)],
                    expr)
        self.over_items([acc, x.index(d, i)], item)
        self.close(d)
        return acc

    def map(self, g: Graph, nid: int, node: MapNode, ins: Sequence[_View],
            dests: Dict[int, Optional[_View]], shapes, vtypes) -> List[_View]:
        d = node.dim
        if node.serial and d in self.grid:
            raise RegionError(f"serial map[{d}] over a grid-selected dim")
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
                self.fill(outs[p], -math.inf if r == O.REDUCE_MAX else 0.0)
        idx = self.loop(d)
        mark = self.smem
        body_in = [v.index(d, idx) if m else v
                   for v, m in zip(ins, node.mapped)]
        body_dst = [outs[p].index(d, idx)
                    if r is None and outs[p] is not None else None
                    for p, r in enumerate(node.reduced)]
        res = self.graph(node.inner, body_in, body_dst)
        if node.serial:
            self.accumulate(node, outs, res)
        self.smem = mark
        self.close(d)
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

def _kernel_source(em: _Emitter, gid: str, label: str, entry: str,
                   n_in: int, n_out: int) -> str:
    grid = em.grid
    gx = int(np.prod([em.dims[d] for d in grid])) if grid else 1
    smem = em.peak * 4
    # the name the profiler shows: which emitter, which group
    kname = f"{entry}_{_cname(gid)}"
    head = [
        f"// {entry} kernel {gid}: {label}",
        "// Emitted by repro_torch/core/codegen_cuda.py; replaces the "
        f"pallas_call of repro.core.codegen_pallas.{entry}.",
        f"// grid {list(grid)} = {gx} blocks x instances; "
        f"{smem} bytes of shared memory.",
        f"// {em.flops} float operations per block; inputs are read from "
        "device memory tile by tile as the operators use them.",
        '#include "tiles.cuh"',
        "",
        f"struct KArgs {{ const float* in[{max(n_in, 1)}]; "
        f"float* out[{max(n_out, 1)}]; long long is[{max(n_in, 1)}][2]; "
        f"long long os[{max(n_out, 1)}][2]; }};",
        "",
        f"__global__ void __launch_bounds__({THREADS}) "
        f"{kname}(const KArgs A) {{",
        "  extern __shared__ float smem[];",
        "  const long long u0 = blockIdx.y, u1 = blockIdx.z;",
    ]
    for j in range(n_in):
        head.append(f"  const float* in{j} = A.in[{j}] + u0 * A.is[{j}][0]"
                    f" + u1 * A.is[{j}][1];")
    for j in range(n_out):
        head.append(f"  float* out{j} = A.out[{j}] + u0 * A.os[{j}][0]"
                    f" + u1 * A.os[{j}][1];")
    if grid:
        head.append("  int cell = blockIdx.x;")
        for d in reversed(grid):
            n = em.dims[d]
            head.append(f"  const int g_{_cname(d)} = cell % {n}; "
                        f"cell /= {n};")
    tail = [
        "}",
        "",
        'extern "C" int launch(void** ptrs, const long long* strides, '
        "int inst0, int inst1, void* stream) {",
        "  KArgs a;",
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
    if smem > 48 * 1024:  # dynamic shared memory past 48 KB is opt-in
        tail += [
            f"  cudaError_t e = cudaFuncSetAttribute({kname}, "
            f"cudaFuncAttributeMaxDynamicSharedMemorySize, {smem});",
            "  if (e != cudaSuccess) return (int)e;",
        ]
    tail += [
        f"  {kname}<<<dim3({gx}, inst0, inst1), {THREADS}, "
        f"{smem}, (cudaStream_t)stream>>>(a);",
        "  return (int)cudaGetLastError();",
        "}",
        "",
    ]
    return "\n".join(head + em.lines + tail)


def _trailing_contiguous(t: torch.Tensor, lead: int) -> bool:
    expect = 1
    for size, stride in zip(reversed(t.shape[lead:]),
                            reversed(t.stride()[lead:])):
        if size != 1 and stride != expect:
            return False
        expect *= size
    return True


class CudaKernel:
    """One emitted kernel: its CUDA source, its plain version, and a launch
    counter.  ``kern(*merged, instances=k)`` takes merged arrays (each
    with ``k`` leading instance axes; size 1 is shared) and returns the
    merged outputs."""

    def __init__(self, gid: str, label: str, entry: str, source: str,
                 runner: Callable, in_full, out_full, smem_bytes: int,
                 blocks: int, flops: int = 0):
        self.gid, self.label, self.entry = gid, label, entry
        self.source = source
        self.runner = runner
        self.in_full = [tuple(s) for s in in_full]
        self.out_full = [tuple(s) for s in out_full]
        self.smem_bytes = smem_bytes
        self.blocks = blocks
        self.flops = flops    # float operations per instance
        self.launcher = CB.Launcher(source, "launch",
                                    what=f"kernel {gid} ({label})")

    def __repr__(self):
        return (f"<CudaKernel {self.gid} {self.label} blocks={self.blocks} "
                f"smem={self.smem_bytes}>")

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
        if placement(self.gid, *merged) == "cpu":
            return self.plain(*merged, instances=instances)
        return self.launch(*merged, instances=instances)

    def launch(self, *merged, instances: int = 0):
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
        inst = tuple(torch.broadcast_shapes(
            *[tuple(a.shape[:instances]) for a in merged]))
        outs = [torch.empty(inst + s, dtype=torch.float32, device=dev)
                for s in self.out_full]
        strides: List[int] = []
        for t in list(merged) + outs:
            st = [t.stride(k) if t.shape[k] != 1 else 0
                  for k in range(instances)]
            strides += st + [0] * (MAX_INSTANCE_AXES - instances)
        ext = list(inst) + [1] * (MAX_INSTANCE_AXES - instances)
        tensors = list(merged) + outs
        ptrs = (ctypes.c_void_p * len(tensors))(
            *[t.data_ptr() for t in tensors])
        arr = (ctypes.c_longlong * len(strides))(*strides)
        with torch.cuda.device(dev):
            self.launcher.launch(ptrs, arr, ext[0], ext[1],
                                 current_stream(dev))
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


def _emit_kernel(members: Sequence[RegionSpec], grid: Sequence[str],
                 in_refs, out_refs, ref_types: Dict[Ref, VType],
                 in_item_shapes, out_item_shapes, dims: Dict[str, int],
                 gid: str, label: str, entry: str, runner: Callable
                 ) -> CudaKernel:
    em = _Emitter(dims, grid)
    env: Dict[Ref, _View] = {}
    for j, (r, ish) in enumerate(zip(in_refs, in_item_shapes)):
        env[r] = _merged_view(f"in{j}", ref_types[r], ish, dims)
    spilled = {r: _merged_view(f"out{j}", ref_types[r], ish, dims)
               for j, (r, ish) in enumerate(zip(out_refs, out_item_shapes))}
    for spec in members:
        ins = [env[r] for r in spec.in_refs]
        shapes = em.shapes(spec.graph, [v.shape for v in ins])
        dests = []
        for oid, r in zip(spec.graph.output_ids, spec.out_refs):
            if r in spilled:
                dests.append(spilled[r])
                continue
            e = spec.graph.in_edge(oid, 0)
            dests.append(em.alloc(ref_types[r].dims, shapes[(e.src, e.sp)]))
        for r, v in zip(spec.out_refs, em.graph(spec.graph, ins, dests)):
            if r in spilled and v.shape != spilled[r].shape:
                raise RegionError(f"{gid}: emitted item shape {v.shape} of "
                                  f"{r} disagrees with {spilled[r].shape}")
            env[r] = v
    if em.peak * 4 > SMEM_LIMIT:
        raise RegionError(f"{gid}: {em.peak * 4} bytes of shared memory "
                          f"exceed the block limit {SMEM_LIMIT}")
    source = _kernel_source(em, gid, label, entry, len(in_refs),
                            len(out_refs))
    in_full = [merged_shape(ref_types[r], ish, dims)
               for r, ish in zip(in_refs, in_item_shapes)]
    out_full = [merged_shape(ref_types[r], ish, dims)
                for r, ish in zip(out_refs, out_item_shapes)]
    blocks = int(np.prod([dims[d] for d in grid])) if grid else 1
    return CudaKernel(gid, label, entry, source, runner, in_full, out_full,
                      em.peak * 4, blocks, em.flops * blocks)


# ---------------------------------------------------------------------------
# Region and group lowering
# ---------------------------------------------------------------------------

def emit_region(spec: RegionSpec, dims: Dict[str, int],
                in_item_shapes: List[Tuple[int, ...]], gid: str = ""):
    """Lower one region to one CUDA kernel.  Returns ``(kernel,
    out_item_shapes, report)``; the grid is the region's parallel spine
    and its serial ``red_dim`` is a loop inside the kernel."""
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
    and only the group's spilled ``out_refs`` are written out.  Returns
    ``(kernel, out_item_shapes, reports)``."""
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

    There is no fallback: a program the partitioner cannot split, or a
    region or group the emitter cannot express, raises ``RegionError``
    here (the reference would run it as a jax region or per-region
    kernels, codegen_pallas.py:786-804, 851-880)."""
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
    for grp in gp.groups:
        if len(grp.members) == 1:
            spec = grp.members[0]
            in_refs, out_refs = spec.in_refs, spec.out_refs
            kern, out_items, rep = emit_region(
                spec, dims, [item_shapes[r] for r in in_refs], grp.gid)
            reps, label = [replace(rep, group=grp.gid)], rep.label
        else:
            in_refs, out_refs = grp.in_refs, grp.out_refs
            kern, out_items, reps = emit_group(
                grp, types, dims, [item_shapes[r] for r in in_refs])
            label = grp.label
            report.resident_edges += len(grp.resident)
        item_shapes.update(zip(out_refs, out_items))
        lowered.append((KernelRun(grp.gid, label, tuple(in_refs),
                                  tuple(out_refs)), kern))
        report.regions.extend(reps)
    report.launches = len(lowered)

    out_refs = [(e.src, e.sp) for oid in pp.graph.output_ids
                for e in [pp.graph.in_edge(oid, 0)]]
    return _chain(lowered, [(iid, 0) for iid in pp.graph.input_ids],
                  out_refs), report


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
    return run
