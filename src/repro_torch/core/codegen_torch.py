"""Plain PyTorch lowering of block programs: the port of
``repro.core.codegen_jax``.

Lowering rules.  Values are stacked tensors: ``nb`` leading *batch* axes
(one per enclosing parallel map, plus the instance axes of a batched
call), then one axis per list level, then the item's axes:

  * parallel Map  -> a batch axis written out: mapped ports already carry
                     the map's list axis at position ``nb``; broadcast
                     ports get a size-1 axis there, which torch's
                     broadcasting expands (the counterpart of
                     ``jax.vmap``)
  * serial Map    -> a Python loop with float32 carries for the reduced
                     ports ("+", "max", and the coupled "+@k" of
                     ``ops.serial_accum_step``)
  * Reduce        -> a float32 sum or max over the list axis
  * Func          -> the operator on the trailing item axes

Besides the whole-program lowering (the ``"torch"`` backend),
:func:`region_runner` and :func:`group_runner` evaluate one
``RegionSpec`` or ``RegionGroup`` under the same merged-array contract as
the CUDA kernel that ``core/codegen_cuda.py`` emits for it: the plain
version every kernel is tested against.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import torch

from repro_torch.core import ops as O
from repro_torch.core.graph import (FuncNode, Graph, InputNode, MapNode,
                                    MiscNode, OutputNode, ReduceNode, VType)
from repro_torch.pipeline import packing as P

_RANK = {O.BLOCK: 2, O.VECTOR: 1, O.SCALAR: 0}


def _lift(x, nb: int, extra: int):
    """Insert ``extra`` singleton axes right after the ``nb`` batch axes,
    so an item of lower rank broadcasts along numpy's trailing rule."""
    if not extra:
        return x
    return x.reshape(tuple(x.shape[:nb]) + (1,) * extra
                     + tuple(x.shape[nb:]))


def apply_op(op: O.Op, args: Sequence[torch.Tensor],
             kinds: Sequence[str], nb: int) -> torch.Tensor:
    """One functional operator on batched items (item axes trailing)."""
    if isinstance(op, O.Dot):
        a, b = args
        return a @ b.transpose(-1, -2)
    if isinstance(op, O.Outer):
        a, b = args
        return a.unsqueeze(-1) * b.unsqueeze(-2)
    if isinstance(op, (O.RowScale, O.RowShift)):
        a, c = args
        c = c.unsqueeze(-1) if kinds[1] == O.VECTOR else c[..., None, None]
        return a * c if isinstance(op, O.RowScale) else a + c
    if isinstance(op, O.RowSum):
        return args[0].sum(-1)
    if isinstance(op, O.RowMax):
        return args[0].amax(-1)
    if isinstance(op, O.CausalMask):
        a, rows, cols = args
        keep = rows.unsqueeze(-1) >= cols.unsqueeze(-2)
        return torch.where(keep, a, torch.full_like(a, O.NEG_MASK))
    if isinstance(op, O.Elementwise):
        rank = max(_RANK[k] for k in kinds)
        lifted = [_lift(a, nb, rank - _RANK[k]) for a, k in zip(args, kinds)]
        return op.apply(torch, *lifted)
    raise NotImplementedError(f"operator {op!r}")


def _reduce(node: ReduceNode, x: torch.Tensor, nb: int) -> torch.Tensor:
    xf = x.float()
    if node.op == O.REDUCE_MAX:
        return xf.amax(nb).to(x.dtype)
    if node.op != O.REDUCE_ADD:
        raise NotImplementedError(f"reduce {node.op!r}")
    return xf.sum(nb).to(x.dtype)


def _step(node, ins: Sequence[torch.Tensor], kinds: Sequence[str],
          dims: Dict[str, int], nb: int) -> List[torch.Tensor]:
    """One operator node on its evaluated inputs: its output ports."""
    if isinstance(node, FuncNode):
        return [apply_op(node.op, ins, kinds, nb)]
    if isinstance(node, ReduceNode):
        return [_reduce(node, ins[0], nb)]
    if isinstance(node, MiscNode):
        res = node.fn(torch, *ins)
        return [res] if node.n_out() == 1 else list(res)
    if isinstance(node, MapNode):
        return _lower_map(node, ins, dims, nb)
    raise TypeError(node)


def _eval(g: Graph, inputs: Sequence[torch.Tensor], dims: Dict[str, int],
          nb: int, per_op: bool = False) -> List[torch.Tensor]:
    """Evaluate ``g``; ``per_op`` materializes every top-level operator's
    outputs (``contiguous``) before the next one runs."""
    types = g.infer_types()
    env: Dict = {(nid, 0): v for nid, v in zip(g.input_ids, inputs)}
    outs: Dict[int, Any] = {}
    for nid in g.topo():
        node = g.nodes[nid]
        if isinstance(node, InputNode):
            continue
        edges = g.in_edges(nid)
        ins = [env[(e.src, e.sp)] for e in edges]
        if isinstance(node, OutputNode):
            outs[nid] = ins[0]
            continue
        kinds = [types[(e.src, e.sp)].item for e in edges]
        for p, r in enumerate(_step(node, ins, kinds, dims, nb)):
            env[(nid, p)] = r.contiguous() if per_op else r
    return [outs[oid] for oid in g.output_ids]


def _lower_map(node: MapNode, ins: Sequence[torch.Tensor],
               dims: Dict[str, int], nb: int) -> List[torch.Tensor]:
    n = dims[node.dim]
    if not node.serial:
        inner = [v if m else v.unsqueeze(nb)
                 for v, m in zip(ins, node.mapped)]
        res = _eval(node.inner, inner, dims, nb + 1)
        return [r.expand(*r.shape[:nb], n, *r.shape[nb + 1:]) for r in res]

    # serial map: accumulated ports are float32 carries ("max" from -inf,
    # the others from 0); "+@k" ports rescale against max port k on every
    # step — the online-softmax recurrence of ops.serial_accum_step
    carry: Dict[int, torch.Tensor] = {}
    steps: Dict[int, List[torch.Tensor]] = {}
    dtypes: Dict[int, torch.dtype] = {}
    for i in range(n):
        body_in = [v.select(nb, i) if m else v
                   for v, m in zip(ins, node.mapped)]
        res = _eval(node.inner, body_in, dims, nb)
        vals = {}
        for p, r in enumerate(node.reduced):
            if r is None:
                steps.setdefault(p, []).append(res[p])
                continue
            dtypes[p] = res[p].dtype
            vals[p] = res[p].float()
            if p not in carry:
                fill = float("-inf") if r == O.REDUCE_MAX else 0.0
                carry[p] = torch.full_like(vals[p], fill)
        z_old, z_new = {}, {}
        for p, r in enumerate(node.reduced):
            if r == O.REDUCE_MAX:
                z_old[p] = carry[p]
                z_new[p] = torch.maximum(carry[p], vals[p])
        for p, r in enumerate(node.reduced):
            if r is None:
                continue
            if r == O.REDUCE_ADD:
                carry[p] = carry[p] + vals[p]
            elif r == O.REDUCE_MAX:
                carry[p] = z_new[p]
            else:
                k = O.rescaled_ref(r)
                if k is None:
                    raise NotImplementedError(f"reduced tag {r!r}")
                step = vals[p] * O.bcast_to(
                    torch, torch.exp(vals[k] - z_new[k]), vals[p])
                carry[p] = carry[p] * O.bcast_to(
                    torch, torch.exp(z_old[k] - z_new[k]), carry[p]) + step
    out = []
    for p, r in enumerate(node.reduced):
        if r is None:
            out.append(torch.stack(steps[p], dim=nb))
        else:
            out.append(carry[p].to(dtypes[p]))
    return out


def compile_program(g: Graph, dims: Dict[str, int], per_op: bool = False
                    ) -> Callable[..., List[torch.Tensor]]:
    """``f(*stacked_inputs, batch=0) -> [stacked_outputs]``; ``batch``
    leading axes of every input are instance axes (size 1 broadcasts).

    With ``per_op`` each top-level operator runs on its own, dispatched
    from Python, with every intermediate materialized between operators:
    the launch-per-operator unfused baseline of the reference's
    ``jit="per-op"`` (codegen_jax.py:150-212)."""

    def fn(*inputs, batch: int = 0):
        return _eval(g, inputs, dims, batch, per_op)

    return fn


def _io_types(g: Graph):
    in_types = [g.nodes[i].vtype for i in g.input_ids]
    return in_types, P.output_types(g)


def merged_runner(g: Graph, dims: Dict[str, int], per_op: bool = False
                  ) -> Callable:
    """Merged arrays in, merged arrays out, through the stacked
    lowering: ``f(*merged, instances=0) -> tuple``."""
    in_types, out_types = _io_types(g)
    prog = compile_program(g, dims, per_op)

    def run(*merged, instances: int = 0):
        stacked = [P.to_stacked(a, vt, dims, instances)
                   for vt, a in zip(in_types, merged)]
        outs = prog(*stacked, batch=instances)
        return tuple(P.from_stacked(o, vt, dims, instances)
                     for vt, o in zip(out_types, outs))

    return run


def region_runner(spec, dims: Dict[str, int]) -> Callable:
    """The plain version of one region's kernel (same merged contract)."""
    return merged_runner(spec.graph, dims)


def group_runner(group, dims: Dict[str, int]) -> Callable:
    """The plain version of one group megakernel: its members in
    sequence, in-group values threaded by reference, the group's spilled
    ``out_refs`` returned."""
    members = [(spec, region_runner(spec, dims)) for spec in group.members]

    def run(*merged, instances: int = 0):
        env = dict(zip(group.in_refs, merged))
        for spec, fn in members:
            outs = fn(*[env[r] for r in spec.in_refs], instances=instances)
            env.update(zip(spec.out_refs, outs))
        return tuple(env[r] for r in group.out_refs)

    return run


def item_shapes(fn: Callable, in_full: Sequence[Sequence[int]],
                out_types: Sequence[VType], dims: Dict[str, int]):
    """Output item shapes of a merged-contract runner, found by running it
    on ``meta`` tensors (no data, no device): the port's
    ``jax.eval_shape``."""
    abstract = [torch.empty(tuple(s), dtype=torch.float32, device="meta")
                for s in in_full]
    outs = fn(*abstract)
    return [P.item_shape(tuple(o.shape), vt, dims)
            for o, vt in zip(outs, out_types)]
