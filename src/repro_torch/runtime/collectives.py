"""Collectives over a device mesh's axes, and sequence-parallel decode
attention: the port of ``repro.runtime.collectives``.

:func:`axis_group` is the process group of one or more mesh axes.  The
differentiable pair :func:`sum_over` / :func:`copy_to` is how a layer
that computes partial results on each rank of a group keeps its
gradients exact (Megatron's ``g`` and ``f``): ``sum_over`` all-reduces
in the forward pass and passes the gradient through, ``copy_to`` is the
identity forward and all-reduces the gradient.  Between them, every rank
of the group computes its own part; what follows ``sum_over`` is the
same on every rank, and what precedes ``copy_to`` gets the whole
gradient.  ``torch.distributed.all_reduce`` alone records no backward.

:func:`distributed_decode_attention` is one-token attention against a KV
cache split along its sequence over a mesh axis.  The paper's appendix
defines the safe combination of exponentiated partial sums,
``(S1,t1) + (S2,t2) = (S1 e^{t1-z} + S2 e^{t2-z}, z)``, ``z = max(t1,t2)``:
that identity is the flash-decoding merge.  Each rank computes its shard's
(numerator, denominator, row max) in plain torch, as the reference does
in plain XLA, and the ranks combine them with one MAX and two SUM
all-reduces.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.runtime.sharding import axis_names, axis_size

NEG_INF = -1e30


def axis_group(mesh, axes):
    """The process group of the mesh axes ``axes`` (a name or a sequence
    of names; several are flattened into one group, the first major)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def axis_index(mesh, axes) -> int:
    """This rank's index along the mesh axes ``axes`` together (the
    first the major one)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    idx = 0
    for a in axes:
        idx = idx * axis_size(mesh, a) + mesh.get_local_rank(a)
    return idx


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, in ``x``'s dtype; its
    gradient is the incoming one, as it is on every rank."""
    return _SumOver.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, whose gradient is summed over ``group``'s ranks: the input
    of a computation split across the group."""
    return _CopyTo.apply(x, group)


def _local_partial(q, k, v, scale, kv_valid):
    """One shard's attention partials: (numerator, denominator, row max).

    q: (B, H, 1, Dh); k, v: (B, Hkv, S_shard, Dh); ``kv_valid``: how many
    of the shard's positions are filled (the rest masked with
    ``NEG_INF``, so a shard with none gives weight 0, not NaN)."""
    b, h, _, dh = q.shape
    hkv = k.shape[1]
    g = h // hkv
    qf = q.float().reshape(b, hkv, g, dh)
    s = torch.einsum("bhgd,bhkd->bhgk", qf, k.float()) * scale
    cols = torch.arange(k.shape[2], device=k.device)[None, None, None, :]
    s = torch.where(cols < kv_valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)                           # (b,hkv,g,1)
    p = torch.exp(s - m)
    num = torch.einsum("bhgk,bhkd->bhgd", p, v.float())
    den = p.sum(-1, keepdim=True)
    return num, den, m


def distributed_decode_attention(q, k_cache, v_cache, pos, mesh, *,
                                 scale: Optional[float] = None,
                                 seq_axis: str = "data") -> torch.Tensor:
    """One-token attention against a KV cache split along its sequence
    over ``seq_axis``.  q: (B, H, 1, Dh), the same on every rank;
    ``k_cache``, ``v_cache``: this rank's contiguous shard (B, Hkv,
    S / n, Dh), shard ``i`` holding positions ``i S/n`` on; ``pos``: the
    last filled position (global).  Returns (B, H, 1, Dh) in ``q``'s
    dtype, the same on every rank."""
    from torch.distributed.tensor import DTensor
    if isinstance(k_cache, DTensor):
        return _decode_attention_local_map(q, k_cache, v_cache, pos, mesh,
                                           scale, seq_axis)
    b, h, _, dh = q.shape
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    s_shard = k_cache.shape[2]
    start = mesh.get_local_rank(seq_axis) * s_shard
    kv_valid = min(max(int(pos) + 1 - start, 0), s_shard)
    num, den, m = _local_partial(q, k_cache, v_cache, scale, kv_valid)
    group = axis_group(mesh, seq_axis)
    z = m.clone()
    dist.all_reduce(z, op=dist.ReduceOp.MAX, group=group)
    alpha = torch.exp(m - z)                           # e^{t_i - z}
    num = num * alpha                                  # S_i e^{t_i - z}
    den = den * alpha
    dist.all_reduce(num, group=group)
    dist.all_reduce(den, group=group)
    return (num / den).reshape(b, h, 1, dh).to(q.dtype)


def _decode_attention_local_map(q, k_cache, v_cache, pos, mesh, scale,
                                seq_axis):
    """:func:`distributed_decode_attention` on DTensors, under DTensor's
    ``local_map`` with the placements of the reference's ``shard_map``
    specs: q and ``pos`` whole on every rank, the caches split along their
    sequence over ``seq_axis``; the output whole."""
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.runtime.sharding import Spec, placements
    dmesh = k_cache.device_mesh
    whole = placements((), dmesh)
    seq = placements(Spec(None, None, seq_axis), dmesh)

    def local(q_l, k_l, v_l, pos_l):
        return distributed_decode_attention(q_l, k_l, v_l, pos_l, mesh,
                                            scale=scale, seq_axis=seq_axis)

    from torch.distributed.tensor import DTensor
    pos_pl = whole if isinstance(pos, DTensor) else None
    return local_map(local, out_placements=whole,
                     in_placements=(whole, seq, seq, pos_pl),
                     device_mesh=dmesh, redistribute_inputs=True)(
        q, k_cache, v_cache, pos)


def batch_axes(mesh) -> tuple:
    """The mesh axes a batch is split over (``pod``, ``data``)."""
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def data_parallel_mean(loss: torch.Tensor, grads, count: int, mesh):
    """The loss and gradients of the whole batch from each rank's own:
    each rank's are weighted by its share of the counted tokens
    (``count`` here, over the sum of all ranks' counts) and summed over
    the batch axes' group, so that the result is the mean over every
    token, whatever each rank held.  With one rank the weight is 1.0 and
    the sum the identity: the result equals the rank's own bit for bit."""
    from torch.utils import _pytree as pytree
    group = axis_group(mesh, batch_axes(mesh))
    total = torch.tensor([count], dtype=torch.float64, device=loss.device)
    dist.all_reduce(total, group=group)
    w = count / float(total.item())

    def mean(x):
        x = x * w
        dist.all_reduce(x, group=group)
        return x

    return mean(loss.detach()), pytree.tree_map(mean, grads)
