"""The held experts of an MoE layer on the card, each on only the rows
routed to it: the grouped expert kernel.

The kernel is CUDA C++ written by hand, ``csrc/grouped_experts.cu``, built
by nvcc for ``sm_90a`` at first use.  It replaces no TPU kernel (the
reference runs its experts as plain ``jnp`` einsums); it takes the place of
the padded dispatch and the three padded ``torch.bmm``'s of
``models.layers._held_experts_out`` on the card.  One call launches four
kernels with fixed shapes (:data:`TRACE_NAMES`), so a CUDA graph captures
them once and each replay follows the step's own routing: the grouped
dispatch (each held expert's row count ``n`` and the table of the (token,
k) slot behind each of its rows, both device data), gate/up with the
SwiGLU for each expert's rows, the down projection into each row's (token,
k) slot, and the combine of each token's kept slots by its routing
weights.  A block whose expert has no row returns at once; a touched
expert's weights cross from device memory once for every :data:`RT` of its
rows, and each tile computes exactly its rows: no row is padded, so the
rows computed are ``n.sum()``.  Full float32 (FFMA); every sum runs in a
fixed order, so two calls on the same inputs give the same bits.

Beside it, its plain version in three parts, which CPU tensors run:
:func:`dispatch`, :func:`experts` and :func:`combine`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import cuda_build as CB
from repro_torch.core.runtime import current_stream, placement
from repro_torch.kernels import ref as R

BN = 32          # output columns of each weight a block
RT = 8           # rows of an expert a pass over its weights
MAX_TK = 12288   # (token, k) assignments the dispatch holds
#: the kernels one launch runs, as a device trace names them: the
#: dispatch, gate/up, down and the combine
TRACE_NAMES = ("grouped_moe::dispatch", "grouped_moe::grouped_fwd<2>",
               "grouped_moe::grouped_fwd<1>", "grouped_moe::combine")
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CB.csrc_launcher("grouped_experts.cu", "grouped_moe_fwd",
                          [_P] * 13 + [_I] * 7 + [_P])


def dispatch(top_ids, capacity: int, base: int, count: int):
    """The grouped dispatch of the held experts ``base`` .. ``base + count
    - 1``, in fixed shapes from ``top_ids`` (T, k) alone:

    * ``n`` (count,) int32: the rows of each held expert, its assignments
      kept under ``capacity``;
    * ``table`` (count, capacity) int32: the (token, k) slot ``t k + j``
      of each of an expert's rows, in ``layers.moe_dispatch``'s slot order
      (an assignment's position among the expert's earlier ones in the
      flattened (token, k) order); -1 past ``n``;
    * ``held`` (T, k): the assignment lands on a held expert;
    * ``keep`` (T, k): held and within the expert's capacity."""
    t, k = top_ids.shape
    dev = top_ids.device
    local = top_ids.reshape(-1) - base
    # (count, T k): which assignments each held expert takes, and their
    # running count along the (token, k) order
    mine = local[None, :] == torch.arange(count, device=dev)[:, None]
    seen = mine.cumsum(1)
    pos = (seen * mine).sum(0) - 1                  # -1: not a held expert
    held = pos >= 0
    keep = held & (pos < capacity)
    # each assignment not kept has its own spare entry past the table, so
    # every index is written once
    spare = count * capacity + torch.arange(t * k, device=dev)
    dest = torch.where(keep, local * capacity + pos, spare)
    table = torch.full((count * capacity + t * k,), -1, dtype=torch.int32,
                       device=dev)
    table.scatter_(0, dest, torch.arange(t * k, dtype=torch.int32,
                                         device=dev))
    n = seen[:, -1].clamp(max=capacity).to(torch.int32)
    return (n, table[:count * capacity].view(count, capacity),
            held.view(t, k), keep.view(t, k))


def experts(x, wg, wu, wd, n, table, top_k: int) -> torch.Tensor:
    """Each held expert's SwiGLU on the rows its table names (token ``slot
    // top_k``), written to those rows' slots of a ``(T top_k, d)``
    buffer of zeros."""
    t, d = x.shape
    cap = table.shape[1]
    valid = torch.arange(cap, device=x.device)[None, :] < n[:, None].long()
    rows = table.long().clamp(min=0)
    xe = x.float()[rows // top_k]                            # (count, cap, d)
    h = R.swish(torch.bmm(xe, wg.float())) * torch.bmm(xe, wu.float())
    oe = torch.bmm(h, wd.float())                            # (count, cap, d)
    out = x.new_zeros((t * top_k, d), dtype=torch.float32)
    out[rows[valid]] = oe[valid]
    return out


def combine(slots, top_w, keep) -> torch.Tensor:
    """Each token's kept slots weighted by ``top_w``: ``(T, d)``."""
    t, k = top_w.shape
    w = (top_w * keep).to(slots.dtype)
    return torch.einsum("tkd,tk->td", slots.view(t, k, -1), w)


def plain(x, top_w, top_ids, wg, wu, wd, base: int, capacity: int):
    """The kernel's plain version: ``(out, n, counts)``, the held experts'
    routed output (T, d) in float32, their row counts, and ``counts`` (T
    + 1,): each token's count of its assignments to held experts, then the
    rows the experts computed (``n.sum()``)."""
    n, table, held, keep = dispatch(top_ids, capacity, base, wg.shape[0])
    slots = experts(x, wg, wu, wd, n, table, top_ids.shape[1])
    counts = torch.cat([held.sum(-1), n.sum().reshape(1).long()])
    return combine(slots, top_w, keep), n, counts


def shape_key(x: torch.Tensor, wg: torch.Tensor, top_ids: torch.Tensor,
              capacity: int) -> str:
    """The launch's shape, as ``KERNEL.shapes`` counts it."""
    return (f"x {tuple(x.shape)} W {tuple(wg.shape)} ids "
            f"{tuple(top_ids.shape)} capacity {capacity}")


def grouped_moe_cuda(x, top_w, top_ids, wg, wu, wd, base: int,
                     capacity: int):
    """x: (T, d) normalised tokens; top_w, top_ids: (T, k) routing weights
    and expert ids; wg, wu: (count, d, f), wd: (count, f, d), the experts
    ``base`` .. ``base + count - 1``; ``capacity`` rows an expert.
    Returns :func:`plain`'s ``(out, n, counts)``.  CPU tensors run
    :func:`plain`; CUDA tensors launch the kernel or raise."""
    if x.dim() != 2 or top_ids.dim() != 2 or wg.dim() != 3:
        raise ValueError(f"x {tuple(x.shape)}, ids {tuple(top_ids.shape)}, "
                         f"weights {tuple(wg.shape)}: expected (T, d), "
                         "(T, k), (count, d, f)")
    t, d = x.shape
    k = top_ids.shape[1]
    count, _, f = wg.shape
    if (top_ids.shape[0] != t or top_w.shape != top_ids.shape
            or wg.shape[1] != d or wu.shape != wg.shape
            or wd.shape != (count, f, d) or min(t, k, d, f, capacity) < 1):
        raise ValueError(f"x {tuple(x.shape)}, top_w {tuple(top_w.shape)}, "
                         f"ids {tuple(top_ids.shape)}, wg {tuple(wg.shape)}, "
                         f"wu {tuple(wu.shape)}, wd {tuple(wd.shape)}, "
                         f"capacity {capacity} do not fit together")
    if placement("grouped_experts", x, top_w, top_ids, wg, wu, wd) == "cpu":
        return plain(x, top_w, top_ids, wg, wu, wd, base, capacity)
    if {x.dtype, top_w.dtype, wg.dtype, wu.dtype, wd.dtype} != {
            torch.float32} or top_ids.dtype != torch.int64:
        raise ValueError("the grouped expert kernel takes float32 tokens, "
                         "weights and routing weights and int64 ids")
    if d % 4 or f % 4 or t * k > MAX_TK:
        raise ValueError(f"d {d} and f {f} must be multiples of 4 and T k "
                         f"{t * k} at most {MAX_TK}")
    x, top_w, top_ids, wg, wu, wd = (
        a.contiguous() for a in (x, top_w, top_ids, wg, wu, wd))
    if any(a.data_ptr() % 16 for a in (x, wg, wu, wd)):
        raise ValueError("the grouped expert kernel needs 16-byte aligned "
                         "operands")
    dev = x.device
    n = torch.empty(count, dtype=torch.int32, device=dev)
    table = torch.empty((count, capacity), dtype=torch.int32, device=dev)
    keep = torch.empty((t, k), dtype=torch.bool, device=dev)
    counts = torch.empty(t + 1, dtype=torch.int64, device=dev)
    h = torch.empty((count * capacity, f), dtype=torch.float32, device=dev)
    slots = torch.empty((t * k, d), dtype=torch.float32, device=dev)
    out = torch.empty((t, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        KERNEL.launch(x.data_ptr(), top_w.data_ptr(), top_ids.data_ptr(),
                      wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                      n.data_ptr(), table.data_ptr(), keep.data_ptr(),
                      counts.data_ptr(), h.data_ptr(), slots.data_ptr(),
                      out.data_ptr(), t, k, base, count, capacity, d, f,
                      current_stream(dev),
                      shape=shape_key(x, wg, top_ids, capacity))
    return out, n, counts
