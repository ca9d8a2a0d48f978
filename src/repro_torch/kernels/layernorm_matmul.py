"""Fused LayerNorm + matmul on the card: the port of
``repro.kernels.layernorm_matmul`` (``layernorm_matmul_pallas``).

The kernel is CUDA C++ written by hand, ``csrc/layernorm_matmul.cu``,
built by nvcc for ``sm_90a`` at first use.  Its products run on the tensor
cores (float32 as 3xTF32; bfloat16 as two passes over ``hi(gamma Y)`` and
``lo(gamma Y)``).  A block owns a ``BM x 64`` output tile and walks K in
steps of ``BK = 32`` through a ``cp.async`` ring, carrying the reference
kernel's four statistic accumulators (row sum, row sum of squares,
``colsum(gamma * Y)``, ``beta @ Y``) and folding them into the product in
its epilogue.  :func:`launch_shape` takes the tallest block whose tiles,
with K split over the ranks of a thread-block cluster where they are too
few, fill the card; the ranks sum their partials in rank order, and
:func:`plain` follows the same split.  Unlike the reference kernel it
takes any K: the statistics cover the whole row by construction.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core import cuda_build as CB
from repro_torch.core.runtime import current_stream, placement
from repro_torch.kernels import DTYPE_CODES

BN, BK = 64, 32              # output columns a block, K a ring stage
BMS = (128, 64, 32)          # rows a block (BM / 32 x 2 warps of 32 x 32),
                             # in the order launch_shape tries them
NSTAGE = 3                   # stages of the cp.async ring
SMS = 132                    # streaming multiprocessors of an H100 SXM
MAX_SPLIT = 8                # ranks of a cluster (the portable size)
SMEM_LIMIT = 232448          # bytes of shared memory a block may use
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CB.csrc_launcher(
    "layernorm_matmul.cu", "layernorm_matmul_fwd",
    [_P] * 5 + [_I] * 3 + [ctypes.c_float] + [_I] * 5 + [_P])


class LaunchShape(NamedTuple):
    bm: int          # rows a block: 128, 64 or 32
    split: int       # ranks of the cluster over K
    kslice: int      # K columns a rank (a multiple of BK)
    grid: tuple      # (split, row blocks, column blocks)
    threads: int
    smem: int        # dynamic shared memory of a block, bytes

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def k_slice(k: int, split: int) -> int:
    """K columns a rank of a ``split``-way K split takes: a multiple of
    ``BK``."""
    return _cdiv(_cdiv(k, BK), split) * BK


def smem_bytes(bm: int, dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of one block (the kernel's ``Tiles::SMEM``):
    the ring (or the rank's float32 partial output, if larger), the split
    ``gamma * Y`` of a step, then the statistics' partials."""
    bf = dtype == torch.bfloat16
    esize = 2 if bf else 4
    stage = (bm * (BK + (8 if bf else 4)) + BK * (BN + 8)) * esize + 8 * BK
    ring = max(NSTAGE * stage, bm * (BN + 4) * 4)
    split_y = 2 * BK * (BN + 8) * 2 if bf else BK * (BN + 4) * 8
    stats = 2 * 2 * bm + 2 * (bm // 32) * BN + 2 * (2 * bm + 2 * BN)
    return ring + split_y + 4 * stats


def launch_shape(m: int, k: int, n: int, dtype: torch.dtype) -> LaunchShape:
    """The kernel's launch at these shapes: the tallest of :data:`BMS`
    (no taller than M rounded up to a power of two, 32 at least) whose
    blocks reach the 132 SMs once K is split over at most 8 cluster ranks
    of at least one ``BK`` step each, with as few ranks as reach them;
    failing all, 32 rows over as many ranks as K allows.  Tall blocks
    over a K split beat short ones at whisper's decoder shape
    (``launch/hand_variants.py``)."""
    nb, steps = _cdiv(n, BN), _cdiv(k, BK)
    cap = 32
    while cap < min(m, BMS[0]):
        cap *= 2
    for bm in (b for b in BMS if b <= cap):
        need = _cdiv(SMS, _cdiv(m, bm) * nb)
        if need <= min(MAX_SPLIT, steps):
            break
    else:
        need = min(MAX_SPLIT, steps)
    kslice = k_slice(k, need)
    split = _cdiv(k, kslice)             # no rank without columns
    return LaunchShape(bm, split, kslice, (split, _cdiv(m, bm), nb), 2 * bm,
                       smem_bytes(bm, dtype))


def plain(x, y, gamma, beta, *, eps: float = 1e-5,
          split: int = 1) -> torch.Tensor:
    """The kernel's plain version: the reference kernel's arithmetic
    (layernorm_matmul.py:31-62) in PyTorch — one-pass variance ``s2/K -
    mu^2`` and the affine fold ``(X(gamma Y) - mu colsum(gamma Y)) istd +
    beta Y`` — where ``kernels.ref.layernorm_matmul_ref`` normalises
    first, with a two-pass variance.  K is cut into ``split`` slices of
    :func:`k_slice` columns, whose partial product and statistics are
    summed in rank order, as the kernel's cluster ranks sum theirs."""
    xf, yf = x.float(), y.float()
    kdim = x.shape[-1]
    yg = gamma.float()[:, None] * yf
    bt = beta.float()
    step = k_slice(kdim, split) if split > 1 else kdim
    acc = s1 = s2 = ys = yb = 0.0
    for k0 in range(0, kdim, step):
        ks = slice(k0, k0 + step)
        xk = xf[..., ks]
        acc = acc + xk @ yg[ks]
        s1 = s1 + xk.sum(-1, keepdim=True)
        s2 = s2 + (xk * xk).sum(-1, keepdim=True)
        ys = ys + yg[ks].sum(0)
        # (1, K) @ (K, N): a 1-D matmul squeezes its product in place,
        # which selective recompute (remat_policy "dots") refuses
        yb = yb + (bt[ks][None] @ yf[ks])[0]
    mu = s1 / kdim
    var = s2 / kdim - mu * mu
    z = (acc - mu * ys) * torch.rsqrt(var + eps) + yb
    return z.to(x.dtype)


def shape_key(x: torch.Tensor, y: torch.Tensor) -> str:
    """The launch's shape, as ``KERNEL.shapes`` counts it."""
    return (f"x {tuple(x.shape)} Y {tuple(y.shape)} "
            f"{str(x.dtype).removeprefix('torch.')}")


def layernorm_matmul_cuda(x: torch.Tensor, y: torch.Tensor,
                          gamma: torch.Tensor, beta: torch.Tensor, *,
                          eps: float = 1e-5) -> torch.Tensor:
    """x: (M, K); y: (K, N); gamma, beta: (K,).  Returns LN(x) @ y, (M, N)
    in x's dtype.  CPU tensors run :func:`plain` with the kernel's split;
    CUDA tensors launch the kernel or raise."""
    if x.dim() != 2 or y.dim() != 2 or y.shape[0] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} must "
                         "be (M, K) and (K, N)")
    m, kdim = x.shape
    n = y.shape[1]
    if gamma.shape != (kdim,) or beta.shape != (kdim,):
        raise ValueError(f"gamma {tuple(gamma.shape)} and beta "
                         f"{tuple(beta.shape)} must be ({kdim},)")
    if min(m, kdim, n) < 1:
        raise ValueError("empty operand")
    shape = launch_shape(m, kdim, n, x.dtype)
    if placement("layernorm_matmul", x, y, gamma, beta) == "cpu":
        return plain(x, y, gamma, beta, eps=eps, split=shape.split)
    if x.dtype not in DTYPE_CODES or y.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}, {y.dtype}: the kernel takes "
                         "float32 or bfloat16, both alike")
    if shape.grid[1] > 65535 or shape.grid[2] > 65535:
        raise ValueError(f"M = {m}, N = {n} exceed the grid's limits")
    x, y = x.contiguous(), y.contiguous()
    g, b = gamma.float().contiguous(), beta.float().contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    per16 = 16 // x.element_size()
    vec = all(t.data_ptr() % 16 == 0 for t in (x, y, g, b)) and \
        kdim % per16 == 0 and n % per16 == 0
    with torch.cuda.device(x.device):
        KERNEL.launch(x.data_ptr(), y.data_ptr(), g.data_ptr(), b.data_ptr(),
                      out.data_ptr(), m, kdim, n, float(eps),
                      DTYPE_CODES[x.dtype], shape.bm, shape.split,
                      shape.kslice, int(vec), current_stream(x.device),
                      shape=shape_key(x, y))
    return out
