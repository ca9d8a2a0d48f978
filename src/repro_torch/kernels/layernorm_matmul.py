"""Fused LayerNorm + matmul on the card: the port of
``repro.kernels.layernorm_matmul`` (``layernorm_matmul_pallas``).

The kernel is CUDA C++ written by hand, ``csrc/layernorm_matmul.cu``,
built by nvcc for ``sm_90a`` at first use.  A block owns a ``BM x BN =
64 x 64`` output tile and walks K in steps of ``BK = 16``, carrying the
reference kernel's four statistic accumulators (row sum, row sum of
squares, ``colsum(gamma * Y)``, ``beta @ Y``) across the steps, and folds
them into the matmul accumulator in its epilogue.  Unlike the reference
kernel it takes any K: the statistics cover the whole row by construction.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import cuda_build as CB
from repro_torch.core.runtime import current_stream, placement
from repro_torch.kernels import DTYPE_CODES

BM = 64                      # rows per block, as in the kernel
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CB.csrc_launcher(
    "layernorm_matmul.cu", "layernorm_matmul_fwd",
    [_P] * 5 + [_I] * 3 + [ctypes.c_float, _I, _P])


def plain(x, y, gamma, beta, *, eps: float = 1e-5) -> torch.Tensor:
    """The kernel's plain version: the reference kernel's arithmetic
    (layernorm_matmul.py:31-62) in PyTorch — one-pass variance ``s2/K -
    mu^2`` and the affine fold ``(X(gamma Y) - mu colsum(gamma Y)) istd +
    beta Y`` — where ``kernels.ref.layernorm_matmul_ref`` normalises
    first, with a two-pass variance."""
    xf, yf = x.float(), y.float()
    kdim = x.shape[-1]
    yg = gamma.float()[:, None] * yf
    mu = xf.sum(-1, keepdim=True) / kdim
    var = (xf * xf).sum(-1, keepdim=True) / kdim - mu * mu
    z = (xf @ yg - mu * yg.sum(0)) * torch.rsqrt(var + eps) \
        + beta.float() @ yf
    return z.to(x.dtype)


def layernorm_matmul_cuda(x: torch.Tensor, y: torch.Tensor,
                          gamma: torch.Tensor, beta: torch.Tensor, *,
                          eps: float = 1e-5) -> torch.Tensor:
    """x: (M, K); y: (K, N); gamma, beta: (K,).  Returns LN(x) @ y, (M, N)
    in x's dtype.  CPU tensors run :func:`plain`; CUDA tensors launch the
    kernel or raise."""
    if placement("layernorm_matmul", x, y, gamma, beta) == "cpu":
        return plain(x, y, gamma, beta, eps=eps)
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
    if x.dtype not in DTYPE_CODES or y.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}, {y.dtype}: the kernel takes "
                         "float32 or bfloat16, both alike")
    if -(-m // BM) > 65535:
        raise ValueError(f"M = {m} exceeds the grid's y limit")
    x, y = x.contiguous(), y.contiguous()
    g, b = gamma.float().contiguous(), beta.float().contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        KERNEL.launch(x.data_ptr(), y.data_ptr(), g.data_ptr(), b.data_ptr(),
                      out.data_ptr(), m, kdim, n, float(eps),
                      DTYPE_CODES[x.dtype], current_stream(x.device))
    return out
