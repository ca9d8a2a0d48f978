"""Fused RMSNorm + FFN-SwiGLU on the card: the port of
``repro.kernels.rmsnorm_swiglu`` (``rmsnorm_swiglu_pallas``).

The kernel is CUDA C++ written by hand, ``csrc/rmsnorm_swiglu.cu``, built
by nvcc for ``sm_90a`` at first use.  A block owns ``BM = 16`` rows: their
RMS-normalised rows stay in shared memory, the d_ff dimension is streamed
in steps of ``BK = 64`` (the paper's serial K map) with W/V tiles of
``DC = 32`` rows of D, the h tile never leaves the chip, and the output
accumulator of up to ``BN = 1024`` columns lives in registers.  A wider N
is split across blocks, each recomputing h (the paper's N replication);
N <= 1024 has none.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import cuda_build as CB
from repro_torch.core.runtime import current_stream, placement
from repro_torch.kernels import DTYPE_CODES
from repro_torch.kernels import ref as R

BM, BK, DC = 16, 64, 32      # the kernel's tiles
SMEM_LIMIT = 232448          # bytes of shared memory a block may use
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CB.csrc_launcher(
    "rmsnorm_swiglu.cu", "rmsnorm_swiglu_fwd",
    [_P] * 6 + [_I] * 4 + [ctypes.c_float, _I, _P])


def smem_bytes(d: int) -> int:
    """Dynamic shared memory of one block: the normalised rows, the W/V
    tiles, the h tile and the row statistics, float32."""
    return 4 * (BM * d + 2 * DC * BK + BM * BK + BM)


def plain(x, w, v, u, gamma, *, eps: float = 1e-6) -> torch.Tensor:
    """The kernel's plain version (``kernels.ref.rmsnorm_swiglu_ref``)."""
    return R.rmsnorm_swiglu_ref(x, w, v, u, gamma, eps)


def rmsnorm_swiglu_cuda(x: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                        u: torch.Tensor, gamma: torch.Tensor, *,
                        eps: float = 1e-6) -> torch.Tensor:
    """x: (M, D); w, v: (D, K); u: (K, N); gamma: (D,).  Returns (M, N) in
    x's dtype.  CPU tensors run :func:`plain`; CUDA tensors launch the
    kernel or raise."""
    if placement("rmsnorm_swiglu", x, w, v, u, gamma) == "cpu":
        return plain(x, w, v, u, gamma, eps=eps)
    if x.dim() != 2:
        raise ValueError(f"x must be (M, D), got {tuple(x.shape)}")
    m, d = x.shape
    if w.dim() != 2 or w.shape[0] != d or v.shape != w.shape:
        raise ValueError(f"w {tuple(w.shape)} and v {tuple(v.shape)} must "
                         f"be ({d}, K)")
    k = w.shape[1]
    if u.dim() != 2 or u.shape[0] != k or gamma.shape != (d,):
        raise ValueError(f"u {tuple(u.shape)} must be ({k}, N) and gamma "
                         f"{tuple(gamma.shape)} ({d},)")
    n = u.shape[1]
    if min(m, d, k, n) < 1:
        raise ValueError("empty operand")
    if x.dtype not in DTYPE_CODES or len(
            {t.dtype for t in (x, w, v, u)}) > 1:
        raise ValueError(f"dtypes {x.dtype}, {w.dtype}, {v.dtype}, "
                         f"{u.dtype}: the kernel takes float32 or bfloat16, "
                         "all alike")
    if smem_bytes(d) > SMEM_LIMIT:
        raise ValueError(f"D = {d} needs {smem_bytes(d)} bytes of shared "
                         f"memory per block, over {SMEM_LIMIT}")
    x, w, v, u = (t.contiguous() for t in (x, w, v, u))
    g = gamma.float().contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        KERNEL.launch(x.data_ptr(), w.data_ptr(), v.data_ptr(),
                      u.data_ptr(), g.data_ptr(), out.data_ptr(), m, d, k, n,
                      float(eps), DTYPE_CODES[x.dtype],
                      current_stream(x.device))
    return out
