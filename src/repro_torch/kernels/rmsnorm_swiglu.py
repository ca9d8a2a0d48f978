"""Fused RMSNorm + FFN-SwiGLU on the card: the port of
``repro.kernels.rmsnorm_swiglu`` (``rmsnorm_swiglu_pallas``).

The kernel is CUDA C++ written by hand, ``csrc/rmsnorm_swiglu.cu``, built
by nvcc for ``sm_90a`` at first use.  Its three products run on the
tensor cores (bfloat16 ``mma.sync``; float32 as 3xTF32).  A block owns
``BM = 32`` rows and takes their RMS statistic in a pre-pass; the d_ff
axis is split over the ranks of a thread-block cluster
(:func:`launch_shape`) and walked in steps of ``BKF = 64`` through a
``cp.async`` ring, the h tile never leaves the chip, and each rank's
partial output of up to ``BN = 576`` columns lives in registers until the
ranks sum their partials in rank order.  The normalised rows stay in
shared memory where they fit (D <= 864 in float32, 1728 in bfloat16: the
faster layout at smollm-135m's widths); at any wider D each step streams
X's columns beside W and V instead, so shared memory does not grow with
D.  A wider N is split across blocks, each recomputing h (the paper's N
replication).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core import cuda_build as CB
from repro_torch.core.runtime import current_stream, placement
from repro_torch.kernels import DTYPE_CODES
from repro_torch.kernels import ref as R

BM, BKF, BN = 32, 64, 576   # rows, d_ff columns a step, output columns
THREADS = 512                # 2 x 8 warps
NSTAGE = 2                   # stages of the cp.async ring
#: rows of W / V and of U a ring chunk, by dtype (the kernel's Tiles)
CHUNKS = {torch.float32: (96, 16), torch.bfloat16: (192, 32)}
SMS = 132                    # streaming multiprocessors of an H100 SXM
MAX_CLUSTER = 8              # ranks of a cluster (the portable size)
SMEM_LIMIT = 232448          # bytes of shared memory a block may use
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CB.csrc_launcher(
    "rmsnorm_swiglu.cu", "rmsnorm_swiglu_fwd",
    [_P] * 6 + [_I] * 4 + [ctypes.c_float] + [_I] * 5 + [_P])


class LaunchShape(NamedTuple):
    cluster: int     # ranks over d_ff
    kslice: int      # d_ff columns a rank (a multiple of BKF)
    grid: tuple      # (cluster, row blocks, column blocks)
    threads: int
    smem: int        # dynamic shared memory of a block, bytes
    panel: bool      # the normalised rows held in shared memory

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(d: int, dtype: torch.dtype = torch.float32,
               panel: bool = False) -> int:
    """Dynamic shared memory of one block: the normalised rows (``panel``:
    D rounded up to a chunk), the ring (a stage holds W and V chunks and,
    streamed, an X chunk and gamma's DC float32 values; or a U chunk) and
    the h tile in the operand's type and the rows' 1/rms; or the rank's
    float32 partial output if larger.  Streamed, it does not depend on
    D."""
    dc, ku = CHUNKS.get(dtype, CHUNKS[torch.float32])
    pad, esize = (8, 2) if dtype == torch.bfloat16 else (4, 4)
    wv = 2 * dc * (BKF + 8)
    if not panel:
        wv += BM * (dc + pad) + dc * 4 // esize
    rows = BM * (_cdiv(d, dc) * dc + pad) if panel else 0
    body = (rows + NSTAGE * max(wv, ku * (BN + 8)) + BM * (BKF + pad)
            ) * esize + BM * 4
    return max(body, BM * (BN + 4) * 4)


def launch_shape(m: int, d: int, k: int, n: int,
                 dtype: torch.dtype) -> LaunchShape:
    """The kernel's launch: as many d_ff ranks (up to 8, each at least one
    64-column step) as keep the blocks within the 132 SMs; the normalised
    rows held in shared memory where they fit."""
    base = _cdiv(m, BM) * _cdiv(n, BN)
    steps = _cdiv(k, BKF)
    cluster = max(1, min(MAX_CLUSTER, steps, SMS // base))
    kslice = _cdiv(steps, cluster) * BKF
    cluster = _cdiv(k, kslice)           # no rank without columns
    panel = smem_bytes(d, dtype, panel=True) <= SMEM_LIMIT
    return LaunchShape(cluster, kslice, (cluster, _cdiv(m, BM), _cdiv(n, BN)),
                       THREADS, smem_bytes(d, dtype, panel), panel)


def plain(x, w, v, u, gamma, *, eps: float = 1e-6, cluster: int = 1,
          kslice: int = 0) -> torch.Tensor:
    """The kernel's plain version: ``kernels.ref.rmsnorm_swiglu_ref`` with
    the d_ff axis cut into ``cluster`` slices of ``kslice`` columns, their
    partial outputs summed in rank order."""
    if cluster == 1:
        return R.rmsnorm_swiglu_ref(x, w, v, u, gamma, eps)
    xn = R.rmsnorm_ref(x, gamma, eps).float()
    out = 0.0
    for k0 in range(0, cluster * kslice, kslice):
        ks = slice(k0, k0 + kslice)
        h = R.swish(xn @ w[:, ks].float()) * (xn @ v[:, ks].float())
        out = out + h @ u[ks].float()
    return out.to(x.dtype)


def shape_key(x: torch.Tensor, w: torch.Tensor, u: torch.Tensor) -> str:
    """The launch's shape, as ``KERNEL.shapes`` counts it."""
    return (f"x {tuple(x.shape)} W/V {tuple(w.shape)} U {tuple(u.shape)} "
            f"{str(x.dtype).removeprefix('torch.')}")


def rmsnorm_swiglu_cuda(x: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                        u: torch.Tensor, gamma: torch.Tensor, *,
                        eps: float = 1e-6) -> torch.Tensor:
    """x: (M, D); w, v: (D, K); u: (K, N); gamma: (D,).  Returns (M, N) in
    x's dtype.  CPU tensors run :func:`plain` with the kernel's split;
    CUDA tensors launch the kernel or raise."""
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
    shape = launch_shape(m, d, k, n, x.dtype)
    if placement("rmsnorm_swiglu", x, w, v, u, gamma) == "cpu":
        return plain(x, w, v, u, gamma, eps=eps, cluster=shape.cluster,
                     kslice=shape.kslice)
    if x.dtype not in DTYPE_CODES or len(
            {t.dtype for t in (x, w, v, u)}) > 1:
        raise ValueError(f"dtypes {x.dtype}, {w.dtype}, {v.dtype}, "
                         f"{u.dtype}: the kernel takes float32 or bfloat16, "
                         "all alike")
    if shape.smem > SMEM_LIMIT:
        raise ValueError(f"D = {d} needs {shape.smem} bytes of shared "
                         f"memory per block, over {SMEM_LIMIT}")
    if shape.grid[1] > 65535 or shape.grid[2] > 65535:
        raise ValueError(f"M = {m}, N = {n} exceed the grid's limits")
    x, w, v, u = (t.contiguous() for t in (x, w, v, u))
    g = gamma.float().contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    per16 = 16 // x.element_size()
    vec = all(t.data_ptr() % 16 == 0 for t in (x, w, v, u, g)) and all(
        s % per16 == 0 for s in (d, k, n))
    with torch.cuda.device(x.device):
        KERNEL.launch(x.data_ptr(), w.data_ptr(), v.data_ptr(),
                      u.data_ptr(), g.data_ptr(), out.data_ptr(), m, d, k, n,
                      float(eps), DTYPE_CODES[x.dtype], shape.cluster,
                      shape.kslice, int(vec), int(shape.panel),
                      current_stream(x.device), shape=shape_key(x, w, u))
    return out
