"""Flash attention forward on the card: the port of
``repro.kernels.flash_attention`` (``flash_attention_pallas``).

The kernel is CUDA C++ written by hand, ``csrc/flash_attention.cu``,
built by nvcc for ``sm_90a`` at first use.  Its products run on the tensor
cores (bfloat16 ``mma.sync``; float32 as 3xTF32), a warp owns 16 query
rows with the online softmax of the paper's appendix in registers, and
the keys stream in tiles of ``BK = 64`` through a ``cp.async`` ring.
Masked scores are ``-1e30`` as in the reference, GQA maps query head ``h``
to KV head ``h // (Hq / Hkv)``, and the causal mask takes a static
``q_offset``, as the reference's kernel does.

Where the query axis gives too few blocks to fill the card,
:func:`launch_shape` shrinks the block to 16 query rows and splits the key
axis over the ranks of a thread-block cluster, which combine their
partials in rank order; :func:`plain` follows the same split.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.core import cuda_build as CB
from repro_torch.core.runtime import current_stream, placement
from repro_torch.kernels import DTYPE_CODES
from repro_torch.kernels import ref as R

BK = 64                      # keys per tile, as in the kernel
HEAD_DIMS = (32, 64, 128)
SMS = 132                    # streaming multiprocessors of an H100 SXM
MAX_SPLIT = 8                # ranks of a cluster (the portable size)
SMEM_LIMIT = 232448          # bytes of shared memory a block may use
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CB.csrc_launcher(
    "flash_attention.cu", "flash_attention_fwd",
    [_P] * 4 + [_I] * 6 + [ctypes.c_float] + [_I] * 6 + [_P])


class LaunchShape(NamedTuple):
    bq: int          # query rows a block: 64 (4 warps) or 16 (1 warp)
    split: int       # ranks of the cluster over the key axis
    chunk: int       # keys a rank (a multiple of 16)
    grid: tuple      # (split, query blocks, B * Hq)
    threads: int
    smem: int        # dynamic shared memory of a block, bytes

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def key_chunk(skv: int, split: int) -> int:
    """Keys a rank of a ``split``-way key split takes: a multiple of 16."""
    return _cdiv(_cdiv(skv, split), 16) * 16


def launch_shape(b: int, hq: int, hkv: int, sq: int, skv: int, dh: int,
                 dtype: torch.dtype) -> LaunchShape:
    """The kernel's launch at these shapes.  64 query rows a block, unless
    the query axis is one warp's 16 rows or less, or the keys are one tile
    and the blocks would not fill the card: then 16.  While the blocks
    still fall short of the 132 SMs, the key axis is split over up to 8
    cluster ranks of at least 16 keys each."""
    bq = 64
    if sq <= 16 or (skv <= BK and b * hq * _cdiv(sq, bq) < SMS):
        bq = 16
    blocks = b * hq * _cdiv(sq, bq)
    split = 1
    if blocks < SMS:
        split = min(MAX_SPLIT, _cdiv(SMS, blocks), _cdiv(skv, 16))
    chunk = key_chunk(skv, split)
    split = _cdiv(skv, chunk)            # no rank without keys
    ld = dh + (8 if dtype == torch.bfloat16 else 4)
    esize = 2 if dtype == torch.bfloat16 else 4
    ring = 2 * 2 * BK * ld * esize
    part = bq * (dh + 6) * 4 if split > 1 else 0
    return LaunchShape(bq, split, chunk, (split, _cdiv(sq, bq), b * hq),
                       bq * 2, max(ring, part))


def plain(q, k, v, *, scale: Optional[float] = None, causal: bool = False,
          q_offset=0, split: int = 1) -> torch.Tensor:
    """The kernel's plain version: the keys split over ``split`` ranks of
    :func:`key_chunk` keys, each rank's online softmax over the same
    64-key tiles, then the ranks' partials combined in rank order, in
    PyTorch."""
    if split == 1:
        return R.attention_chunked(q, k, v, scale=scale, causal=causal,
                                   q_offset=q_offset, block_kv=BK)
    chunk = key_chunk(k.shape[2], split)
    parts = [R.attention_partial(q, k[:, :, k0:k0 + chunk],
                                 v[:, :, k0:k0 + chunk], scale=scale,
                                 causal=causal, q_offset=q_offset,
                                 k_start=k0, block_kv=BK)
             for k0 in range(0, split * chunk, chunk)]
    top = torch.stack([m for m, _, _ in parts]).amax(0)
    den = num = 0.0
    for m, l, acc in parts:
        w = torch.exp(m - top)
        den = den + w * l
        num = num + w * acc
    return (num / den).reshape(*q.shape[:3], v.shape[-1]).to(q.dtype)


def shape_key(q: torch.Tensor, k: torch.Tensor, causal: bool) -> str:
    """The launch's shape, as ``KERNEL.shapes`` counts it."""
    return (f"q {tuple(q.shape)} kv {tuple(k.shape)} "
            f"{str(q.dtype).removeprefix('torch.')}"
            + (" causal" if causal else ""))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the cp.async copies)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: Optional[float] = None,
                         causal: bool = False, q_offset: int = 0
                         ) -> torch.Tensor:
    """q: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh).  Returns (B, Hq, Sq,
    Dh) in q's dtype.  CPU tensors run :func:`plain` with the kernel's
    split; CUDA tensors launch the kernel or raise."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if placement("flash_attention", q, k, v) == "cpu":
        split = launch_shape(b, hq, hkv, sq, skv, dh, q.dtype).split
        return plain(q, k, v, scale=scale, causal=causal, q_offset=q_offset,
                     split=split)
    if not isinstance(q_offset, int):
        raise TypeError("the flash attention kernel takes a static int "
                        "q_offset, as the reference's kernel does "
                        f"(flash_attention.py:44-48); got {type(q_offset)}")
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} differs from k "
                         f"{tuple(k.shape)}")
    if hq % hkv or min(b, sq, skv) < 1:
        raise ValueError(f"bad attention shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh}: the kernel takes {HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES or {k.dtype, v.dtype} != {q.dtype}:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the "
                         "kernel takes float32 or bfloat16, all alike")
    if b * hq > 65535:
        raise ValueError(f"B * Hq = {b * hq} exceeds the grid's z limit")
    shape = launch_shape(b, hq, hkv, sq, skv, dh, q.dtype)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    scale = 1.0 / dh ** 0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, hq, hkv, sq, skv, dh, scale,
                      int(causal), q_offset, DTYPE_CODES[q.dtype], shape.bq,
                      shape.split, shape.chunk, current_stream(q.device),
                      shape=shape_key(q, k, causal))
    return out
