"""Flash attention forward on the card: the port of
``repro.kernels.flash_attention`` (``flash_attention_pallas``).

The kernel is CUDA C++ written by hand, ``csrc/flash_attention.cu``,
built by nvcc for ``sm_90a`` at first use.  One block of 256 threads owns
``BQ = 64`` query rows of one head and walks the keys in tiles of ``BK =
64`` with the online softmax of the paper's appendix; masked scores are
``-1e30`` as in the reference, GQA maps query head ``h`` to KV head ``h //
(Hq / Hkv)``, and the causal mask takes a static ``q_offset``, as the
reference's kernel does.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import cuda_build as CB
from repro_torch.core.runtime import current_stream, placement
from repro_torch.kernels import DTYPE_CODES
from repro_torch.kernels import ref as R

BK = 64                      # keys per tile, as in the kernel
HEAD_DIMS = (32, 64, 128)
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CB.csrc_launcher(
    "flash_attention.cu", "flash_attention_fwd",
    [_P] * 4 + [_I] * 6 + [ctypes.c_float, _I, _I, _I, _P])


def plain(q, k, v, *, scale: Optional[float] = None, causal: bool = False,
          q_offset=0) -> torch.Tensor:
    """The kernel's plain version: the same online softmax over the same
    64-key tiles, in PyTorch."""
    return R.attention_chunked(q, k, v, scale=scale, causal=causal,
                               q_offset=q_offset, block_kv=BK)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: Optional[float] = None,
                         causal: bool = False, q_offset: int = 0
                         ) -> torch.Tensor:
    """q: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh).  Returns (B, Hq, Sq,
    Dh) in q's dtype.  CPU tensors run :func:`plain`; CUDA tensors launch
    the kernel or raise."""
    if placement("flash_attention", q, k, v) == "cpu":
        return plain(q, k, v, scale=scale, causal=causal, q_offset=q_offset)
    if not isinstance(q_offset, int):
        raise TypeError("the flash attention kernel takes a static int "
                        "q_offset, as the reference's kernel does "
                        f"(flash_attention.py:44-48); got {type(q_offset)}")
    b, hq, sq, dh = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    hkv, skv = k.shape[1], k.shape[2]
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
        raise ValueError(f"B * Hq = {b * hq} exceeds the grid's y limit")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    scale = 1.0 / dh ** 0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, hq, hkv, sq, skv, dh, scale,
                      int(causal), q_offset, DTYPE_CODES[q.dtype],
                      current_stream(q.device))
    return out
