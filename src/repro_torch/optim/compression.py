"""int8 gradient compression with a per-tensor scale: the port of
``repro.optim.compression`` for one device.

``quantize_int8`` / ``dequantize_int8`` are the payload a data-parallel
sync would all-reduce; ``compress_roundtrip_error`` measures what one
round trip costs.  The reference's ``compressed_psum_mean`` (the
all-reduce of the int8 payloads with error feedback) needs a device mesh
and waits for the port's multi-device slice.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_roundtrip_error(x: torch.Tensor) -> float:
    """Relative L2 error of one int8 round trip of ``x``."""
    q, s = quantize_int8(x)
    back = dequantize_int8(q, s)
    return float(torch.linalg.norm(back - x)
                 / (torch.linalg.norm(x) + 1e-12))
