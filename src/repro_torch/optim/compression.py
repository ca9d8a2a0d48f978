"""int8 gradient compression with a per-tensor scale and error feedback
for a data-parallel gradient mean: the port of ``repro.optim.compression``.

:func:`compressed_psum_mean` quantizes each replica's gradient (plus the
error it carried from the last step) to int8, sums the dequantized
float32 values over the mesh axes' group and divides by its size; the
quantization residual is the next step's error, which keeps the
compression's bias bounded (Seide et al. 2014, Karimireddy et al. 2019).
That is what the reference computes: its docstring's int8 payload on
the wire is not, and the port sends float32 as it does.
``compress_roundtrip_error`` measures what one round trip costs.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum_mean(grads, mesh, axes: Sequence[str] = ("data",),
                         errors: Optional[Any] = None):
    """The mean of every replica's ``grads`` over the mesh ``axes``, each
    leaf sent as its int8 round trip with error feedback (reference
    compression.py:36-67).  ``grads`` and ``errors`` are trees of this
    rank's float32 tensors (``errors`` None: zeros).  Returns ``(synced,
    new_errors)``: per leaf, ``corrected = g + e``, ``synced`` the sum of
    every replica's dequantized ``corrected`` over the group divided by
    its size, ``new_errors`` ``corrected`` minus its own dequantized
    value."""
    from repro_torch.runtime.collectives import axis_group
    from repro_torch.runtime.sharding import axis_size
    if errors is None:
        errors = pytree.tree_map(torch.zeros_like, grads)
    group = axis_group(mesh, tuple(axes))
    n = axis_size(mesh, axes)

    def one(g, e):
        corrected = g + e
        back = dequantize_int8(*quantize_int8(corrected))
        total = back.clone()
        dist.all_reduce(total, group=group)
        return total / n, corrected - back

    flat, spec = pytree.tree_flatten(grads)
    out = [one(g, e) for g, e in zip(flat, pytree.tree_leaves(errors))]
    return (pytree.tree_unflatten([o[0] for o in out], spec),
            pytree.tree_unflatten([o[1] for o in out], spec))


def compress_roundtrip_error(x: torch.Tensor) -> float:
    """Relative L2 error of one int8 round trip of ``x``."""
    q, s = quantize_int8(x)
    back = dequantize_int8(q, s)
    return float(torch.linalg.norm(back - x)
                 / (torch.linalg.norm(x) + 1e-12))
