"""Where a CUDA kernel of the port runs, emitted or hand-written: one
placement rule for all of them, and PyTorch's current stream."""

from __future__ import annotations

import torch


def placement(what: str, *tensors: torch.Tensor) -> str:
    """``"cpu"`` or ``"cuda"``: where all of a kernel's tensors lie.  On
    the CPU a kernel runs its plain version; on the card it launches or
    raises.  Tensors on both, or elsewhere, are refused."""
    kinds = {t.device.type for t in tensors}
    if len(kinds) == 1 and kinds <= {"cpu", "cuda"}:
        return kinds.pop()
    raise ValueError(f"{what}: inputs on {sorted(kinds)}; the kernel takes "
                     "CUDA tensors only (CPU tensors run its plain version)")


def current_device() -> int:
    """The index of the current CUDA device (CUDA initialised: a CUDA
    tensor exists)."""
    return torch._C._cuda_getDevice()


def current_stream(device) -> int:
    """PyTorch's current CUDA stream on ``device`` (a ``torch.device`` or
    an index), as a pointer: the raw query the launch paths take, without
    building a ``torch.cuda.Stream``."""
    index = device if isinstance(device, int) else device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
