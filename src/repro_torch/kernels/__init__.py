"""The paper's three hand-written fused kernels (Examples 1-3) as CUDA
C++ for Hopper (``csrc/*.cu``), their plain PyTorch versions (``ref``),
and the dispatching API (``ops``): the port of ``repro.kernels``."""

import torch

#: the dtypes the hand-written kernels take, as the ``int bf16`` argument
#: of their C entries
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
