"""The chip's published peaks, the denominators of every roofline and
MFU share.

NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense rates without
sparsity, at the full 700 W power limit:

* 495 TFLOP/s TF32 on the tensor cores: the highest rate at which the
  chip takes float32 operands, so no method that keeps float32 accuracy
  can read above 100 % of it (3xTF32 runs at a third of it; plain FP32
  outside the tensor cores is 67 TFLOP/s);
* 3.35 TB/s of HBM3 bandwidth (80 GB).

A card set below 700 W (``nvidia-smi --query-gpu=power.limit``, which
every result line carries in ``device.power_limit_w``) runs slower under
load, so shares are comparable only at one limit.
"""

FLOAT32_FLOPS = 495e12      # TF32 dense, H100 SXM5 data sheet
HBM_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM5 data sheet
POWER_LIMIT_W = 700.0       # the data sheet's rates assume it


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip can take for this work."""
    return max(flops / FLOAT32_FLOPS, nbytes / HBM_BYTES_PER_S)
