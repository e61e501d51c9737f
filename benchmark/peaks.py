"""The card's published peaks and the least time of a piece of work.

NVIDIA H100 SXM (80 GB HBM3), dense rates without sparsity, at the full
700 W power limit: 67 TFLOP/s in float32 outside the tensor cores, 989
TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM. The result line
names the card and its power limit beside every share of these.
"""

from __future__ import annotations

F32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES = 3.35e12

PEAK_FLOPS = {"float32": F32_FLOPS, "bfloat16": BF16_FLOPS}
BYTES = {"float32": 4, "bfloat16": 2}


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The larger of the operations over the dtype's peak and the bytes
    over the memory rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES)
