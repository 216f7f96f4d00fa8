"""The card's published peaks and the least time a call could take.

NVIDIA H100 SXM data sheet, dense rates at the 700 W limit: 3.35 TB/s of
HBM3, 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32 outside
them. A card set below 700 W runs slower under load, so every share of
these peaks is printed beside the card's power limit.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """The larger of the bytes over the bandwidth and the operations over
    the dense peak of ``dtype``, in seconds."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype])

