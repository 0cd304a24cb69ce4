"""Published peaks of the card the benchmark runs on.

Source: NVIDIA H100 Tensor Core GPU data sheet, the SXM5 part, dense rates
(without structured sparsity), at the board's full 700 W limit. A card set
to a lower power limit runs slower under load, so every share of a peak is
printed with the card's power limit beside it.
"""
from __future__ import annotations

SOURCE = "NVIDIA H100 Tensor Core GPU data sheet, SXM5, dense, 700 W"

FLOPS_PER_S = {
    "bf16": 989e12,     # tensor cores, bf16 and fp16
    "tf32": 494.7e12,   # tensor cores, TF32
    "f32": 67e12,       # CUDA cores, float32 outside the tensor cores
}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: float, nbytes: float, precision: str) -> float:
    """The least time the card could take for ``ops`` operations and
    ``nbytes`` bytes: the larger of the compute and the memory bound."""
    return max(ops / FLOPS_PER_S[precision], nbytes / HBM_BYTES_PER_S)
