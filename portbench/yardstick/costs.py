"""Operations and bytes of one launch of each hand-written kernel, frozen
here so that a change to the program cannot change the yardstick.

Copied from the port's ``kernels/quant_aggregate.cost`` (B1),
``kernels/rmsnorm.cost`` (B2) and ``kernels/flash_attention.cost`` (B3) as
they stood when the benchmark was defined; each function's arguments are
the key its wrapper's ``launches_by_shape`` counter gives a launch, plus
the element sizes the counter leaves out.
"""
from __future__ import annotations


def quant_aggregate(S: int, C: int, N: int, qblock: int) -> tuple:
    """B1 over S lanes of C clients' N int8 values: 3 operations a value
    (dequantize, weigh, add); the int8 rows, the f32 scales and weights read
    once, the f32 (N,) result written once a lane."""
    return 3 * S * C * N, S * (C * N + 4 * C * (N // qblock) + 4 * C + 4 * N)


def rmsnorm(R: int, D: int, esize: int, w_esize: int) -> tuple:
    """B2 over R rows of D elements of ``esize`` bytes, the weight of
    ``w_esize``: 4 operations an element (square, add, scale, weight), each
    row read and written once and the weight read once."""
    return 4 * R * D, 2 * R * D * esize + D * w_esize


def flash_attention(B: int, Sq: int, Sk: int, H: int, KV: int, Dk: int, Dv: int,
                    q_offset: int, causal: bool, esize: int) -> tuple:
    """B3's forward: 2 (Dk + Dv) operations for each (query, key) pair the
    mask lets through (under a causal mask, q row i at ``q_offset + i`` sees
    keys 0 .. q_offset + i), for every batch row and head; q, out and the
    K/V rows the mask reaches read or written once in elements of
    ``esize`` bytes, and the f32 lse written once."""
    if causal:
        full = min(max(Sk - q_offset, 0), Sq)
        pairs = full * q_offset + full * (full + 1) // 2 + (Sq - full) * Sk
        keys = min(Sk, q_offset + Sq)
    else:
        pairs, keys = Sq * Sk, Sk
    nbytes = (B * Sq * H * (Dk + Dv) + B * keys * KV * (Dk + Dv)) * esize + B * H * Sq * 4
    return 2 * B * H * pairs * (Dk + Dv), nbytes
