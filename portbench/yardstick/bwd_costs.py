"""Operations and bytes of one call of B3's and B2's backward, frozen here
so that a change to the program cannot change the yardstick. Each
function's arguments are the ``shape`` that the program's ``attn.bwd`` and
``rmsnorm.bwd`` layer spans carry (the call's shape after the vmap fold,
with its element sizes). The count is the work the gradient needs, whatever
implements it: the torch ops of today or a hand-written kernel.
"""
from __future__ import annotations

from portbench.yardstick import peaks


def causal_pairs(Sq: int, Sk: int, q_offset: int) -> int:
    """(query, key) pairs a causal mask lets through: q row i, at
    ``q_offset + i``, sees keys 0 .. q_offset + i."""
    full = min(max(Sk - q_offset, 0), Sq)          # rows whose keys end inside Sk
    return full * q_offset + full * (full + 1) // 2 + (Sq - full) * Sk


def flash_attention_bwd(B: int, Sq: int, Sk: int, H: int, KV: int, Dk: int, Dv: int,
                        causal: bool, q_offset: int, esize: int) -> tuple:
    """B3's backward: five products for each pair the mask lets through, for
    every batch row and head: the scores again (Q K^T, Dk), dP = dO V^T
    (Dv), dV = P^T dO (Dv), dQ = dS K (Dk) and dK = dS^T Q (Dk), so
    2 (3 Dk + 2 Dv) operations a pair. q, out, dout, dq and the K/V rows the
    mask reaches with dk and dv moved once in elements of ``esize`` bytes;
    the forward's f32 lse read once."""
    if causal:
        pairs, keys = causal_pairs(Sq, Sk, q_offset), min(Sk, q_offset + Sq)
    else:
        pairs, keys = Sq * Sk, Sk
    ops = 2 * B * H * pairs * (3 * Dk + 2 * Dv)
    nbytes = (2 * B * Sq * H * (Dk + Dv) + 2 * B * keys * KV * (Dk + Dv)) * esize \
        + 4 * B * H * Sq
    return ops, nbytes


def rmsnorm_bwd(R: int, D: int, esize: int, w_esize: int) -> tuple:
    """B2's backward over R rows of D: 11 operations an element (the row's
    mean square and rsqrt, xhat, g w, the row's mean of g w xhat, dx, and
    g xhat summed into dw); x and g read and dx written in elements of
    ``esize`` bytes, w read and dw written once in ``w_esize``."""
    return 11 * R * D, 3 * R * D * esize + 2 * D * w_esize


def attn_bwd_least_s(precision: str):
    """``least(shape, count)``: the least seconds of ``count`` calls at an
    ``attn.bwd`` span's shape, at the card's roofline in ``precision``."""
    def least(shape, n):
        return n * peaks.least_seconds(*flash_attention_bwd(*shape), precision)
    return least


def rmsnorm_bwd_least_s(shape, n):
    """The least seconds of ``n`` calls at an ``rmsnorm.bwd`` span's shape
    (memory-bound: the bf16 rate never binds)."""
    return n * peaks.least_seconds(*rmsnorm_bwd(*shape), "bf16")
