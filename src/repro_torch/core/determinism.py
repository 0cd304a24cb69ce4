"""Seed derivation and counter-based draws for the port (port of
``repro/core/determinism.py``).

The JAX package keys every draw with threefry ``fold_in`` chains; here a key
is a 64-bit integer and ``fold_in`` is splitmix64 over ``(parent, index)``.
The function names and tags (0x11C client, 0x57E step, 0xBA7C batch, 0xC047
cohort) are the JAX package's, so each draw is keyed by the same
``(seed, absolute round[, client, step])`` coordinates, and a run chunked
into launches draws exactly what an unchunked run draws.

Keys are Python ints on the host and int64 tensors on a device (the same 64
bits, read as signed); ``fold_in`` and the keys derived with it take either,
so a campaign's per-lane keys are device tensors that a vmap over the lanes
carries. The draws on the device are counter-based: the value
at ``(key, i)`` is the i-th output of the splitmix64 stream seeded with
``key`` (``draw_bits``), computed with int64 tensor ops, so it is the same
on the CPU and on the card, and a draw for one client is by construction
lane ``c`` of the draw for all clients. ``uniform_index`` turns those bits
into batch positions and ``normal`` into Gaussians (Box-Muller from
correctly rounded operations only, so the same bits on any CPU and the
card too).

This does NOT reproduce ``jax.random``'s bits: the two packages draw
different batches, noise and cohorts from the same seed. Parity tests feed
both packages the same numpy inputs instead.
"""
from __future__ import annotations

import math
from fractions import Fraction

import torch

_MASK = (1 << 64) - 1
_GAMMA = 0x9E3779B97F4A7C15
_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB


def _mix(z: int) -> int:
    """splitmix64 finalizer: a bijective avalanche on 64-bit words."""
    z = (z + _GAMMA) & _MASK
    z = ((z ^ (z >> 30)) * _M1) & _MASK
    z = ((z ^ (z >> 27)) * _M2) & _MASK
    return z ^ (z >> 31)


def signed(z: int) -> int:
    """A 64-bit key as the int64 value with the same bits."""
    z &= _MASK
    return z - (1 << 64) if z >> 63 else z


def fold_in(key, data):
    """A child key of ``key`` for the integer ``data``. Either may be an
    int64 tensor (a campaign's per-lane keys, an async lane's client): the
    same bits as on Python ints."""
    if isinstance(data, torch.Tensor):
        return fold_in_tensor(key, data)
    if isinstance(key, torch.Tensor):
        return fold_in_tensor(key, torch.as_tensor(
            signed(int(data)), dtype=torch.int64, device=key.device))
    return _mix(key ^ _mix(int(data) & _MASK))


def root_keys(seeds, device) -> torch.Tensor:
    """(S,) int64: ``root_key(seed)`` of every seed, on ``device``."""
    return torch.tensor([signed(root_key(s)) for s in seeds],
                        dtype=torch.int64, device=device)


def root_key(seed: int) -> int:
    """Root key for a run, derived from the job seed alone."""
    return _mix(int(seed) & _MASK)


def round_key(key: int, round_idx: int) -> int:
    """Per-round key: the root key folded with the absolute round index."""
    return fold_in(key, round_idx)


def client_key(key: int, client_id: int) -> int:
    """Per-client key derived from a round key (tag 0x11C)."""
    return fold_in(fold_in(key, 0x11C), client_id)


def step_key(key: int, step: int) -> int:
    """Per-local-step key derived from a client key (tag 0x57E)."""
    return fold_in(fold_in(key, 0x57E), step)


def batch_key(round_key_: int, client_id: int) -> int:
    """Key for a client's batch draw in one round (tag 0xBA7C)."""
    return fold_in(fold_in(round_key_, 0xBA7C), client_id)


def cohort_key(seed: int, round_idx: int) -> int:
    """Key for cohort selection / fault outcomes in one round (tag 0xC047)."""
    return fold_in(fold_in(root_key(0xC047), seed), round_idx)


def generator(key: int, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``key`` (initial
    weights only; every per-round draw is counter-based)."""
    g = torch.Generator(device=device)
    g.manual_seed(key & ((1 << 63) - 1))
    return g


# -- the same derivations on int64 tensors --------------------------------

def _srl(x, k: int):
    """Logical right shift of an int64 tensor (``>>`` is arithmetic)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def mix_tensor(z):
    """``_mix`` on an int64 tensor; products wrap modulo 2**64."""
    z = z + signed(_GAMMA)
    z = (z ^ _srl(z, 30)) * signed(_M1)
    z = (z ^ _srl(z, 27)) * signed(_M2)
    return z ^ _srl(z, 31)


def fold_in_tensor(key, data):
    """``fold_in`` of a key (a Python int or an int64 tensor) with an int64
    tensor of indices: the child keys, as int64, bit for bit ``fold_in``."""
    k = signed(key) if isinstance(key, int) else key
    return mix_tensor(k ^ mix_tensor(data))


def client_keys(round_key_: int, n_clients: int, device, first: int = 0) -> torch.Tensor:
    """(C,) int64: ``client_key(round_key_, c)`` for the clients c =
    ``first`` .. ``first + n_clients - 1`` (a mesh rank's clients start at
    its grid position times their count)."""
    ids = torch.arange(first, first + n_clients, dtype=torch.int64, device=device)
    return fold_in_tensor(fold_in(round_key_, 0x11C), ids)


def batch_keys(round_key_: int, n_clients: int, device) -> torch.Tensor:
    """(C,) int64: ``batch_key(round_key_, c)`` for every client c."""
    ids = torch.arange(n_clients, dtype=torch.int64, device=device)
    return fold_in_tensor(fold_in(round_key_, 0xBA7C), ids)


def key_tensor(key, device) -> torch.Tensor:
    """(1,) int64 holding ``key`` (a Python int, filled on the device with no
    host copy, or a 0-d int64 tensor)."""
    if isinstance(key, torch.Tensor):
        return key.reshape(1)
    return torch.full((1,), signed(key), dtype=torch.int64, device=device)


def draw_bits(keys, counters):
    """The ``counters``-th outputs of the splitmix64 streams seeded with
    ``keys`` (an int, or an int64 tensor broadcasting against
    ``counters``): ``_mix(key + i * gamma)`` as int64."""
    k = signed(keys) if isinstance(keys, int) else keys
    return mix_tensor(counters * signed(_GAMMA) + k)


def uniform_index(keys, counters, n):
    """Positions in ``[0, n)`` from the high 32 bits of ``draw_bits``:
    ``(hi * n) >> 32``, exact in int64 for ``n < 2**31``."""
    return (_srl(draw_bits(keys, counters), 32) * n) >> 32


# log(u1): fdlibm's split of ln 2 (``ln2_hi`` has 32 trailing zero bits, so
# ``e * ln2_hi`` is exact for any |e| < 2**20) and the Taylor coefficients
# 2 / (2k + 1) of ``log(1 + f) = 2s + s * R(s**2)``, ``s = f / (2 + f)``:
# |s| < 0.1716 on the folded mantissa, and 11 terms leave under 1e-19.
_LN2_HI = 6.93147180369123816490e-01
_LN2_LO = 1.90821492927058770002e-10
_SQRT2 = 1.4142135623730951
_LOG_R = tuple(float(Fraction(2, 2 * k + 1)) for k in range(1, 12))
# cos(2 pi u2): the angle within an octant, t = a * (pi/2) / 2**22 for an
# integer a <= 2**21, so t <= pi/4; Taylor coefficients (-1)**n / (2n)! and
# (-1)**n / (2n + 1)!, terms up to t**20 and t**21 (the next under 1e-19).
_QUARTER_STEP = (math.pi / 2) * 2.0 ** -22
_COS_C = tuple(float(Fraction((-1) ** n, math.factorial(2 * n))) for n in range(11))
_SIN_C = tuple(float(Fraction((-1) ** n, math.factorial(2 * n + 1))) for n in range(1, 11))


def _horner(z, coeffs):
    """``c0 + z * (c1 + z * (c2 + ...))``: one multiply and one add a term,
    each its own rounded op."""
    p = torch.full_like(z, coeffs[-1])
    for c in reversed(coeffs[:-1]):
        p = p * z
        p = p + c
    return p


def _log_u1(k):
    """f64 ``log((k + 1) * 2**-24)`` for int64 ``k`` in [0, 2**24), from
    correctly rounded operations only (see ``normal``): within one f64 ulp
    of the true value.

    ``k + 1 = m * 2**e`` with ``m`` in [sqrt(1/2), sqrt(2)) (``frexp`` and
    a fold, exact); ``log u1 = (e - 24) * ln2 + log m``, the exponent
    offset taken in integers, ``e * ln2`` in Cody-Waite hi/lo parts, and
    ``log m = log(1 + f)`` in fdlibm's arrangement ``f - (hfsq - (s * (hfsq
    + R) + e * ln2_lo))`` with ``hfsq = f*f/2`` and ``R`` a Taylor series
    in ``s**2``. ``f = m - 1`` and ``2 + f`` are exact: ``m`` carries at
    most 25 significant bits."""
    x = (k + 1).to(torch.float64)
    mant, e = torch.frexp(x)                  # x = mant * 2**e, mant in [1/2, 1)
    m = mant * 2.0
    e = e.to(torch.float64) - 1.0
    big = m > _SQRT2
    m = torch.where(big, m * 0.5, m)
    e = torch.where(big, e + 1.0, e) - 24.0   # the 2**-24 of u1, exactly
    f = m - 1.0
    s = f / (f + 2.0)
    z = s * s
    r = _horner(z, _LOG_R) * z
    hfsq = (f * f) * 0.5
    inner = s * (hfsq + r) + e * _LN2_LO
    return e * _LN2_HI - ((hfsq - inner) - f)


def _cos_2pi_u2(j):
    """f64 ``cos(2 pi j 2**-24)`` for int64 ``j`` in [0, 2**24), from
    correctly rounded operations only (see ``normal``): within 4e-16 of the
    true value.

    The quadrant is j's top two bits; within it the angle is ``r * step``,
    ``r = j mod 2**22``, ``step = (pi/2) / 2**22``. Past the octant (``r >
    2**21``) the complement ``(2**22 - r) * step`` is taken and cos and sin
    swap, so the polynomials see ``t <= pi/4``, and each angle is one
    rounded product of exact integers and ``step``."""
    quad = _srl(j, 22) & 3
    r = j & ((1 << 22) - 1)
    swap = r > (1 << 21)
    a = torch.where(swap, (1 << 22) - r, r).to(torch.float64)
    t = a * _QUARTER_STEP
    z = t * t
    cos_t = _horner(z, _COS_C)
    sin_t = t + (t * z) * _horner(z, _SIN_C)
    cos_r = torch.where(swap, sin_t, cos_t)   # cos of the angle within the quadrant
    sin_r = torch.where(swap, cos_t, sin_t)
    # cos(q pi/2 + phi) = cos phi, -sin phi, -cos phi, sin phi for q = 0..3
    val = torch.where((quad & 1) == 1, sin_r, cos_r)
    neg = (quad == 1) | (quad == 2)
    return torch.where(neg, -val, val)


def normal(keys, counters):
    """Standard normals (f32) by Box-Muller from one draw each: 24 bits give
    ``u1 = (k + 1) * 2**-24`` in (0, 1], 24 more ``u2 = j * 2**-24`` in
    [0, 1). The transform runs in f64 and is rounded to f32 once.

    Its f64 value is a function of the 48 bits alone, the same on every
    CPU and on the card: ``log`` and ``cos`` are not correctly rounded, and
    the card's and a CPU's libm differ in the last bits (f64 ``log(u1)`` in
    80,420 and ``cos(2 pi u2)`` in 2,824,694 of the 2**24 inputs each on an
    H100 80GB HBM3 against its host, ``chip_smoke.check_normal_halves``), so
    neither is called. ``_log_u1`` and ``_cos_2pi_u2`` build them from
    ``+ - * /``, ``sqrt``, ``frexp``, exact conversions and integer ops,
    each one eager elementwise op that IEEE 754 rounds correctly on both
    devices; no fused op (``addcmul``, ``add`` with ``alpha``, a compiled
    graph) that one device could contract into an FMA and the other not,
    and no division by a Python scalar (the card multiplies by its
    reciprocal)."""
    bits = draw_bits(keys, counters)
    radius = torch.sqrt(_log_u1(_srl(bits, 40)) * -2.0)
    z = radius * _cos_2pi_u2((bits >> 16) & 0xFFFFFF)
    return z.to(torch.float32)


NORMAL_CHUNK = 1 << 24   # counters ``normal_at`` draws at once


def normal_at(keys, n: int, counters):
    """``normal(keys, c)`` at the ``n`` counters ``counters(lo, hi)`` gives
    for positions ``lo .. hi - 1`` (int64; a ``core/treeview`` view's
    ``flat_index`` of a leaf), into one (..., n) f32 tensor, drawn
    ``NORMAL_CHUNK`` counters at a time, so the draw's int64 and f64
    temporaries never exceed a chunk's (an LM leaf runs to hundreds of
    millions of values). Each value is a function of its key and counter
    alone, so this is bitwise the one draw."""
    first = normal(keys, counters(0, min(n, NORMAL_CHUNK)))
    if n <= NORMAL_CHUNK:
        return first
    out = first.new_empty((*first.shape[:-1], n))
    out[..., :NORMAL_CHUNK] = first
    del first
    for lo in range(NORMAL_CHUNK, n, NORMAL_CHUNK):
        hi = min(n, lo + NORMAL_CHUNK)
        out[..., lo:hi] = normal(keys, counters(lo, hi))
    return out
