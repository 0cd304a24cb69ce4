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
into batch positions and ``normal`` into Gaussians (Box-Muller, the same
bits on the CPU and the card too).

This does NOT reproduce ``jax.random``'s bits: the two packages draw
different batches, noise and cohorts from the same seed. Parity tests feed
both packages the same numpy inputs instead.
"""
from __future__ import annotations

import math

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


def client_keys(round_key_: int, n_clients: int, device) -> torch.Tensor:
    """(C,) int64: ``client_key(round_key_, c)`` for every client c."""
    ids = torch.arange(n_clients, dtype=torch.int64, device=device)
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


def normal(keys, counters):
    """Standard normals (f32) by Box-Muller from one draw each: 24 bits give
    ``u1`` in (0, 1], 24 more ``u2`` in [0, 1). The transform runs in f64
    and is rounded to f32 once: the f32 ``log``, ``cos`` and ``sqrt`` of the
    CPU and of the card differ in the last place, their f64 results round
    to the same f32, so a draw has the same bits on both."""
    bits = draw_bits(keys, counters)
    u1 = (_srl(bits, 40) + 1).to(torch.float64) * 2.0 ** -24
    u2 = ((bits >> 16) & 0xFFFFFF).to(torch.float64) * 2.0 ** -24
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2 * math.pi) * u2)
    return z.to(torch.float32)
