"""Seed derivation for the port (port of ``repro/core/determinism.py``).

The JAX package keys every draw with threefry ``fold_in`` chains; here a key
is a plain 64-bit integer and ``fold_in`` is splitmix64 over
``(parent, index)``. The function names and tags (0x11C client, 0x57E step,
0xBA7C batch, 0xC047 cohort) are the JAX package's, so each draw is keyed by
the same ``(seed, absolute round[, client, step])`` coordinates — and
therefore a run chunked into launches draws exactly what an unchunked run
draws.

This does NOT reproduce ``jax.random``'s bits: the two packages draw
different batches and cohorts from the same seed. Parity tests feed both
packages the same numpy inputs instead.
"""
from __future__ import annotations

import torch

_MASK = (1 << 64) - 1


def _mix(z: int) -> int:
    """splitmix64 finalizer: a bijective avalanche on 64-bit words."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def fold_in(key: int, data: int) -> int:
    """A child key of ``key`` for the integer ``data``."""
    return _mix(key ^ _mix(int(data) & _MASK))


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


def batch_key(round_key_: int) -> int:
    """Key for one round's batch draw (tag 0xBA7C). The port draws every
    client's positions in one call per round, so where the JAX function
    also folds in a client id, this key is per round."""
    return fold_in(round_key_, 0xBA7C)


def cohort_key(seed: int, round_idx: int) -> int:
    """Key for cohort selection / fault outcomes in one round (tag 0xC047)."""
    return fold_in(fold_in(root_key(0xC047), seed), round_idx)


def generator(key: int, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``key``."""
    g = torch.Generator(device=device)
    g.manual_seed(key & ((1 << 63) - 1))
    return g
