"""Which clients train and which items they read in a round, worked out
again from the FL job's definition, for the plain reference of the paper's
round.

The simulation keys every draw by (seed, absolute round, client) with
splitmix64: a key is a 64-bit word, a child key is ``mix(key ^
mix(index))``, and the i-th draw of a key is ``mix(key + i * gamma)``. A
round's cohort is drawn on the host with numpy's generator seeded by the
round's cohort key (over-provisioned, the dead dropped, the fastest
``target`` kept); each client's batch positions are uniform over its
partition, from the high 32 bits of its draws. Tags: 0xBA7C batch, 0xC047
cohort.
"""
from __future__ import annotations

import math

import numpy as np

_MASK = (1 << 64) - 1
_GAMMA = 0x9E3779B97F4A7C15


def mix(z: int) -> int:
    """The splitmix64 finalizer of ``z + gamma``."""
    z = (z + _GAMMA) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def child(key: int, index: int) -> int:
    return mix(key ^ mix(index & _MASK))


def _mix_array(z: np.ndarray) -> np.ndarray:
    z = z + np.uint64(_GAMMA)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def round_key(seed: int, r: int) -> int:
    return child(mix(seed & _MASK), r)


def batch_positions(seed: int, r: int, client: int, length: int, n: int) -> np.ndarray:
    """(n,) positions in [0, length) of one client's items in round r."""
    key = child(child(round_key(seed, r), 0xBA7C), client)
    with np.errstate(over="ignore"):
        z = np.arange(n, dtype=np.uint64) * np.uint64(_GAMMA) + np.uint64(key)
        hi = _mix_array(z) >> np.uint64(32)
    return ((hi * np.uint64(max(length, 1))) >> np.uint64(32)).astype(np.int64)


def cohort(seed: int, r: int, n_clients: int, target: int, overprovision: float,
           drop_prob: float, straggler_prob: float, slowdown: float) -> np.ndarray:
    """(n_clients,) f32: 1 for the clients kept in round r, else 0."""
    want = int(min(math.ceil(target * overprovision), n_clients))
    rng = np.random.default_rng(child(child(mix(0xC047), seed), r))
    pool = np.zeros(n_clients, bool)
    pool[rng.permutation(n_clients)[:want]] = True
    alive = rng.random(n_clients) >= drop_prob
    dur = np.exp(0.25 * rng.standard_normal(n_clients))
    late = rng.random(n_clients) < straggler_prob
    dur = np.where(late, dur * slowdown, dur)
    ok = pool & alive
    dur = np.where(ok, dur, np.inf)
    rank = np.argsort(np.argsort(dur, kind="stable"), kind="stable")
    return (ok & (rank < target)).astype(np.float32)
