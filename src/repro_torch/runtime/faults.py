"""Fault injection + straggler simulation (port of ``repro/runtime/faults.py``).

``cohort_mask`` draws one round's over-provisioned cohort with deadline-drop
semantics on the host, from a numpy generator keyed by
``determinism.cohort_key(seed, round)``, and returns the (n_clients,) f32
weight mask the round multiplies into the client weights. ``select_cohort``
is the host view of that same mask. The draws are not the JAX package's
(different generator), the semantics are: a pool of
``ceil(target * overprovision)`` clients sampled without replacement, the
dead dropped, the ``target`` fastest survivors kept.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import determinism


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Per-client failure and straggler probabilities of the sync path."""
    drop_prob: float = 0.0        # client fails mid-round
    straggler_prob: float = 0.0   # client exceeds the deadline
    straggler_slowdown: float = 4.0
    worker_fail_prob: float = 0.0
    seed: int = 0


def _outcome(fault: FaultModel, rng: np.random.Generator, n: int):
    """(alive, duration) draw for ``n`` clients: lognormal durations with
    stragglers slowed down."""
    alive = rng.random(n) >= fault.drop_prob
    dur = np.exp(0.25 * rng.standard_normal(n))
    strag = rng.random(n) < fault.straggler_prob
    return alive, np.where(strag, dur * fault.straggler_slowdown, dur)


def cohort_mask(fault: FaultModel, round_idx: int, n_clients: int,
                target: int, overprovision: float = 1.0) -> np.ndarray:
    """Over-provisioned cohort with deadline-drop as an f32 weight mask.

    Samples ceil(target*overprovision) clients without replacement, drops
    the dead, keeps the ``target`` fastest survivors; if fewer than target
    survive, the survivors are kept and the aggregator's weight
    normalization keeps the mean unbiased under random failures.
    Returns shape (n_clients,): 1.0 for kept clients, 0.0 otherwise.
    """
    want = int(min(math.ceil(target * overprovision), n_clients))
    rng = np.random.default_rng(determinism.cohort_key(fault.seed, round_idx))
    in_pool = np.zeros(n_clients, bool)
    in_pool[rng.permutation(n_clients)[:want]] = True
    alive, dur = _outcome(fault, rng, n_clients)
    eligible = in_pool & alive
    dur = np.where(eligible, dur, np.inf)
    rank = np.argsort(np.argsort(dur, kind="stable"), kind="stable")
    return (eligible & (rank < target)).astype(np.float32)


def select_cohort(fault: FaultModel, round_idx: int, client_ids,
                  target: int, overprovision: float = 1.0):
    """Host view of ``cohort_mask``: the sorted kept client ids."""
    client_ids = np.asarray(client_ids)
    mask = cohort_mask(fault, round_idx, len(client_ids), int(target),
                       overprovision)
    return np.sort(client_ids[mask > 0])
