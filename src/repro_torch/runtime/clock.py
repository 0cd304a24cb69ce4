"""Deterministic virtual clock for event-driven asynchronous FL (a copy of
``repro/runtime/clock.py``: the schedule is numpy and bitwise the JAX
package's for the same inputs; only ``device_arrays`` hands torch tensors to
the port's event loop).

The sync driver models client heterogeneity only as a per-round deadline
drop (``faults.cohort_mask``). Async execution needs the *time axis* itself:
each client trains continuously, completions arrive at the server out of
order, and the server reacts per arrival (FedAsync) or per K arrivals
(FedBuff). This module renders that as a **host-precomputed event
schedule**: a discrete-event simulation over a virtual clock, driven by
``ClientSystemModel`` (the ``FaultModel`` extended with the client *system*
dimension — per-client speed, per-task lognormal jitter, availability).

The schedule is plain numpy — client id, task index, staleness, ring slots,
aggregation coefficients per server event — and is staged on device once, so
the event loop in ``core/async_rounds.py`` can compile as a ``lax.scan``
over events with no host round-trips. Everything is keyed by the seed:

- durations/availability come from per-task Philox streams keyed by
  ``(seed, field, task_index)``, so the schedule for E events is a prefix of
  the schedule for E' > E events (regeneration cannot rewrite history);
- ties on the virtual clock break by client id, and all arrivals at one
  timestamp are processed before any client re-dispatches — that convention
  is what makes "FedBuff with buffer == cohort and equal client speeds"
  collapse to synchronous FedAvg (the identity test in
  tests/test_torch_async.py).

Staleness bookkeeping: the server version bumps at each *apply* event; a
task's staleness is (version at arrival) - (version at dispatch). Stale
snapshots live in a ring buffer of the last ``max_staleness + 1`` versions
(``ring``); arrivals older than ``max_staleness`` are rejected (coefficient
0), which also guarantees every in-ring read is valid.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq

import numpy as np
import torch

from repro_torch.runtime.faults import FaultModel

_F32 = np.float32

# Philox stream tags (second 64-bit key word, high half). _TAG_LINK is the
# comms observatory's bandwidth-tier stream (the JAX package's
# core/netmodel.py; ROADMAP A11 ports it): a NEW tag,
# so adding a LinkModel never re-deals the rate/jitter/straggler/avail
# columns — existing schedules stay prefix-stable link knobs on or off.
_TAG_RATE, _TAG_JITTER, _TAG_STRAGGLER, _TAG_AVAIL, _TAG_LINK = 1, 2, 3, 4, 5


@dataclasses.dataclass(frozen=True)
class ClientSystemModel(FaultModel):
    """``FaultModel`` grown into a client *system* model (speed + arrival).

    Reuses the fault fields the sync path already draws from —
    ``straggler_prob`` / ``straggler_slowdown`` inflate task durations,
    ``drop_prob`` folds into availability — and adds the async-only knobs:

    - ``mean_duration``: virtual-time cost of one local-training task;
    - ``duration_sigma``: per-task lognormal jitter (the sync ``_outcome``
      draw uses sigma 0.25; 0 makes every task of a client take equal time);
    - ``rate_spread``: persistent per-client lognormal speed spread
      (device heterogeneity, not per-task noise);
    - ``availability``: probability a finished task's update is usable
      (an unavailable arrival is rejected: zero weight, no buffer slot).

    The link fields are the **LinkModel** (the JAX package's
    core/netmodel.py, ROADMAP A11): per-client
    up/down bandwidth tiers + per-transfer latency, consumed only by the
    host-side comms accounting plane — the event schedule never reads them,
    so two runs differing only in link knobs share bitwise-identical
    schedules:

    - ``up_mbps`` / ``down_mbps``: top-tier client bandwidth (Mbit/s of
      *virtual* time, the same unit as ``mean_duration``);
    - ``link_tiers``: number of bandwidth classes; each client draws its
      tier from the ``_TAG_LINK`` Philox stream (1 = homogeneous);
    - ``link_tier_factor``: bandwidth multiplier per tier below the top
      (tier t gets ``factor**t``);
    - ``latency_s``: fixed per-transfer latency (virtual seconds).
    """
    mean_duration: float = 1.0
    duration_sigma: float = 0.25
    rate_spread: float = 0.0
    availability: float = 1.0
    up_mbps: float = 100.0
    down_mbps: float = 400.0
    link_tiers: int = 1
    link_tier_factor: float = 0.5
    latency_s: float = 0.01


def _column(seed: int, tag: int, task: int, draw, n: int):
    """One deterministic draw of ``n`` values for task index ``task``.

    A fresh Philox generator per (seed, tag, task) column keeps the schedule
    prefix-stable in the number of events: extending the horizon only adds
    columns, it never re-deals earlier ones."""
    key = np.array([np.uint64(seed & 0xFFFFFFFF),
                    np.uint64((tag << 32) | (task & 0xFFFFFFFF))],
                   dtype=np.uint64)
    return draw(np.random.Generator(np.random.Philox(key=key)), n)


def client_rates(csm: ClientSystemModel, n_clients: int) -> np.ndarray:
    """Persistent per-client speed multipliers (lognormal, mean-ish 1)."""
    z = _column(csm.seed, _TAG_RATE, 0,
                lambda g, n: g.standard_normal(n), n_clients)
    return np.exp(csm.rate_spread * z).astype(_F32)


def _dur_column(csm: ClientSystemModel, rate: np.ndarray,
                t: int) -> np.ndarray:
    """Durations of every client's task ``t``: rate * lognormal * straggler.

    Degenerate knobs skip their Philox column entirely — the output is
    identical (``sigma == 0`` zeroes the exponent, ``straggler_prob == 0``
    makes the where-mask all-False regardless of ``u``) and per-(tag, task)
    keying means an unconsumed column never shifts any other draw. Philox
    construction is the host cost of the comms plane's makespan replay, so
    the common no-straggler case pays one column, not two."""
    n = rate.shape[0]
    if csm.duration_sigma != 0.0:
        z = _column(csm.seed, _TAG_JITTER, t,
                    lambda g, m: g.standard_normal(m), n)
        d = csm.mean_duration * rate * np.exp(csm.duration_sigma * z)
    else:
        d = csm.mean_duration * rate
    if csm.straggler_prob <= 0.0:
        return np.asarray(d, _F32)
    u = _column(csm.seed, _TAG_STRAGGLER, t, lambda g, m: g.random(m), n)
    return np.where(u < csm.straggler_prob,
                    d * csm.straggler_slowdown, d).astype(_F32)


def _ok_column(csm: ClientSystemModel, n_clients: int, t: int) -> np.ndarray:
    """Usability of every client's task ``t`` (availability x not-dropped)."""
    p_ok = float(csm.availability) * (1.0 - float(csm.drop_prob))
    u = _column(csm.seed, _TAG_AVAIL, t, lambda g, m: g.random(m), n_clients)
    return u < p_ok


class _Columns:
    """Task columns drawn lazily as the simulation consumes task indices.

    Memory/host-time scale with the *deepest task index actually reached*
    (~E/C for balanced speeds), not with the E x C worst case; per-task
    Philox streams keep the values independent of how far we draw."""

    def __init__(self, draw):
        self._draw = draw
        self._cols: list = []

    def __call__(self, c: int, t: int):
        while len(self._cols) <= t:
            self._cols.append(self._draw(len(self._cols)))
        return self._cols[t][c]


@dataclasses.dataclass(frozen=True)
class EventSchedule:
    """One server event per completed client task, in virtual-time order."""
    client: np.ndarray      # (E,) int32  client arriving at event e
    task: np.ndarray        # (E,) int32  that client's task index (its k-th)
    staleness: np.ndarray   # (E,) int32  server versions elapsed in flight
    accept: np.ndarray      # (E,) bool   arrival usable (fresh + available)
    apply: np.ndarray       # (E,) bool   server update fires at this event
    read_slot: np.ndarray   # (E,) int32  ring slot of the task's start params
    write_slot: np.ndarray  # (E,) int32  ring slot the apply writes (else 0)
    coeff: np.ndarray       # (E,) f32    staleness-weighted agg coefficient
    vtime: np.ndarray       # (E,) f64    virtual arrival time
    ring: int               # param-history ring size (max_staleness + 1)
    n_versions: int         # server versions produced over the horizon

    def __len__(self) -> int:
        return int(self.client.shape[0])

    def device_arrays(self, device) -> dict:
        """The per-event arrays as torch tensors on ``device``. The event
        loop branches on the host's numpy fields and reads only ``coeff``
        from here, so no event waits for the device."""
        return {k: torch.as_tensor(getattr(self, k), device=device)
                for k in ("client", "task", "staleness", "accept", "apply",
                          "read_slot", "write_slot", "coeff")}


def build_schedule(csm: ClientSystemModel, n_clients: int, n_events: int,
                   weights, *, buffer_size: int = 0,
                   staleness_exponent: float = 0.0, max_staleness: int = 8,
                   concurrency: int = 0) -> EventSchedule:
    """Simulate the virtual clock and emit the first ``n_events`` arrivals.

    ``weights`` are the per-client aggregation weights (partition sizes).
    ``buffer_size`` <= 1 selects FedAsync semantics (every accepted arrival
    applies; ``coeff`` is the pure staleness weight); K > 1 selects FedBuff
    (apply every K accepted arrivals; ``coeff`` is the staleness-and-size
    weighted share of the buffer group, so the grouped update is the
    weighted mean of its deltas). ``concurrency`` caps clients in flight
    (0 = all clients train continuously).

    Convention: all arrivals at one virtual timestamp are processed (in
    client-id order) before any finished client re-dispatches, so a task
    dispatched "at" an apply sees the post-apply version.
    """
    E = int(n_events)
    C = int(n_clients)
    # degenerate inputs fail loudly, naming the field: E <= 0 used to
    # return a silently-empty schedule and C == 0 crashed the event loop
    # with a bare IndexError off the empty dispatch heap
    if E <= 0:
        raise ValueError(f"build_schedule needs n_events > 0, got "
                         f"{n_events} (fl.rounds * events_per_round must "
                         "be positive)")
    if C <= 0:
        raise ValueError(f"build_schedule needs n_clients > 0, got "
                         f"{n_clients} (no clients to dispatch)")
    K = max(int(buffer_size), 1)
    M = C if concurrency <= 0 else min(int(concurrency), C)
    ring = int(max_staleness) + 1
    w = np.asarray(weights, _F32).reshape(-1)
    if w.shape[0] != C:
        raise ValueError(f"weights shape {w.shape} != n_clients {C}")

    rate = client_rates(csm, C)
    dur = _Columns(lambda t: _dur_column(csm, rate, t))
    usable = _Columns(lambda t: _ok_column(csm, C, t))

    client = np.zeros(E, np.int32)
    task = np.zeros(E, np.int32)
    staleness = np.zeros(E, np.int32)
    accept = np.zeros(E, bool)
    apply = np.zeros(E, bool)
    read_slot = np.zeros(E, np.int32)
    write_slot = np.zeros(E, np.int32)
    aw = np.zeros(E, _F32)            # staleness-weight * client weight
    den = np.ones(E, _F32)            # buffer-group normalizer (FedBuff)
    alpha_arr = np.zeros(E, _F32)     # pure staleness weight (FedAsync)
    vtime = np.zeros(E, np.float64)

    heap: list = []                   # (finish_time, client)
    waiting = collections.deque(range(M, C))
    start_version = np.zeros(C, np.int64)   # version seen at dispatch
    done = np.zeros(C, np.int64)            # completed tasks per client
    for c in range(M):
        heapq.heappush(heap, (float(dur(c, 0)), c))

    version = 0
    buf_n = 0
    buf_den = _F32(0.0)
    group: list = []                  # event ids of the open buffer group
    e = 0
    while e < E:
        t, _ = heap[0]
        arrivals = []
        while heap and heap[0][0] == t:
            arrivals.append(heapq.heappop(heap)[1])
        for c in arrivals:            # heap pops ties in client-id order
            if e >= E:
                break
            k = int(done[c])
            s = version - int(start_version[c])
            ok = bool(usable(c, k)) and s <= int(max_staleness)
            alpha = _F32((1.0 + s) ** (-float(staleness_exponent))) \
                if ok else _F32(0.0)
            client[e] = c
            task[e] = k
            staleness[e] = s
            accept[e] = ok
            read_slot[e] = int(start_version[c]) % ring
            aw[e] = alpha * w[c]
            alpha_arr[e] = alpha
            vtime[e] = t
            if ok:
                buf_n += 1
                buf_den = _F32(buf_den + aw[e])
                group.append(e)
                if buf_n >= K:
                    apply[e] = True
                    version += 1
                    write_slot[e] = version % ring
                    den[group] = max(buf_den, _F32(1e-12))
                    buf_n, buf_den, group = 0, _F32(0.0), []
            done[c] = k + 1
            e += 1
        # re-dispatch only after the whole timestamp group is processed
        for c in arrivals:
            waiting.append(c)
        while len(heap) < M and waiting:
            c = waiting.popleft()
            start_version[c] = version
            heapq.heappush(heap, (t + float(dur(c, int(done[c]))), c))
    if group:                         # trailing open group: never applied
        den[group] = max(buf_den, _F32(1e-12))

    if K > 1:
        coeff = (aw / den).astype(_F32)
    else:
        coeff = alpha_arr
    return EventSchedule(client=client, task=task, staleness=staleness,
                         accept=accept, apply=apply, read_slot=read_slot,
                         write_slot=write_slot, coeff=coeff, vtime=vtime,
                         ring=ring, n_versions=version)
