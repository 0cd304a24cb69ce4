"""The port's async FL (``runtime/clock.py``, ``core/async_rounds.py`` and the
executor's async mode) against the JAX package and its own contracts, on
the CPU.

- The event schedule is numpy in both packages: bitwise equal.
- Whole runs of the two packages, FedAsync, FedBuff and FedBuff on int8, from
  the same weights: the packages draw batches differently, so every client's
  partition repeats one item and any draw gives the same batch. Tolerances
  those of ``tests/test_torch_slice.py``: loss rtol 1e-5, params atol 1e-5 /
  rtol 1e-4; on int8 at most 1e-3 of the entries (and at least one) may
  differ by more, each by at most one quantum (an int8 rounding flip).
- Within the port, bitwise: chunked == unchunked, and FedBuff with buffer ==
  cohort, no staleness discount and equal client speeds == sync temporal
  FedAvg (the JAX package's ``tests/test_async.py`` identity).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
from repro.core.jobs import load_job as j_load_job
from repro.models.small import SmallModel as JSmallModel
from repro.runtime.clock import ClientSystemModel as JCSM
from repro.runtime.clock import build_schedule as j_build_schedule
from repro.runtime.executor import Executor as JExecutor
from repro_torch.core import async_rounds
from repro_torch.core.jobs import load_job
from repro_torch.interop import to_numpy
from repro_torch.kernels import ops
from repro_torch.models.small import SmallModel
from repro_torch.runtime.clock import ClientSystemModel, build_schedule
from repro_torch.runtime.executor import Executor


@pytest.fixture(autouse=True)
def one_thread():
    """Every test here on one torch intra-op thread: the suite runs in
    several processes that share the cores, and with a thread per core in
    each, torch's many small CPU ops crawl (six of the port's test files took
    426 s under six processes against 75 s on one thread each)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


EQUAL_SPEEDS = {"straggler_prob": 0.0, "duration_sigma": 0.0,
                "rate_spread": 0.0, "availability": 1.0}
HETERO = {"straggler_prob": 0.2, "duration_sigma": 0.25, "rate_spread": 0.5}


def _raw(rounds_per_launch=1, rounds=4, seed=7, mode="async", async_buffer=3,
         staleness_exponent=0.5, max_staleness=4, placement="spatial",
         runtime=None, n_clients=4, strategy="fedavg", **train):
    tp = {"n_clients": n_clients, "local_steps": 2, "batch_size": 4,
          "client_lr": 0.1, "rounds": rounds, "seed": seed, "mode": mode,
          "placement": placement, "async_buffer": async_buffer,
          "staleness_exponent": staleness_exponent,
          "max_staleness": max_staleness, "rounds_per_launch": rounds_per_launch}
    tp.update(train)
    return {"name": "async", "model": {"arch": "flsim-cnn"},
            "dataset": {"dataset": "synthetic_vision", "n_items": 128},
            "strategy": {"strategy": strategy, "train_params": tp},
            "runtime": dict(HETERO if runtime is None else runtime)}


def _job(**kw):
    job = load_job(_raw(**kw))
    job.model = SmallModel(job.model.cfg.replace(d_model=8, d_ff=16), "cnn")
    return job


def _flat(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _flat(v)]
    return [tree]


def _bitwise(a, b):
    a, b = _flat(a), _flat(b)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# -- the schedule ------------------------------------------------------------

SCHEDULES = [
    dict(csm={}, buffer_size=0),
    dict(csm={}, buffer_size=3),
    dict(csm=dict(straggler_prob=0.3, duration_sigma=0.5), buffer_size=3,
         staleness_exponent=0.5, max_staleness=2),
    dict(csm=dict(rate_spread=0.8, availability=0.7, drop_prob=0.1),
         buffer_size=2, staleness_exponent=1.0),
    dict(csm=dict(straggler_prob=0.2, rate_spread=0.5), buffer_size=0,
         concurrency=3, staleness_exponent=0.5),
    dict(csm=dict(duration_sigma=0.0, rate_spread=0.0, straggler_prob=0.0),
         buffer_size=5),
]


@pytest.mark.parametrize("case", range(len(SCHEDULES)))
def test_schedule_is_jax_bitwise(case):
    kw = dict(SCHEDULES[case])
    csm = kw.pop("csm")
    w = np.random.RandomState(case).randint(1, 40, 7).astype(np.float32)
    want = j_build_schedule(JCSM(seed=case, **csm), 7, 60, w, **kw)
    got = build_schedule(ClientSystemModel(seed=case, **csm), 7, 60, w, **kw)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    dev = got.device_arrays("cpu")
    assert torch.equal(dev["coeff"], torch.from_numpy(want.coeff))
    assert dev["accept"].dtype == torch.bool


# -- whole runs against the JAX package ---------------------------------------

class _OneItemPerClient:
    """A dataset whose every client partition repeats one item, so every
    batch draw of either package gives the same batch."""

    def __init__(self, dataset):
        self.dataset = dataset

    def distribute_into_chunks(self, kind, n_clients, alpha=0.5):
        x, y = self.dataset.prepare_root_dataset()
        return x, y, [np.full(3 + c, 5 * c, np.int64) for c in range(n_clients)]


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_torch(v) for v in tree)
    return torch.tensor(np.asarray(tree))


@pytest.mark.parametrize("async_buffer,strategy,compression", [
    (0, "fedavg", "none"),           # FedAsync
    (3, "fedavg", "none"),           # FedBuff
    (3, "compressed", "int8"),       # FedBuff on int8: one B1 launch per flush
])
def test_async_runs_match_jax(async_buffer, strategy, compression, monkeypatch):
    kw = dict(rounds=3, rounds_per_launch=3, async_buffer=async_buffer,
              strategy=strategy, compression=compression)
    jjob = j_load_job(_raw(**kw))
    jjob.model = JSmallModel(jjob.model.cfg.replace(d_model=8, d_ff=16), "cnn")
    jjob.dataset = _OneItemPerClient(jjob.dataset)
    jex = JExecutor(jjob).scaffold()
    job = _job(**kw)
    job.dataset = _OneItemPerClient(job.dataset)
    ex = Executor(job, device="cpu").scaffold()
    ex.state = _to_torch(jax.tree.map(np.asarray, jex.state))   # same weights
    scales = [0.0]
    agg = ops.quant_aggregate

    def recording(q, s, w):                  # the largest block scale sent
        scales.append(float(s.max()))
        return agg(q, s, w)
    monkeypatch.setattr(async_rounds.ops, "quant_aggregate", recording)
    jstate, jlog = jex.run()
    state, log = ex.run()
    for field in ("staleness", "applied", "vtime"):
        assert log.series(field) == jlog.series(field)
    np.testing.assert_allclose(log.series("loss"), jlog.series("loss"), rtol=1e-5)
    want, got = jax.tree.map(np.asarray, jstate["params"]), to_numpy(state["params"])
    quantum = max(scales)
    outside = total = 0
    for k, v in want.items():
        diff = np.abs(got[k] - v)
        assert (diff <= quantum + 1e-5 + 1e-4 * np.abs(v)).all(), k
        outside += int((diff > 1e-5 + 1e-4 * np.abs(v)).sum())
        total += diff.size
    assert outside <= (max(1, 1e-3 * total) if compression == "int8" else 0)


# -- the port's own contracts -------------------------------------------------

@pytest.mark.parametrize("async_buffer,compression", [(3, "none"), (0, "none"),
                                                      (3, "int8"), (0, "int8")])
def test_chunked_equals_unchunked_bitwise(async_buffer, compression):
    """One launch of 10 rounds, launches of 1, and an uneven 3+1, under
    stragglers, jitter, rate spread and a staleness discount."""
    runs = {}
    for chunk in (1, 10, 3):
        strategy = "compressed" if compression == "int8" else "fedavg"
        state, logger = Executor(_job(rounds_per_launch=chunk, async_buffer=async_buffer,
                                      strategy=strategy, compression=compression),
                                 device="cpu").scaffold().run()
        runs[chunk] = (state, logger.series("loss"))
    assert runs[1][1] == runs[10][1] == runs[3][1]
    assert _bitwise(runs[1][0], runs[10][0]) and _bitwise(runs[1][0], runs[3][0])


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_fedbuff_identity_with_sync_temporal_fedavg(compression):
    """FedBuff with buffer == cohort, no staleness discount and equal client
    speeds is sync temporal FedAvg, bit for bit: the same arrivals in client
    order each round, the same batch and client keys, the same f32
    accumulation (int8: the same sends, one B1 launch per round)."""
    strategy = "compressed" if compression == "int8" else "fedavg"
    kw = dict(rounds=4, seed=11, runtime=EQUAL_SPEEDS, strategy=strategy,
              compression=compression, rounds_per_launch=2)
    sync_state, _ = Executor(_job(mode="sync", placement="temporal", **kw),
                             device="cpu").scaffold().run()
    asy = Executor(_job(async_buffer=4, staleness_exponent=0.0, **kw),
                   device="cpu").scaffold()
    async_state, _ = asy.run()
    assert all(torch.equal(sync_state["params"][k], async_state["params"][k])
               for k in sync_state["params"])
    assert all(s == 0.0 for s in asy.logger.series("staleness"))
    assert all(a == 1.0 for a in asy.logger.series("applied"))


def test_async_trains():
    """Under heterogeneity the async run still learns and reports stale
    arrivals."""
    _, logger = Executor(_job(rounds=6, rounds_per_launch=6, async_buffer=2),
                         device="cpu").scaffold().run()
    losses = logger.series("loss")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert max(logger.series("staleness")) > 0.0
    assert all(r["events_per_s"] > 0 and r["vtime"] > 0 for r in logger.rows)


@pytest.mark.parametrize("async_buffer", [3, 0])
def test_b1_launches_once_per_flush_or_event(async_buffer):
    """Packed FedBuff: one B1 launch per flush (apply event); packed
    FedAsync: one per event, accepted or rejected."""
    ex = Executor(_job(rounds=3, rounds_per_launch=2, async_buffer=async_buffer,
                       strategy="compressed", compression="int8",
                       runtime=dict(HETERO, availability=0.7)),
                  device="cpu").scaffold()
    with ops.quant_agg_scope() as frame:
        ex.run()
    sched = ex.schedule
    n_ev = 3 * ex.events_per_round
    want = int(sched.apply[:n_ev].sum()) if async_buffer > 1 else n_ev
    assert frame["calls"] == want > 0
    assert not sched.accept[:n_ev].all()        # rejected arrivals among them
