"""The port's campaign planner and lane scheduler (``core/plan.py``,
``runtime/scheduler.py``) against the JAX package and their own contracts,
on the CPU.

- ``program_signature`` and ``build_plan``'s buckets equal the JAX
  package's for the same job dicts, and ``SuccessiveHalving.decide`` its
  drops on the same metric tables (exactly: host bookkeeping).
- Within the port, bitwise (lanes against single runs with oneDNN's
  convolutions off, see ``native_convs``): with the scheduler off every
  lane of a heterogeneous plan is its single run; with it on a surviving lane is its
  full single run and a dropped lane its single run cut at the drop round;
  a resumed plan replays ``decisions.jsonl`` and ends bitwise the
  uninterrupted one.
"""
import json

import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFLConfig
from repro.core import plan as jplan
from repro.core import sweeps as jsweeps
from repro.runtime.scheduler import SuccessiveHalving as JSuccessiveHalving
from repro_torch.configs.base import FLConfig
from repro_torch.core import plan, sweeps
from repro_torch.core.jobs import load_job
from repro_torch.models.small import SmallModel
from repro_torch.runtime.campaign import read_results
from repro_torch.runtime.executor import Executor
from repro_torch.runtime.scheduler import PlanExecutor, SuccessiveHalving


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


GRIDS = [
    ({}, {"strategy": ["fedavg", "fedprox", "scaffold"], "topology": ["client_server",
                                                                      "hierarchical"],
          "seed": [0, 1], "client_lr": [0.05, 0.1]}),
    ({"mode": "async"}, {"async_buffer": [0, 1, 4], "staleness_exponent": [0.0, 0.5],
                         "compression": ["none", "int8"]}),
    ({"placement": "auto"}, {"placement": ["spatial", "auto", "temporal"],
                             "mode": ["sync", "async"], "seeds": [3]}),
    ({"n_workers": 3}, {"n_clients": [4, 8], "cohort": [0, 2]}),
]


@pytest.mark.parametrize("case", range(len(GRIDS)))
def test_signatures_and_buckets_match_jax(case):
    base, spec = GRIDS[case]
    got = plan.build_plan(FLConfig(**base), sweeps.parse_sweep(spec), "flsim-cnn")
    want = jplan.build_plan(JFLConfig(**base), jsweeps.parse_sweep(spec), "flsim-cnn")
    assert got.signatures == want.signatures
    assert [(b.index, b.signature, b.lane_ids) for b in got.buckets] == \
        [(b.index, b.signature, b.lane_ids) for b in want.buckets]
    assert got.coords == want.coords and got.size == want.size
    for lane in range(got.size):
        assert got.lane_bucket(lane) == want.lane_bucket(lane)
    assert plan.resolve_placement(FLConfig(**base)) == jplan.resolve_placement(
        JFLConfig(**base))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kw", [dict(), dict(mode="max", eta=3.0, rung_every=2),
                                dict(rung_every=5, min_lanes=2)])
def test_successive_halving_decides_as_the_jax_package(seed, kw):
    rng = np.random.RandomState(seed)
    got, want = SuccessiveHalving(**kw), JSuccessiveHalving(**kw)
    for rnd in range(1, 12):
        n = rng.randint(1, 9)
        table = {int(k): float(v) for k, v in zip(rng.choice(20, n, replace=False),
                                                  rng.choice([0.1, 0.5, 0.5, 2.0], n))}
        prev = rnd - rng.randint(1, 4)
        assert got.is_rung(rnd, prev) == want.is_rung(rnd, prev)
        assert got.decide(rnd, table, prev) == want.decide(rnd, table, prev)
        assert got.decide(rnd, table) == want.decide(rnd, table)
    with pytest.raises(ValueError, match="eta"):
        SuccessiveHalving(eta=1.0)


# -- within the port -----------------------------------------------------------

def _raw(sweep, rounds=3, **train):
    tp = {"n_clients": 4, "local_steps": 2, "batch_size": 4, "client_lr": 0.1,
          "rounds": rounds, "seed": 7, "rounds_per_launch": 1, "async_buffer": 3,
          "max_staleness": 4, "staleness_exponent": 0.5, "prox_mu": 0.1}
    tp.update(train)
    return {"name": "plan", "model": {"arch": "flsim-cnn"},
            "dataset": {"dataset": "synthetic_vision", "n_items": 128},
            "strategy": {"strategy": tp.pop("strategy", "fedavg"), "train_params": tp},
            "runtime": {"straggler_prob": 0.2, "duration_sigma": 0.25},
            "sweep": sweep}


def _job(raw):
    job = load_job(raw)
    job.model = SmallModel(job.model.cfg.replace(d_model=8, d_ff=16), "cnn")
    return job


@pytest.fixture
def native_convs():
    """Lane == single run holds bit for bit on the CPU with oneDNN's
    convolutions off: oneDNN picks a conv's algorithm by its group
    count, and the lanes run S times a single run's groups. (The tests
    run on one thread, ``one_thread``, which keeps PyTorch's native convs
    quick when test processes share the cores.)"""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _single(coord, rounds=3):
    raw = _raw(None, rounds=rounds, **coord)
    raw.pop("sweep")
    ex = Executor(_job(raw), device="cpu").scaffold()
    ex.run()
    return ex


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


GRID = {"strategy": ["fedavg", "fedprox"], "mode": ["sync", "async"], "seed": [0, 1]}


def test_plan_lanes_are_their_single_runs_with_the_scheduler_off(tmp_path, native_convs):
    pe = PlanExecutor(_job(_raw(GRID, rounds=2, compression="int8")), device="cpu",
                      out_dir=str(tmp_path)).scaffold()
    pe.run()
    assert len(pe.plan.buckets) == 4 and pe.S == 8 and not pe.dropped
    assert pe.compiled_programs() == 4          # one launch key per bucket
    for lane, coord in enumerate(pe.plan.coords):
        single = _single(dict(coord, compression="int8"), rounds=2)
        assert _same(pe.lane_params(lane), single.state["params"]), coord
    rows = read_results(tmp_path / "campaign.csv")
    assert len(rows) == 8 * 2
    assert list(rows[0])[:6] == ["bucket", "lane", "strategy", "mode", "seed", "traj"]
    assert [r["round"] for r in rows] == sorted(r["round"] for r in rows)


def test_halving_keeps_survivors_whole_and_freezes_dropped_lanes(tmp_path, native_convs):
    sched = SuccessiveHalving(metric="loss", rung_every=2, eta=2.0)
    pe = PlanExecutor(_job(_raw(GRID, rounds=3)), device="cpu", scheduler=sched,
                      out_dir=str(tmp_path)).scaffold()
    pe.run()
    assert len(pe.dropped) == 4 and set(pe.dropped.values()) == {2}
    drops = [json.loads(line) for line in (tmp_path / "decisions.jsonl").read_text().splitlines()]
    assert [d["round"] for d in drops] == [1, 2, 3]
    assert sorted(sum((d["dropped"] for d in drops), [])) == sorted(pe.dropped)
    for lane, coord in enumerate(pe.plan.coords):
        rounds = pe.dropped.get(lane, 3)
        single = _single(coord, rounds=rounds)
        assert _same(pe.lane_params(lane), single.state["params"]), (lane, rounds)
    assert not any(r["lane"] in pe.dropped and r["round"] >= 2 for r in pe.rows())


def test_resume_replays_decisions_bitwise(tmp_path):
    sched = SuccessiveHalving(metric="loss", rung_every=2, eta=2.0)
    raw = _raw(GRID, rounds=3, checkpoint_every=1, blockchain="hashchain")
    full = PlanExecutor(_job(raw), device="cpu", scheduler=sched,
                        out_dir=str(tmp_path / "a"), ckpt_dir=str(tmp_path / "ack")).scaffold()
    full.run()
    kw = dict(device="cpu", scheduler=sched, out_dir=str(tmp_path / "b"),
              ckpt_dir=str(tmp_path / "bck"))
    PlanExecutor(_job(raw), **kw).scaffold().run(2)
    resumed = PlanExecutor(_job(raw), **kw).scaffold()
    assert resumed.round_idx == 2 and resumed.dropped == full.dropped
    resumed.run()
    assert resumed.dropped == full.dropped
    for lane in range(full.S):
        assert _same(resumed.lane_params(lane), full.lane_params(lane)), lane
    ledger = [b.kind for b in resumed.job.ledger._chain]
    assert ledger.count("lane_drop") == len(full.dropped)


def test_scheduler_checks():
    with pytest.raises(ValueError, match="out_dir"):
        PlanExecutor(_job(_raw(GRID)), device="cpu", scheduler=SuccessiveHalving(),
                     ckpt_dir="unused").scaffold()
    pe = PlanExecutor(_job(_raw({"seed": [0, 1]}, rounds=2)), device="cpu",
                      scheduler=SuccessiveHalving(metric="los", rung_every=1)).scaffold()
    with pytest.raises(KeyError, match="did you mean 'loss'"):
        pe.run()
    # two lane ranks wanted, one process visible: lane_mesh's error
    with pytest.raises(ValueError, match=r"lane_mesh\(2\) wants 2 devices but only 1 are visible"):
        PlanExecutor(_job(_raw({"seed": [0, 1]})), device="cpu", lane_devices=2).scaffold()
