"""The port's streaming client plane (``data/pipeline.py``'s slab stagers,
``rounds.build_ragged_multi``, ragged async, ragged campaigns) against the
JAX package and its own contracts, on the CPU.

Against the JAX package:
- bitwise: ``SyntheticPopulation`` shards, the resident and streaming
  stagers' slabs and event rows on the same partitions and the same
  ``(slots, real)``, and ``stage_partitions_stacked`` (the same numpy
  data; only the dtypes of the index planes differ);
- whole ragged runs (sync int8, FedBuff int8) from the same weights, with
  ``cohort: 0``, no faults and ``max_cohort`` above ``n_clients``, so both
  packages keep every client in ascending order plus pad slots; every
  client's partition repeats one item, so both packages' different batch
  draws give the same batches. Tolerances those of
  ``tests/test_torch_slice.py``: loss rtol 1e-5, params atol 1e-5 / rtol
  1e-4, and on int8 at most 1e-3 of the entries (at least one) may differ
  by more, each by at most one quantum (an int8 rounding flip).

Within the port, bitwise, as ``tests/test_stream.py`` holds the JAX
package: a slot's batch is the dense gather of its client; streaming ==
resident (sync and async); ragged chunked == unchunked; ragged async ==
dense async; a resume mid-stream == the uninterrupted run; a ragged
``{n_clients, cohort}`` campaign is one launch key and every lane its
single run, and so is every lane of a planner's ragged buckets. A
20,000-client population trains at a slab working set under
1 % of what residency would stage; the ragged plane's refusals.
"""
import numpy as np
import pytest
import torch

import jax
from repro.configs.base import FLConfig as JFLConfig
from repro.core.jobs import load_job as j_load_job
from repro.data import pipeline as jpipeline
from repro.models.small import SmallModel as JSmallModel
from repro.runtime.executor import Executor as JExecutor
from repro.runtime.faults import FaultModel as JFaultModel
from repro_torch.configs.base import FLConfig
from repro_torch.core import async_rounds, determinism, rounds
from repro_torch.core.jobs import load_job, validate_cohort
from repro_torch.core.strategies import get_strategy
from repro_torch.data import pipeline
from repro_torch.data.pipeline import SyntheticVision
from repro_torch.interop import to_numpy
from repro_torch.kernels import ops
from repro_torch.models.small import SmallModel
from repro_torch.runtime.campaign import CampaignExecutor
from repro_torch.runtime.executor import Executor
from repro_torch.runtime.faults import FaultModel
from repro_torch.runtime.scheduler import PlanExecutor
from repro_torch.telemetry.recorder import read_events


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


def _raw(sweep=None, strategy="fedavg", runtime=None, **tp):
    params = {"n_clients": 8, "cohort": 4, "max_cohort": 6, "client_lr": 0.1,
              "rounds": 4, "seed": 11, "rounds_per_launch": 2, "batch_size": 4,
              "local_steps": 2}
    params.update(tp)
    raw = {"name": "stream", "model": {"arch": "flsim-cnn"},
           "dataset": {"dataset": "synthetic_vision", "n_items": 128,
                       "distribution": {"partition": "dirichlet",
                                        "dirichlet_alpha": 0.5}},
           "strategy": {"strategy": strategy, "train_params": params},
           "runtime": dict({"straggler_prob": 0.2, "straggler_overprovision": 1.25}
                           if runtime is None else runtime)}
    if sweep:
        raw["sweep"] = sweep
    return raw


def _job(**kw):
    """A ragged job at test size: CNN d_model 8 / d_ff 16, 8 clients, cohort
    4 of max_cohort 6 slots, batch 4, 2 local steps, 128 items."""
    job = load_job(_raw(**kw))
    job.model = SmallModel(job.model.cfg.replace(d_model=8, d_ff=16), "cnn")
    return job


def _run(job, **kw):
    ex = Executor(job, device="cpu", **kw).scaffold()
    state, logger = ex.run()
    return state, logger.series("loss"), ex


def _flat(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _flat(v)]
    return [tree]


def _bitwise(a, b):
    a, b = _flat(a), _flat(b)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# -- the pure parts against the JAX package ----------------------------------

@pytest.mark.parametrize("shape", [(8, 8, 1), (32, 32, 3)])
def test_population_shards_equal_jax_bitwise(shape):
    kw = dict(n_clients=1_000_000, items_per_client=5, shape=shape, seed=3)
    mine, ref = pipeline.SyntheticPopulation(**kw), jpipeline.SyntheticPopulation(**kw)
    for cid in (0, 1, 17, 999_999):
        (x, y), (jx, jy) = mine.shard(cid), ref.shard(cid)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert x.dtype == jx.dtype and y.dtype == jy.dtype


def _partitions(n_clients=6):
    x, y, parts = SyntheticVision(n_items=96, shape=(4, 4, 2), seed=2) \
        .distribute_into_chunks("dirichlet", n_clients, 0.3)
    parts[3] = parts[3][:0]                      # an empty partition
    return x, y, parts


def _stagers(kind, x, y, parts, n_clients):
    kw = dict(n_clients=n_clients, max_cohort=5)
    fl, jfl = FLConfig(**kw), JFLConfig(**kw)
    if kind == "resident":
        return (pipeline.ResidentSlabStager(x, y, parts, fl, FaultModel(), "cpu"),
                jpipeline.ResidentSlabStager(x, y, parts, jfl, JFaultModel()))
    return (pipeline.StreamingSlabStager.from_partitions(x, y, parts, fl, FaultModel(),
                                                         "cpu"),
            jpipeline.StreamingSlabStager.from_partitions(x, y, parts, jfl, JFaultModel()))


@pytest.mark.parametrize("kind", ["resident", "streaming"])
def test_slab_assembly_equals_jax_bitwise(kind):
    x, y, parts = _partitions()
    mine, ref = _stagers(kind, x, y, parts, 6)
    slots = np.array([[0, 2, 3, 5, 0], [1, 3, 4, 1, 1], [2, 5, 2, 2, 2]])
    real = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 0, 0], [1, 1, 0, 0, 0]], np.float32)
    got, want = mine._assemble(slots, real), ref._assemble(slots.astype(np.int32), real)
    assert sorted(got) == sorted(want) == ["cid", "len", "w", "x", "y"]
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["x"].dtype == torch.float32 and got["y"].dtype == torch.int64
    ev = np.array([4, 3, 0, 4, 1])
    got, want = mine._assemble_events(ev), ref._assemble_events(ev.astype(np.int32))
    assert sorted(got) == sorted(want) == ["len", "x", "y"]
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_plan_keeps_the_cohort_mask_in_ascending_slots():
    x, y, parts = _partitions()
    fl = FLConfig(n_clients=6, cohort=3, max_cohort=4, straggler_overprovision=1.5)
    fault = FaultModel(straggler_prob=0.3, drop_prob=0.1, seed=5)
    st = pipeline.ResidentSlabStager(x, y, parts, fl, fault, "cpu")
    slots, real = st.plan(4, 3)
    from repro_torch.runtime.faults import cohort_mask
    for i in range(3):
        kept = np.flatnonzero(cohort_mask(fault, 4 + i, 6, 3, 1.5))
        k = len(kept)
        np.testing.assert_array_equal(slots[i, :k], kept)
        assert (slots[i, k:] == (kept[0] if k else 0)).all()
        np.testing.assert_array_equal(real[i], np.arange(4) < k)


def test_stage_partitions_stacked_equals_jax_bitwise():
    trajs = [SyntheticVision(n_items=64, shape=(4, 4, 1), seed=s)
             .distribute_into_chunks("dirichlet", 5, a) for s, a in ((0, 0.5), (1, 0.1))]
    got = pipeline.stage_partitions_stacked(trajs, "cpu")
    want = jpipeline.stage_partitions_stacked(trajs)
    for k in ("x", "y", "idx", "len"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_slot_batch_is_the_dense_gather_of_its_client_bitwise():
    x, y, parts = _partitions()
    st = pipeline.ResidentSlabStager(x, y, parts, FLConfig(n_clients=6, max_cohort=4),
                                     FaultModel(), "cpu")
    st.widen(st.lmax + 7)                        # a wider pad is never read
    slots = np.array([[5, 0, 2, 5]])
    row = {k: v[0] for k, v in st._assemble(slots, np.ones((1, 4), np.float32)).items()}
    rkey = determinism.round_key(determinism.root_key(4), 9)
    got = pipeline.gather_slab_batches(row, rkey, 5, 3)
    assert got["x"].shape == (4, 3, 5, 4, 4, 2)
    for k, c in enumerate(slots[0]):
        want = pipeline.gather_one_client_batch(st.staged, rkey, int(c), 5, 3)
        assert torch.equal(got["x"][k], want["x"]) and torch.equal(got["y"][k], want["y"])
        ev = pipeline.gather_event_batch({n: v[k] for n, v in row.items()}, rkey,
                                         int(c), 5, 3)
        assert torch.equal(ev["x"], want["x"]) and torch.equal(ev["y"], want["y"])


# -- whole ragged runs against the JAX package --------------------------------

class _OneItemPerClient:
    """Every client's partition repeats one item, so every batch draw of
    either package gives the same batch."""

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


@pytest.mark.parametrize("mode,module", [("sync", rounds), ("async", async_rounds)])
def test_ragged_int8_runs_match_jax(mode, module, monkeypatch):
    kw = dict(n_clients=4, cohort=0, max_cohort=6, rounds=3, rounds_per_launch=3,
              seed=7, compression="int8", error_feedback=False, strategy="compressed",
              runtime={"straggler_prob": 0.0})
    if mode == "async":
        kw.update(mode="async", async_buffer=3, staleness_exponent=0.5, max_staleness=4)
    jjob = j_load_job(_raw(**kw))
    jjob.model = JSmallModel(jjob.model.cfg.replace(d_model=8, d_ff=16), "cnn")
    jjob.dataset = _OneItemPerClient(jjob.dataset)
    jex = JExecutor(jjob).scaffold()
    job = _job(**kw)
    job.dataset = _OneItemPerClient(job.dataset)
    ex = Executor(job, device="cpu").scaffold()
    ex.state = _to_torch(jax.tree.map(np.asarray, jex.state))   # same weights
    scales, calls = [0.0], []
    agg = module.ops.quant_aggregate

    def recording(q, s, w):                  # the largest block scale sent
        scales.append(float(s.max()))
        calls.append(tuple(q.shape))
        return agg(q, s, w)
    monkeypatch.setattr(module.ops, "quant_aggregate", recording)
    jstate, jlog = jex.run()
    state, log = ex.run()
    if mode == "sync":
        assert calls == [(6, calls[0][1])] * 3          # C = max_cohort, once a round
    else:
        assert calls and all(c[0] == 3 for c in calls)  # one launch per flush
    np.testing.assert_allclose(log.series("loss"), jlog.series("loss"), rtol=1e-5)
    want, got = jax.tree.map(np.asarray, jstate["params"]), to_numpy(state["params"])
    quantum = max(scales)
    outside = total = 0
    for k, v in want.items():
        diff = np.abs(got[k] - v)
        assert (diff <= quantum + 1e-5 + 1e-4 * np.abs(v)).all(), k
        outside += int((diff > 1e-5 + 1e-4 * np.abs(v)).sum())
        total += diff.size
    assert outside <= max(1, 1e-3 * total)


# -- the port's own contracts -------------------------------------------------

@pytest.mark.parametrize("compression", ["none", "int8"])
def test_streaming_equals_resident_bitwise(compression):
    kw = dict(compression=compression, error_feedback=False,
              strategy="compressed" if compression == "int8" else "fedavg")
    s_res, l_res, ex = _run(_job(**kw))
    s_str, l_str, ex_str = _run(_job(streaming=True, **kw))
    assert l_res == l_str and _bitwise(s_res, s_str)
    assert ex.stager.peak_slab_bytes == ex_str.stager.peak_slab_bytes > 0
    stats = ex_str.stager.chunk_stats()
    assert [s["prefetched"] for s in stats] == [False, True]   # chunk 2 came from the prefetch
    assert all(s["bytes"] > 0 and s["h2d_ms"] is None for s in stats)


def test_ragged_probes_count_the_real_slots():
    """The ragged round's engine probes, as the JAX package's: participation
    counts the real (non-pad) slots, masked_frac is the slab's pad share."""
    raw = _raw(streaming=True)
    raw["probes"] = {"enabled": True}
    job = load_job(raw)
    job.model = SmallModel(job.model.cfg.replace(d_model=8, d_ff=16), "cnn")
    _, losses, ex = _run(job)
    real = ex.stager.plan(0, 4)[1].sum(-1)
    assert [r["participation"] for r in ex.probe_rows] == real.tolist()
    assert [r["masked_frac"] for r in ex.probe_rows] == \
        np.float32(1.0 - real / 6).tolist()
    s_off, l_off, _ = _run(_job(streaming=True))
    assert losses == l_off                           # probes are read-only


def test_ragged_chunked_equals_unchunked():
    s1, l1, _ = _run(_job(streaming=True, rounds_per_launch=1))
    s4, l4, _ = _run(_job(streaming=True, rounds_per_launch=4))
    s3, l3, _ = _run(_job(rounds_per_launch=3))
    assert l1 == l4 == l3 and _bitwise(s1, s4) and _bitwise(s1, s3)


@pytest.mark.parametrize("async_buffer,compression", [(3, "int8"), (0, "none")])
def test_ragged_async_equals_dense_async_and_streams_bitwise(async_buffer, compression):
    kw = dict(mode="async", async_buffer=async_buffer, max_staleness=2,
              staleness_exponent=0.5, rounds_per_launch=1, rounds=3, n_clients=6,
              cohort=0, max_cohort=6, compression=compression, error_feedback=False,
              strategy="compressed" if compression == "int8" else "fedavg")
    s_dense, l_dense, _ = _run(_job(**dict(kw, max_cohort=0)))
    s_res, l_res, _ = _run(_job(**kw))
    s_str, l_str, ex = _run(_job(streaming=True, **kw))
    assert l_res == l_str and _bitwise(s_res, s_str)
    assert l_dense == l_res and _bitwise(s_dense, s_res), "ragged moved the event stream"
    assert any(s["prefetched"] for s in ex.stager.chunk_stats())


def test_resume_mid_stream_equals_uninterrupted(tmp_path):
    def mk():
        return _job(streaming=True, rounds=6, checkpoint_every=2)
    s_full, l_full, _ = _run(mk())
    Executor(mk(), device="cpu", ckpt_dir=str(tmp_path)).scaffold().run(rounds=4)
    s_res, l_res, ex = _run(mk(), ckpt_dir=str(tmp_path))
    assert ex.round_idx == 6 and l_res == l_full[4:] and _bitwise(s_full, s_res)


@pytest.fixture
def native_convs():
    """Lane == single run holds bit for bit on the CPU with oneDNN's
    convolutions off: oneDNN picks a conv's algorithm by its group
    count, and the lanes run S times a single run's groups. (The tests
    run on one thread, ``one_thread``, which keeps PyTorch's native convs
    quick when test processes share the cores.)"""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.mark.parametrize("streaming", [False, True])
def test_ragged_campaign_is_one_launch_key_and_each_lane_its_single_run(streaming,
                                                                       native_convs):
    kw = dict(streaming=streaming, strategy="compressed", compression="int8",
              error_feedback=False)
    camp = CampaignExecutor(_job(sweep={"n_clients": [6, 8], "cohort": [2, 4]}, **kw),
                            device="cpu").scaffold()
    with ops.quant_agg_scope() as frame:
        camp.run()
    assert camp.compiled_programs() == 1
    assert frame["calls"] == 4                      # one (S, K, N) launch a round
    for s, coord in enumerate(camp.coords):
        single, losses, _ = _run(_job(**dict(kw, **coord)))
        assert _bitwise(camp.trajectory_params(s), single["params"]), coord
        assert [r["loss"] for r in camp.results if r["traj"] == s] == losses


def test_plan_runs_ragged_buckets_whose_lanes_are_their_single_runs(native_convs):
    """The planner buckets ragged lanes by slots, not by cohort: a
    strategy x cohort grid is two buckets, each lane bitwise its run."""
    kw = dict(streaming=True, prox_mu=0.1)
    pe = PlanExecutor(_job(sweep={"strategy": ["fedavg", "fedprox"], "cohort": [2, 4]},
                           **kw), device="cpu").scaffold()
    pe.run()
    assert len(pe.plan.buckets) == 2 and pe.S == 4
    for lane, coord in enumerate(pe.plan.coords):
        single, _, _ = _run(_job(**dict(kw, **coord)))
        assert _bitwise(pe.lane_params(lane), single["params"]), coord


def test_population_trains_at_a_bounded_working_set(tmp_path):
    job = load_job({
        "name": "pop", "model": {"arch": "flsim-logreg"},
        "dataset": {"dataset": "synthetic_population", "items_per_client": 8},
        "strategy": {"strategy": "fedavg",
                     "train_params": {"n_clients": 20_000, "cohort": 8,
                                      "max_cohort": 10, "streaming": True,
                                      "client_lr": 0.1, "rounds": 4, "seed": 1,
                                      "rounds_per_launch": 2, "batch_size": 4,
                                      "local_steps": 1}},
        "telemetry": {"enabled": True, "out_dir": str(tmp_path)},
    })
    assert job.dataset.shape == (28, 28, 1)
    _, logger = Executor(job, device="cpu").scaffold().run()
    assert np.isfinite(logger.series("loss")).all()
    evs = [e["values"] for e in read_events(str(tmp_path))
           if e.get("kind") == "counter" and e.get("name") == "staged_bytes"]
    assert evs[0]["data_plane"] == 0
    slabs = [v for v in evs if "slab" in v]
    assert len(slabs) == 2
    for v in slabs:
        assert v["peak_slab"] == v["slab"] == 2 * 10 * 8 * (784 * 4 + 8) + 2 * 10 * (8 + 8 + 4)
        assert v["resident_equiv"] == 20_000 * 8 * (784 * 4 + 8 + 4) + 20_000 * 4
        assert v["peak_slab"] < 0.01 * v["resident_equiv"]


def test_ragged_refusals():
    base = dict(strategy="compressed", compression="int8")
    for kw, match in (
            (dict(base), "error_feedback"),                      # EF residuals
            (dict(strategy="scaffold"), "client"),
            (dict(strategy="moon"), "client"),
            (dict(topology="decentralized", strategy="gossip"), "decentralized"),
            (dict(placement="temporal"), "spatial placement only"),
            (dict(mode="async", async_buffer=2, sweep={"seed": [0, 1]}), "sync mode only")):
        with pytest.raises(ValueError, match=match):
            _job(**kw)
    # what the JAX package raises at the executor, where the port's load_job did
    fl = FLConfig(strategy="scaffold", max_cohort=4)
    with pytest.raises(ValueError, match="per-client"):
        rounds.check_ragged_support(fl, get_strategy(fl))
    camp = _job(sweep={"seed": [0, 1]})
    # the JAX package's refusal: a ragged campaign does not shard over lanes
    with pytest.raises(NotImplementedError, match="do not shard over a lane mesh"):
        CampaignExecutor(camp, device="cpu", lane_devices=2)
    with pytest.raises(ValueError, match="streaming"):
        Executor(load_job({"model": {"arch": "flsim-logreg"},
                           "dataset": {"dataset": "synthetic_population"},
                           "strategy": {"train_params": {"n_clients": 100, "cohort": 4,
                                                         "max_cohort": 6}}}),
                 device="cpu").scaffold()


@pytest.mark.parametrize("train,match", [
    ({"n_clients": 4, "cohort": 8}, "cohort"),
    ({"n_clients": 8, "cohort": 4, "max_cohort": 2}, "max_cohort"),
    ({"n_clients": 8, "cohort": 4, "streaming": True}, "streaming"),
    ({"n_clients": 8, "cohort": -1}, ">= 0"),
])
def test_cohort_validation_errors(train, match):
    with pytest.raises(ValueError, match=match):
        validate_cohort(FLConfig(**train))
    with pytest.raises(ValueError, match=match):
        load_job({"model": {"arch": "flsim-logreg"},
                  "dataset": {"dataset": "synthetic_vision", "n_items": 32},
                  "strategy": {"strategy": "fedavg", "train_params": train}})
