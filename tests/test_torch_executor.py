"""The port's job loading, data plane and executor (``repro_torch``) against
the JAX package and its own contracts, on the CPU.

Bitwise: partitions and ``SyntheticVision`` data (the same numpy
``RandomState`` code), and chunked == unchunked runs within the port (every
draw is keyed by (seed, absolute round), so chunking changes nothing).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.data import partition as jpartition
from repro.data.pipeline import SyntheticVision as JSyntheticVision
from repro_torch.core import determinism
from repro_torch.core.jobs import load_job
from repro_torch.data import partition
from repro_torch.data.pipeline import (SyntheticVision, gather_client_batches,
                                       stage_partitions)
from repro_torch.kernels import ops
from repro_torch.models.small import SmallModel
from repro_torch.runtime.executor import Executor
from repro_torch.runtime.faults import FaultModel, cohort_mask, select_cohort


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


SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _job(strategy="fedavg", compression="none", rounds=4, rounds_per_launch=2,
         **train):
    """The quickstart's job at test size: CNN d_model 8 / d_ff 16, 4
    clients, batch 4, 2 local steps, 128 items."""
    tp = {"n_clients": 4, "local_steps": 2, "batch_size": 4, "client_lr": 0.05,
          "rounds": rounds, "rounds_per_launch": rounds_per_launch, "seed": 0,
          "compression": compression, "placement": "spatial"}
    tp.update(train)
    job = load_job({
        "name": "quickstart_torch",
        "model": {"arch": "flsim-cnn"},
        "dataset": {"dataset": "synthetic_vision", "n_items": 128,
                    "distribution": {"partition": "dirichlet",
                                     "dirichlet_alpha": 0.5}},
        "strategy": {"strategy": strategy, "train_params": tp},
        "runtime": {"straggler_prob": 0.1, "straggler_overprovision": 1.25},
    })
    job.model = SmallModel(job.model.cfg.replace(d_model=8, d_ff=16), "cnn")
    return job


@pytest.mark.parametrize("kind", ["dirichlet", "iid", "shards"])
def test_partitions_equal_jax_bitwise(kind):
    labels = np.random.RandomState(0).randint(0, 10, 500)
    want = jpartition.partition(kind, labels, 7, 0.5, seed=3)
    got = partition.partition(kind, labels, 7, 0.5, seed=3)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_synthetic_vision_equals_jax_bitwise():
    want = JSyntheticVision(n_items=64, seed=5).distribute_into_chunks(
        "dirichlet", 4, 0.5)
    got = SyntheticVision(n_items=64, seed=5).distribute_into_chunks(
        "dirichlet", 4, 0.5)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g, w)


def test_gather_draws_inside_each_partition():
    x, y, parts = SyntheticVision(n_items=64, seed=1).distribute_into_chunks(
        "dirichlet", 4, 0.5)
    staged = stage_partitions(x, y, parts, "cpu")
    b1 = gather_client_batches(staged, determinism.round_key(7, 3), 5, 2)
    b2 = gather_client_batches(staged, determinism.round_key(7, 3), 5, 2)
    assert b1["x"].shape == (4, 2, 5, 32, 32, 3) and b1["y"].shape == (4, 2, 5)
    assert torch.equal(b1["x"], b2["x"])          # keyed by the round alone
    for c, p in enumerate(parts):
        rows = b1["x"][c].reshape(-1, 32 * 32 * 3).numpy()
        assert all((x.reshape(len(x), -1)[p] == r).all(1).any() for r in rows)


def test_keys_are_pure_and_distinct_per_coordinate():
    root = determinism.root_key(0)
    assert root == determinism.root_key(0) != determinism.root_key(1)
    rk = determinism.round_key(root, 5)
    keys = {rk, determinism.round_key(root, 6), determinism.client_key(rk, 0),
            determinism.client_key(rk, 1), determinism.step_key(rk, 0),
            determinism.batch_key(rk, 0), determinism.cohort_key(0, 5),
            determinism.cohort_key(1, 5)}
    assert len(keys) == 8 and all(0 <= k < 2**64 for k in keys)
    a = torch.rand(4, generator=determinism.generator(rk))
    assert torch.equal(a, torch.rand(4, generator=determinism.generator(rk)))


def test_cohort_mask_semantics_and_host_view():
    fault = FaultModel(straggler_prob=0.3, drop_prob=0.2, seed=4)
    for r in range(5):
        m = cohort_mask(fault, r, 20, 6, overprovision=1.5)
        assert m.dtype == np.float32 and m.shape == (20,)
        assert 0 < m.sum() <= 6
        np.testing.assert_array_equal(m, cohort_mask(fault, r, 20, 6, 1.5))
        np.testing.assert_array_equal(
            select_cohort(fault, r, np.arange(20), 6, 1.5), np.flatnonzero(m))


def test_quickstart_job_lowers_loss_on_cpu():
    ex = Executor(_job(rounds=6, rounds_per_launch=3), device="cpu").scaffold()

    def eval_fn(params):
        x, y, _ = ex.data
        return {"accuracy": ex.job.model.accuracy(
            params, {"x": torch.from_numpy(x[:64]), "y": torch.from_numpy(y[:64])})}

    ex.eval_fn = eval_fn
    _, logger = ex.run()
    losses = logger.series("loss")
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert "accuracy" in logger.rows[2] and "accuracy" in logger.rows[5]
    assert all(r["round_s"] > 0 for r in logger.rows)


@pytest.mark.parametrize("strategy,compression", [("fedavg", "none"),
                                                  ("compressed", "int8")])
def test_chunked_equals_unchunked_bitwise(strategy, compression):
    runs = []
    for chunk in (2, 1):
        st, lg = Executor(_job(strategy, compression, rounds_per_launch=chunk),
                          device="cpu").scaffold().run()
        runs.append((st, lg.series("loss")))
    (s2, l2), (s1, l1) = runs
    assert l2 == l1
    assert all(torch.equal(s2["params"][k], s1["params"][k]) for k in s2["params"])
    if compression == "int8":
        r2, r1 = s2["clients"]["residual"], s1["clients"]["residual"]
        assert all(torch.equal(r2[k], r1[k]) for k in r2)


def test_int8_job_routes_through_quant_aggregate_once_per_round():
    with ops.quant_agg_scope() as frame:
        Executor(_job("compressed", "int8", rounds=3), device="cpu").scaffold().run()
    assert frame["calls"] == 3 and frame["last_impl"] == "plain"
    with ops.quant_agg_scope() as frame:
        Executor(_job("fedavg", "none", rounds=3), device="cpu").scaffold().run()
    assert frame["calls"] == 0


def test_executor_raises_without_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Executor(_job())
    Executor(_job(), device="cpu")


def test_load_job_rejects_typos_with_a_hint():
    with pytest.raises(KeyError, match="did you mean 'client_lr'"):
        _job(cleint_lr=0.1)
    with pytest.raises(KeyError, match="did you mean 'runtime'"):
        load_job({"runtim": {}})
    for bad in ({"mode": "asinc"}, {"placement": "spatiall"}):
        with pytest.raises(ValueError, match="unknown"):
            _job(**bad)


# the ids keep the cases' first numbering: cases 3 and 9-11 (comms,
# blockchain, n_workers, byzantine_workers) went with their refusals, and
# run in test_load_job_runs_what_slice_6_ported; cases 0-2 (sweep,
# telemetry, probes) likewise, in test_load_job_runs_what_slice_7_ported;
# cases 4 and 6-8 (the streaming client plane) in
# test_load_job_runs_what_slice_8_ported; cases 5 and 13 (synthetic_lm,
# qwen2.5-32b) in test_load_job_runs_what_slice_9_ported, their places taken
# by two archs then refused; case 12's minicpm3-4b (MLA) was ported in slice
# 10, its place taken by jamba-1.5-large-398b (hybrid). Slice 12 ported the
# last three archs (ROADMAP A15.5, A15.6): the cases keep their ids and now
# hold that each job loads with its family's model.
@pytest.mark.parametrize("patch,item", [
    ({"model": {"arch": "whisper-base"}}, "A15"),
    ({"model": {"arch": "jamba-1.5-large-398b"}}, "A15"),
    ({"model": {"arch": "xlstm-125m"}}, "A15"),
], ids=[f"patch{i}-{item}" for i, item in zip((5, 12, 13), ("A15", "A15", "A15"))])
def test_load_job_refuses_what_is_not_yet_ported(patch, item):
    raw = {"model": {"arch": "flsim-cnn"},
           "strategy": {"strategy": patch.get("strategy", "fedavg"),
                        "train_params": dict(patch.get("train", {}))}}
    for k in ("sweep", "telemetry", "probes", "comms", "model", "dataset"):
        if k in patch:
            raw[k] = patch[k]
    job = load_job(raw)
    family = {"whisper-base": ("encdec", "EncDecModel"), "xlstm-125m": ("ssm", "Model"),
              "jamba-1.5-large-398b": ("hybrid", "Model")}[patch["model"]["arch"]]
    assert (job.model.cfg.family, type(job.model).__name__) == family
    assert job.model.cfg.name == patch["model"]["arch"]


@pytest.mark.parametrize("section", [
    {"sweep": {"seed": [0, 1]}},                            # A12
    {"telemetry": {"enabled": True}},                       # A11
    {"probes": {"enabled": True}},                          # A11
])
def test_load_job_runs_what_slice_7_ported(section):
    raw = {"model": {"arch": "flsim-cnn"},
           "strategy": {"strategy": "fedavg", "train_params": {"rounds": 1}}}
    job = load_job(dict(raw, **section))
    if "sweep" in section:
        assert job.sweep.size == 2
        return
    _, logger = Executor(job, device="cpu").scaffold().run()
    assert len(logger.rows) == 1 and np.isfinite(logger.rows[0]["loss"])


# the refusals these cases replace were patch4 and patch6-8 of
# test_load_job_refuses_what_is_not_yet_ported and the two cases of
# test_load_job_refuses_a_ragged_campaign; the population runs with the
# ragged and streaming settings it needs
@pytest.mark.parametrize("patch", [
    {"dataset": {"dataset": "synthetic_population"},
     "train": {"max_cohort": 16, "streaming": True}},
    {"train": {"max_cohort": 16, "mode": "async"}},
    {"train": {"max_cohort": 16}},
    {"train": {"max_cohort": 16, "streaming": True}},
    {"sweep": {"seed": [0, 1]}, "train": {"max_cohort": 16}},
    {"sweep": {"seed": [0, 1]}, "train": {"max_cohort": 16, "streaming": True}},
], ids=["patch4-population", "patch6-async", "patch7-ragged", "patch8-streaming",
        "campaign-ragged", "campaign-streaming"])
def test_load_job_runs_what_slice_8_ported(patch):
    from repro_torch.runtime.campaign import CampaignExecutor
    raw = {"model": {"arch": "flsim-cnn"},
           "strategy": {"strategy": "fedavg",
                        "train_params": dict(patch["train"], rounds=1)}}
    for k in ("sweep", "dataset"):
        if k in patch:
            raw[k] = patch[k]
    job = load_job(raw)
    if "sweep" in patch:
        ex = CampaignExecutor(job, device="cpu").scaffold()
        assert ex.stager.streaming == bool(patch["train"].get("streaming"))
    else:
        ex = Executor(job, device="cpu").scaffold()
    _, logger = ex.run()
    assert ex.ragged and ex.staged is None
    assert len(logger.rows) == 1 and np.isfinite(logger.rows[0]["loss"])


@pytest.mark.parametrize("patch", [
    {"dataset": {"dataset": "synthetic_lm"}},
    {"model": {"arch": "qwen2.5-32b"}},
], ids=["patch5-synthetic_lm", "patch13-qwen2.5-32b"])
def test_load_job_runs_what_slice_9_ported(patch):
    """An LM arch and the LM dataset load; the executor sends an LM job to
    ``repro_torch.launch.train_fl_lm`` (its partitioned staging cannot hold
    token streams, as the JAX package's cannot)."""
    raw = dict({"strategy": {"strategy": "fedavg", "train_params": {"rounds": 1}}}, **patch)
    job = load_job(raw)
    if "model" in patch:
        assert job.model.cfg.qkv_bias and job.model.cfg.d_model == 5120
        return
    assert job.dataset.vocab == 512 and job.dataset.seed == job.fl.seed
    with pytest.raises(ValueError, match="repro_torch.launch.train_fl_lm"):
        Executor(job, device="cpu").scaffold()


@pytest.mark.parametrize("train", [
    {"mode": "async"},                                      # A10: FedAsync
    {"placement": "temporal"},                              # A9
    {"topology": "decentralized"},                          # A6
    {"strategy": "fedprox", "prox_mu": 0.1},                # A5
    {"strategy": "compressed", "compression": "topk"},      # A5
])
def test_load_job_runs_what_slice_5_ported(train):
    train = dict(train)
    job = _job(train.pop("strategy", "fedavg"), rounds=1, **train)
    _, logger = Executor(job, device="cpu").scaffold().run()
    assert len(logger.rows) == 1 and np.isfinite(logger.rows[0]["loss"])


@pytest.mark.parametrize("train,section", [
    ({"n_workers": 3, "byzantine_workers": 1, "consensus": "majority_digest"}, None),
    ({"n_workers": 4, "byzantine_workers": 1, "consensus": "median",
      "placement": "temporal"}, None),
    ({"blockchain": "hashchain", "mode": "async", "digest_every_events": 2}, None),
    ({}, {"comms": {"enabled": True, "pods": 2}}),
])
def test_load_job_runs_what_slice_6_ported(train, section):
    raw = {"model": {"arch": "flsim-logreg"},
           "strategy": {"strategy": "fedavg",
                        "train_params": dict(n_clients=4, rounds=1, **train)}}
    raw.update(section or {})
    ex = Executor(load_job(raw), device="cpu").scaffold()
    _, logger = ex.run()
    assert len(logger.rows) == 1 and np.isfinite(logger.rows[0]["loss"])
    if "blockchain" in train:
        assert ex.job.ledger.verify() and len(ex.job.ledger.blocks()) > 1
    if section:
        assert len(ex.comms_rows) == 1


def test_load_job_refuses_an_unknown_consensus_with_a_hint():
    with pytest.raises(ValueError, match="did you mean 'median'"):
        _job(n_workers=3, consensus="medain")
    with pytest.raises(KeyError, match="LedgerBackend"):
        _job(blockchain="ethereum")


@pytest.mark.parametrize("strategy", ["scaffold", "moon"])
@pytest.mark.parametrize("train", [{"mode": "async"}, {"mode": "async", "async_buffer": 2},
                                   {"placement": "temporal"}])
def test_load_job_refuses_client_state_where_the_driver_carries_none(strategy, train):
    with pytest.raises(ValueError, match=f"strategy '{strategy}' reads per-client state"):
        _job(strategy, **train)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) > 15, mods\n"
        "assert {'repro_torch.models.ssm', 'repro_torch.configs.whisper_base',"
        " 'repro_torch.configs.xlstm_125m',"
        " 'repro_torch.configs.jamba_1_5_large_398b', 'repro_torch.sharding.axes',"
        " 'repro_torch.sharding.specs', 'repro_torch.launch.mesh',"
        " 'repro_torch.launch.steps'} <= set(mods), mods\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'repro' or k.startswith('repro.')]\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_quickstart_runs_on_the_cpu(capsys):
    from repro_torch.launch import quickstart
    logger = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "== FL dashboard: quickstart (5 rounds) ==" in out
    assert out.rstrip().endswith("quickstart OK")
    assert logger.rows[-1]["loss"] < logger.rows[0]["loss"] and "accuracy" in logger.rows[-1]
