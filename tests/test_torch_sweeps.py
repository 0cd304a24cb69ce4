"""The port's campaigns (``core/sweeps.py``, ``runtime/campaign.py``, the
lane forms of the round loops) against the JAX package and their own
contracts, on the CPU.

- ``parse_sweep``/``expand`` give the JAX package's coordinates in its
  order, and ``scalar_plane`` its values (exactly: host bookkeeping).
- The lane round: S lanes of the port's round under ``torch.func.vmap``
  against ``jax.vmap`` of the reference round, each lane fed its own numpy
  batches, weights and scalars from the same weights. Tolerances those of
  ``tests/test_torch_temporal.py``: loss rtol 1e-5, params atol 1e-5 /
  rtol 1e-4; on int8 at most 1e-3 of the entries (and at least one) may
  differ by more, each by at most one quantum (bounded here by 1e-3: the
  sends' deltas stay below 0.13).
- Within the port, bitwise: lane s == the single run of the s-th config
  (sync spatial and temporal, async FedBuff and FedAsync, int8 and not;
  with oneDNN's convolutions off, see ``native_convs``),
  chunked == unchunked under the lane dim, a resumed campaign == the
  uninterrupted one, and each lane's ledger digests == its single run's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.base import FLConfig as JFLConfig
from repro.configs.flsim_small import FLSIM_CNN as J_CNN
from repro.core import determinism as jdet
from repro.core import sweeps as jsweeps
from repro.core.rounds import build_spatial_round as j_build_spatial_round
from repro.core.rounds import build_temporal_round as j_build_temporal_round
from repro.core.rounds import init_state as j_init_state
from repro.core.strategies import get_strategy as j_get_strategy
from repro.models.small import SmallModel as JSmallModel
from repro.sharding.axes import AxisCtx
from repro_torch.configs.base import FLConfig, get_config
from repro_torch.core import determinism, sweeps
from repro_torch.core.jobs import load_job
from repro_torch.core.rounds import build_spatial_round, build_temporal_round
from repro_torch.core.strategies import get_strategy
from repro_torch.interop import state_from_numpy, to_numpy
from repro_torch.kernels import ops
from repro_torch.models.small import SmallModel
from repro_torch.runtime.campaign import CampaignExecutor, lane_of, read_results
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


S, C, STEPS, B = 2, 4, 2, 4
# the largest int8 step of these rounds' sends (client deltas below 0.13 in
# magnitude, 127 steps a side): an int8 rounding flip moves the aggregate by
# at most this much
QUANTUM = 1e-3
HETERO = {"straggler_prob": 0.2, "duration_sigma": 0.25, "rate_spread": 0.5}

SPECS = [{"seed": [3, 1, 2]},
         {"seeds": [0, 1], "client_lr": [0.05, 0.1], "dirichlet_alpha": [0.3]},
         {"strategy": ["fedprox", "fedavg"], "mode": ["sync", "async"], "prox_mu": [0.0, 0.01]},
         {"compression": ["none", "int8"], "async_buffer": [0, 4], "staleness_exponent": [0.5]},
         {"n_clients": [4, 8], "cohort": [2], "server_lr": [1, 0.5]}]


@pytest.mark.parametrize("spec", SPECS)
def test_grid_and_scalar_plane_match_jax(spec):
    got, want = sweeps.parse_sweep(spec), jsweeps.parse_sweep(spec)
    assert got.axes == want.axes and got.names == want.names and got.size == want.size
    assert got.coords() == want.coords()
    assert got.categorical_names == want.categorical_names
    fl, jfl = FLConfig(rounds=3), JFLConfig(rounds=3)
    fls, jfls = sweeps.expand(fl, got), jsweeps.expand(jfl, want)
    assert [vars(f) for f in fls] == [vars(f) for f in jfls]
    plane, jplane = sweeps.scalar_plane(fls, "cpu"), jsweeps.scalar_plane(jfls)
    assert set(plane) == set(jplane)
    for k, v in jplane.items():
        np.testing.assert_array_equal(plane[k].numpy(), np.asarray(v))
    assert plane["seed"].dtype == torch.int64 and plane["client_lr"].dtype == torch.float32
    keys = sweeps.root_keys(fls, "cpu")
    assert keys.tolist() == [determinism.signed(determinism.root_key(f.seed)) for f in fls]


@pytest.mark.parametrize("bad,err,match", [
    ({"sede": [0]}, KeyError, "did you mean 'seed'"),
    ({"seed": [0, 0]}, ValueError, "repeats"),
    ({"seed": []}, ValueError, "non-empty"),
    ({"seed": [0], "seeds": [1]}, ValueError, "duplicates"),
    ({"strategy": ["fedavgg"]}, KeyError, "did you mean 'fedavg'"),
    ([1, 2], ValueError, "mapping"),
])
def test_bad_sweeps_fail_like_the_jax_package(bad, err, match):
    with pytest.raises(err, match=match):
        sweeps.parse_sweep(bad)
    with pytest.raises(err):
        jsweeps.parse_sweep(bad)


def _stack(trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _stack([t[k] for t in trees]) for k in t0}
    if isinstance(t0, tuple):
        return tuple(_stack(list(v)) for v in zip(*trees))
    return np.stack(trees)


@pytest.mark.parametrize("placement,strategy,compression", [
    ("spatial", "fedavg", "none"), ("spatial", "compressed", "int8"),
    ("temporal", "compressed", "int8")])
def test_lane_round_matches_jax_vmap(placement, strategy, compression):
    kw = dict(n_clients=C, local_steps=STEPS, batch_size=B, strategy=strategy,
              compression=compression, placement=placement)
    jfl, fl = JFLConfig(**kw), FLConfig(**kw)
    jm = JSmallModel(J_CNN.replace(d_model=8, d_ff=16), "cnn")
    m = SmallModel(get_config("flsim-cnn").replace(d_model=8, d_ff=16), "cnn")
    jstrat, strat = j_get_strategy(jfl), get_strategy(fl)
    if placement == "spatial":
        jr, pr = j_build_spatial_round(jm, jstrat, jfl), build_spatial_round(m, strat, fl)
    else:
        jr, pr = (j_build_temporal_round(jm, jstrat, jfl, J_CNN),
                  build_temporal_round(m, strat, fl))
    jstates = [jax.tree.map(np.asarray, j_init_state(jm, jstrat, jfl, jdet.root_key(s),
                                                     n_clients_local=C)) for s in range(S)]
    jstate = jax.tree.map(jnp.asarray, _stack(jstates))
    state = state_from_numpy(_stack(jstates))
    jfls = [JFLConfig(**kw, client_lr=lr) for lr in (0.05, 0.1)]
    jhyper = jsweeps.scalar_plane(jfls)
    hyper = sweeps.scalar_plane([FLConfig(**kw, client_lr=lr) for lr in (0.05, 0.1)], "cpu")
    jstep = jax.jit(jax.vmap(lambda st, b, w, k, h: jr(AxisCtx(), st, b, w, k, h)))
    pstep = torch.func.vmap(pr)
    rng = np.random.RandomState(9)
    for r in range(2):
        x = rng.randn(S, C, STEPS, B, 32, 32, 3).astype(np.float32)
        y = rng.randint(0, 10, (S, C, STEPS, B))
        w = rng.uniform(0.5, 2.0, (S, C)).astype(np.float32)
        w[:, r] = 0.0
        jkeys = jnp.stack([jdet.round_key(jdet.root_key(s), r) for s in range(S)])
        jstate, jmet = jstep(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                             jnp.asarray(w), jkeys, jhyper)
        keys = determinism.round_key(sweeps.root_keys(jfls, "cpu"), r)
        with ops.quant_agg_scope() as frame:
            state, met = pstep(state, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
                               torch.from_numpy(w), keys, hyper)
        assert frame["calls"] == (1 if compression == "int8" else 0)   # all lanes at once
        np.testing.assert_allclose(met["loss"].numpy(), np.asarray(jmet["loss"]), rtol=1e-5)
        got, want = to_numpy(state["params"]), jax.tree.map(np.asarray, jstate["params"])
        outside = total = 0
        for k, v in want.items():
            diff = np.abs(got[k] - v)
            assert (diff <= QUANTUM + 1e-5 + 1e-4 * np.abs(v)).all(), (k, diff.max())
            outside += int((diff > 1e-5 + 1e-4 * np.abs(v)).sum())
            total += diff.size
        assert outside <= (max(1, 1e-3 * total) if compression == "int8" else 0)


# -- within the port: lane == single run -------------------------------------

def _raw(mode="sync", rounds=2, chunk=1, seed=7, sweep=None, strategy="fedavg",
         runtime=None, **train):
    tp = {"n_clients": C, "local_steps": STEPS, "batch_size": B, "client_lr": 0.1,
          "rounds": rounds, "seed": seed, "rounds_per_launch": chunk}
    if mode == "async":
        tp.update(mode="async", async_buffer=3, max_staleness=4, staleness_exponent=0.5)
    tp.update(train)
    raw = {"name": "sweep", "model": {"arch": "flsim-cnn"},
           "dataset": {"dataset": "synthetic_vision", "n_items": 128},
           "strategy": {"strategy": strategy, "train_params": tp},
           "runtime": dict(HETERO if runtime is None else runtime)}
    if sweep is not None:
        raw["sweep"] = sweep
    return raw


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


def _flat(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _flat(v)]
    return [tree]


def _bitwise(a, b):
    fa, fb = _flat(a), _flat(b)
    return len(fa) == len(fb) and all(torch.equal(x, y) for x, y in zip(fa, fb))


SWEEP = {"seed": [0, 1], "client_lr": [0.05, 0.1]}
CASES = {
    "sync_fedavg": ("sync", {}),
    "sync_int8": ("sync", {"strategy": "compressed", "compression": "int8"}),
    "temporal_int8": ("sync", {"strategy": "compressed", "compression": "int8",
                               "placement": "temporal"}),
    "fedprox_mu": ("sync", {"strategy": "fedprox", "prox_mu": 0.1}),
    "fedbuff_int8": ("async", {"strategy": "compressed", "compression": "int8"}),
    "fedasync": ("async", {"async_buffer": 0}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_lane_s_is_the_single_run_of_its_config_bitwise(case, native_convs):
    mode, train = CASES[case]
    sweep = dict(SWEEP, **({"prox_mu": [0.01, 0.1]} if case == "fedprox_mu" else {}))
    ex = CampaignExecutor(_job(_raw(mode, sweep=sweep, **train)), device="cpu").scaffold()
    with ops.quant_agg_scope() as frame:
        ex.run()
    if case in ("sync_int8", "temporal_int8"):
        assert frame["calls"] == 2                      # one per round, every lane
    for s, fl_s in enumerate(ex.fls):
        tp = {k: getattr(fl_s, k) for k in sweep}
        single = Executor(_job(_raw(mode, **dict(train, **tp))), device="cpu").scaffold()
        _, logger = single.run()
        assert _bitwise(lane_of(ex.state, s), single.state), (case, s)
        assert [r["loss"] for r in ex.results if r["traj"] == s] == logger.series("loss")


@pytest.mark.parametrize("case", ["sync_int8", "fedbuff_int8"])
def test_chunked_equals_unchunked_under_the_lane_dim(case):
    mode, train = CASES[case]
    runs = []
    for chunk in (1, 3):
        ex = CampaignExecutor(_job(_raw(mode, rounds=3, chunk=chunk, sweep=SWEEP, **train)),
                              device="cpu").scaffold()
        ex.run()
        runs.append(ex)
    assert _bitwise(runs[0].state, runs[1].state)
    key = lambda r: (r["traj"], r["round"])     # rows land chunk by chunk
    assert [r["loss"] for r in sorted(runs[0].results, key=key)] == \
        [r["loss"] for r in sorted(runs[1].results, key=key)]


def test_scalar_sweeps_stage_one_dataset_and_seeds_one_each():
    one = CampaignExecutor(_job(_raw(sweep={"client_lr": [0.05, 0.1, 0.2]})),
                           device="cpu").scaffold()
    two = CampaignExecutor(_job(_raw(sweep={"seed": [0, 1], "client_lr": [0.05, 0.1]})),
                           device="cpu").scaffold()
    assert one.staged["x"].shape[0] == 128 and list(one.lane_ds) == [0, 0, 0]
    assert two.staged["x"].shape[0] == 256 and list(two.lane_ds) == [0, 0, 1, 1]
    assert two.staged["idx"].shape[:2] == (4, C) and two.staged["len"].shape == (4, C)


def test_results_table_resume_and_grid_check(tmp_path):
    raw = _raw(rounds=4, sweep=SWEEP, strategy="compressed", compression="int8",
               checkpoint_every=2)
    full = CampaignExecutor(_job(raw), device="cpu", out_dir=str(tmp_path / "full"))
    full.scaffold().run()
    rows = read_results(tmp_path / "full" / "campaign.csv")
    assert len(rows) == 4 * 4 and list(rows[0])[:4] == ["seed", "client_lr", "traj", "round"]
    assert [r["loss"] for r in rows] == [r["loss"] for r in full.results]
    ck, out = str(tmp_path / "ck"), str(tmp_path / "part")
    CampaignExecutor(_job(raw), device="cpu", ckpt_dir=ck, out_dir=out).scaffold().run(2)
    resumed = CampaignExecutor(_job(raw), device="cpu", ckpt_dir=ck, out_dir=out).scaffold()
    assert resumed.round_idx == 2
    resumed.run()
    assert _bitwise(resumed.state, full.state)
    strip = lambda rs: [{k: v for k, v in r.items() if k != "round_s"} for r in rs]
    assert strip(read_results(tmp_path / "part" / "campaign.csv")) == strip(rows)
    other = dict(raw, sweep={"seed": [3, 5], "client_lr": [0.05, 0.1]})
    with pytest.raises(ValueError, match="another sweep grid"):
        CampaignExecutor(_job(other), device="cpu", ckpt_dir=ck).scaffold()


def test_each_lanes_ledger_digests_are_its_single_runs(native_convs):
    raw = _raw(sweep={"seed": [0, 1]}, blockchain="hashchain")
    ex = CampaignExecutor(_job(raw), device="cpu").scaffold()
    ex.run()
    for s, seed in enumerate((0, 1)):
        single = Executor(_job(_raw(seed=seed, blockchain="hashchain")),
                          device="cpu").scaffold()
        single.run()
        for r in range(2):
            assert ex.kv.get(f"global_digest/{r}/traj{s}") == single.kv.get(f"global_digest/{r}")
    assert ex.job.ledger.verify()


def test_campaign_refusals():
    # two lane ranks wanted, one process visible: lane_mesh's error
    with pytest.raises(ValueError, match=r"lane_mesh\(2\) wants 2 devices but only 1 are visible"):
        CampaignExecutor(_job(_raw(sweep=SWEEP)), device="cpu", lane_devices=2)
    with pytest.raises(ValueError, match="PlanExecutor"):
        CampaignExecutor(_job(_raw(sweep={"strategy": ["fedavg", "fedprox"]})),
                         device="cpu")
    with pytest.raises(ValueError, match="sweep"):
        CampaignExecutor(_job(_raw()), device="cpu")
