"""The port's round probes (``core/probes.py`` and their wiring through the
spatial, temporal and async round loops and the executor) against the JAX
package and their own contracts, on the CPU.

- The probe dict of one spatial and one temporal round of both packages'
  round functions, from the same carried-across state with the same numpy
  batches and weights, and the per-round probe rows of a 2-round async run
  of both executors (every client's partition repeats one item, so any
  batch draw of either package gives the same batch; the schedules are
  bitwise equal): allclose at rtol 1e-3 / atol 1e-5 (norms of sums that
  XLA and PyTorch take in other orders; ``drift_norm`` is the square root
  of a difference of such sums, hence the looser rtol than the params'
  1e-4); on int8 ``sat_frac`` within 1e-3 (a value within float noise of a
  rounding boundary can quantize one step apart, as in
  ``tests/test_torch_slice.py``). Participation, masked fraction,
  nonfinite and the host-side extras exactly.
- Within the port, bitwise: probes on == off for every round loop, probe values
  the same for every chunking, a dead campaign lane's probes zero, and
  ``on_divergence: freeze`` the identity on a finite run.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.base import FLConfig as JFLConfig
from repro.configs.flsim_small import FLSIM_CNN as J_CNN
from repro.core import determinism as jdet
from repro.core import probes as jprobes
from repro.core.jobs import load_job as j_load_job
from repro.core.rounds import build_spatial_round as j_build_spatial_round
from repro.core.rounds import build_temporal_round as j_build_temporal_round
from repro.core.rounds import init_state as j_init_state
from repro.core.strategies import get_strategy as j_get_strategy
from repro.models.small import SmallModel as JSmallModel
from repro.runtime.executor import Executor as JExecutor
from repro.sharding.axes import AxisCtx
from repro_torch.configs.base import FLConfig, get_config
from repro_torch.core import probes
from repro_torch.core.jobs import load_job
from repro_torch.core.rounds import build_spatial_round, build_temporal_round
from repro_torch.core.strategies import get_strategy
from repro_torch.interop import state_from_numpy
from repro_torch.models.small import SmallModel
from repro_torch.runtime.campaign import CampaignExecutor
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


RTOL, ATOL, SAT_TOL = 1e-3, 1e-5, 1e-3
C, STEPS, B = 4, 2, 4


def _models():
    jm = JSmallModel(J_CNN.replace(d_model=8, d_ff=16), "cnn")
    m = SmallModel(get_config("flsim-cnn").replace(d_model=8, d_ff=16), "cnn")
    return jm, m


def _compare(got: dict, want: dict):
    for name, v in want.items():
        tol = SAT_TOL if name == "sat_frac" else ATOL
        np.testing.assert_allclose(float(got[name]), float(v), rtol=RTOL, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("placement", ["spatial", "temporal"])
@pytest.mark.parametrize("strategy,compression", [("fedavg", "none"),
                                                  ("compressed", "int8")])
def test_round_probes_match_jax(placement, strategy, compression):
    kw = dict(n_clients=C, local_steps=STEPS, batch_size=B, client_lr=0.05,
              strategy=strategy, compression=compression, placement=placement)
    jfl, fl = JFLConfig(**kw), FLConfig(**kw)
    jm, m = _models()
    jstrat, strat = j_get_strategy(jfl), get_strategy(fl)
    if placement == "spatial":
        jround = j_build_spatial_round(jm, jstrat, jfl, probes=True)
        pround = build_spatial_round(m, strat, fl, probes=True)
    else:
        jround = j_build_temporal_round(jm, jstrat, jfl, J_CNN, probes=True)
        pround = build_temporal_round(m, strat, fl, probes=True)
    jstate = j_init_state(jm, jstrat, jfl, jdet.root_key(0), n_clients_local=C)
    state = state_from_numpy(jax.tree.map(np.asarray, jstate))
    jitted = jax.jit(lambda s, b, w, k: jround(AxisCtx(), s, b, w, k))
    rng = np.random.RandomState(3)
    for r in range(2):
        x = rng.randn(C, STEPS, B, 32, 32, 3).astype(np.float32)
        y = rng.randint(0, 10, (C, STEPS, B))
        w = rng.uniform(0.5, 2.0, C).astype(np.float32)
        w[r] = 0.0
        jstate, jmet = jitted(
            jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, jnp.asarray(w),
            jdet.round_key(jdet.root_key(0), r))
        state, met = pround(state, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
                            torch.from_numpy(w), r)
        want = {k: np.asarray(v) for k, v in jmet["probes"].items()}
        assert set(met["probes"]) == set(want)
        _compare(met["probes"], want)
        assert float(met["probes"]["nonfinite"]) == 0.0


class _OneItemPerClient:
    """Every client partition repeats one item: any draw, the same batch."""

    def __init__(self, dataset):
        self.dataset = dataset

    def distribute_into_chunks(self, kind, n_clients, alpha=0.5):
        x, y = self.dataset.prepare_root_dataset()
        return x, y, [np.full(3 + c, 5 * c, np.int64) for c in range(n_clients)]


def _raw(mode="sync", rounds=3, chunk=1, probes=None, seed=7, strategy="fedavg",
         sweep=None, runtime=None, **train):
    tp = {"n_clients": C, "local_steps": STEPS, "batch_size": B, "client_lr": 0.1,
          "rounds": rounds, "seed": seed, "rounds_per_launch": chunk}
    if mode == "async":
        tp.update(mode="async", async_buffer=3, max_staleness=4, staleness_exponent=0.5)
    tp.update(train)
    raw = {"name": "probes", "model": {"arch": "flsim-cnn"},
           "dataset": {"dataset": "synthetic_vision", "n_items": 128},
           "strategy": {"strategy": strategy, "train_params": tp},
           "runtime": runtime if runtime is not None else
           {"straggler_prob": 0.2, "duration_sigma": 0.25, "rate_spread": 0.5}}
    for k, v in (("probes", probes), ("sweep", sweep)):
        if v is not None:
            raw[k] = v
    return raw


def _job(raw):
    job = load_job(raw)
    job.model = SmallModel(job.model.cfg.replace(d_model=8, d_ff=16), "cnn")
    return job


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_torch(v) for v in tree)
    return torch.tensor(np.asarray(tree))


@pytest.mark.parametrize("async_buffer,strategy,compression", [
    (3, "compressed", "int8"),       # FedBuff on int8
    (0, "fedavg", "none"),           # FedAsync
])
def test_async_probe_rows_match_jax(async_buffer, strategy, compression):
    raw = _raw("async", rounds=2, probes={"enabled": True}, strategy=strategy,
               compression=compression, async_buffer=async_buffer)
    jjob = j_load_job(raw)
    jjob.model = JSmallModel(jjob.model.cfg.replace(d_model=8, d_ff=16), "cnn")
    jjob.dataset = _OneItemPerClient(jjob.dataset)
    jex = JExecutor(jjob).scaffold()
    job = _job(raw)
    job.dataset = _OneItemPerClient(job.dataset)
    ex = Executor(job, device="cpu").scaffold()
    ex.state = _to_torch(jax.tree.map(np.asarray, jex.state))   # same weights
    jex.run()
    ex.run()
    assert len(ex.probe_rows) == len(jex.probe_rows) == 2
    for got, want in zip(ex.probe_rows, jex.probe_rows):
        assert set(got) == set(want)
        for k in ("round", "participation", "masked_frac", "nonfinite", "buffer_occ"):
            assert got[k] == pytest.approx(want[k], abs=1e-7), k
        _compare(got, {k: want[k] for k in ("update_norm", "drift_norm", "sat_frac",
                                            "ef_residual_norm")})


def test_helpers_match_jax():
    rng = np.random.RandomState(0)
    q = rng.randint(-127, 128, (5, 512)).astype(np.int8)
    q[0, :40] = 127
    s = rng.uniform(1e-3, 1e-2, (5, 2)).astype(np.float32)
    w = rng.uniform(0, 1, 5).astype(np.float32)
    tq, ts, tw = (torch.from_numpy(a) for a in (q, s, w))
    np.testing.assert_allclose(probes.packed_sq_norms(tq, ts),
                               jprobes.packed_sq_norms(q, s), rtol=1e-6)
    np.testing.assert_allclose(probes.packed_sq_norm(tq[1], ts[1]),
                               jprobes.packed_sq_norm(q[1], s[1]), rtol=1e-6)
    assert float(probes.sat_frac(tq)) == float(jprobes.sat_frac(q))
    sq = rng.uniform(0, 2, 5).astype(np.float32)
    np.testing.assert_allclose(probes.drift_from_moments(tw, torch.from_numpy(sq),
                                                         torch.tensor(0.3)),
                               jprobes.drift_from_moments(w, sq, 0.3), rtol=1e-6)
    tree = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    np.testing.assert_allclose(probes.tree_norm(_to_torch(tree)), jprobes.tree_norm(tree),
                               rtol=1e-6)
    bad = dict(tree, b=np.array([1.0, np.nan, 0.0], np.float32))
    assert float(probes.tree_nonfinite(_to_torch(bad))) == 1.0
    assert float(probes.tree_nonfinite(_to_torch(tree))) == 0.0
    accept = rng.rand(40) < 0.8
    apply = rng.rand(40) < 0.3
    np.testing.assert_array_equal(probes.buffer_occupancy(accept, apply),
                                  jprobes.buffer_occupancy(accept, apply))
    st = rng.randint(0, 9, 30)
    assert probes.staleness_hist(st, 4) == jprobes.staleness_hist(st, 4)
    assert probes.PROBE_NAMES == jprobes.PROBE_NAMES
    assert probes.ASYNC_REDUCE == jprobes.ASYNC_REDUCE


def _bitwise(a, b):
    fa, fb = _flat(a), _flat(b)
    return len(fa) == len(fb) and all(torch.equal(x, y) for x, y in zip(fa, fb))


def _flat(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _flat(v)]
    return [tree]


@pytest.mark.parametrize("mode,train", [
    ("sync", {"strategy": "compressed", "compression": "int8"}),
    ("sync", {"placement": "temporal"}),
    ("sync", {"strategy": "gossip", "topology": "decentralized"}),
    ("async", {"strategy": "compressed", "compression": "int8"}),
    ("async", {"async_buffer": 0}),
])
def test_probe_values_are_the_same_for_every_chunking(mode, train):
    rows = []
    for chunk in (1, 3):
        ex = Executor(_job(_raw(mode, chunk=chunk, probes={"enabled": True}, **train)),
                      device="cpu").scaffold()
        ex.run()
        rows.append(ex.probe_rows)
    assert rows[0] == rows[1] and len(rows[0]) == 3
    assert set(rows[0][0]) >= {"round", *probes.PROBE_NAMES}


def test_dead_lanes_emit_zero_probes():
    """A dropped lane holds its state and its probes read 0 in the round;
    its rows stop landing in probes.csv."""
    ex = CampaignExecutor(_job(_raw(sweep={"seed": [0, 1]}, probes={"enabled": True},
                                    strategy="compressed", compression="int8")),
                          device="cpu", lane_scheduling=True).scaffold()
    ex.run(1)
    ex.drop_lane(1)
    before = {k: v[1].clone() for k, v in ex.state["params"].items()}
    captured = []
    orig = ex._capture_probes
    ex._capture_probes = lambda start, n, pr, **kw: (captured.append(pr), orig(start, n, pr, **kw))
    ex.run(2)
    assert np.all(np.asarray(captured[-1])[1] == 0.0)
    assert np.any(np.asarray(captured[-1])[0] != 0.0)
    assert all(torch.equal(ex.state["params"][k][1], v) for k, v in before.items())
    assert [r["traj"] for r in ex.probe_rows if r["round"] == 1] == [0]


def test_divergence_sentinel_reports_and_freeze_holds_finite_state():
    raw = _raw(rounds=2, client_lr=1e30)
    report = Executor(_job(dict(raw, probes={"enabled": True})), device="cpu").scaffold()
    report.run()
    assert report.probe_rows[-1]["nonfinite"] == 1.0
    assert not all(torch.isfinite(p).all() for p in report.state["params"].values())
    frozen = Executor(_job(dict(raw, probes={"enabled": True, "on_divergence": "freeze"})),
                      device="cpu").scaffold()
    init = {k: v.clone() for k, v in frozen.state["params"].items()}
    frozen.run()
    assert all(torch.equal(frozen.state["params"][k], v) for k, v in init.items())


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_freeze_is_the_identity_on_a_finite_run(mode):
    a = Executor(_job(_raw(mode, probes={"enabled": True})), device="cpu").scaffold()
    b = Executor(_job(_raw(mode, probes={"enabled": True, "on_divergence": "freeze"})),
                 device="cpu").scaffold()
    a.run()
    b.run()
    assert _bitwise(a.state, b.state) and a.probe_rows == b.probe_rows


def test_probes_section_is_validated():
    with pytest.raises(KeyError, match="did you mean 'on_divergence'"):
        load_job(_raw(probes={"on_divergance": "freeze"}))
    with pytest.raises(ValueError, match="on_divergence"):
        load_job(_raw(probes={"on_divergence": "halt"}))
    with pytest.raises(ValueError, match="needs probes.enabled"):
        load_job(_raw(probes={"enabled": False, "on_divergence": "freeze"}))
    assert not probes.ProbeSpec.from_job(load_job(_raw())).enabled


def test_probes_csv_lands_beside_the_checkpoints(tmp_path):
    ex = Executor(_job(_raw("async", probes={"enabled": True})), device="cpu",
                  ckpt_dir=str(tmp_path)).scaffold()
    ex.run()
    rows = probes.read_probes(tmp_path / "probes.csv")
    assert rows == ex.probe_rows
    assert list(rows[0])[:2] == ["round", "buffer_occ"]
