"""The comms plane of the port (``core/netmodel.py``, ``telemetry/comms.py``
and the executor's accounting) against the JAX package and its own
contracts, on the CPU.

- The byte model's invariants (ports of the campaign-free cases of
  ``tests/test_comms.py``): int8 ~ dense/4 + scales, top-k pairs, dense
  downlinks, gossip symmetry and step scaling, the hierarchical split, the
  consensus overlay, masked and rejected clients billing no uplink, one
  block per round with a ledger, seed-pure tiered links, schedules
  unchanged by the link knobs.
- The same rows as the JAX package where the two packages keep the same
  clients: the cohort mask keeps everyone (cohort = n_clients, no
  stragglers or drops) or the job is async (the schedule is the JAX
  package's, bit for bit). Byte columns exactly, ``sim_time_s`` at rtol
  1e-9 (f64 host arithmetic on the same Philox columns).
- Comms on == off bitwise in the three round loops (spatial, temporal, async),
  and rows the same for every chunking.
"""
import types

import numpy as np
import pytest
import torch

import jax
from repro.configs.base import FLConfig as JFLConfig
from repro.core import netmodel as jnet
from repro.core.jobs import load_job as j_load_job
from repro.core.probes import read_probes as j_read_probes
from repro.runtime.clock import ClientSystemModel as JCSM
from repro.runtime.clock import build_schedule as j_build_schedule
from repro.runtime.executor import Executor as JExecutor
from repro_torch.configs.base import FLConfig
from repro_torch.core import netmodel
from repro_torch.core.jobs import load_job
from repro_torch.core.netmodel import (LaneComms, client_links, consensus_nbytes,
                                       dense_nbytes, gossip_matrix, hierarchical_nbytes,
                                       round_nbytes, shape_template, topk_nbytes,
                                       uplink_nbytes)
from repro_torch.core.packing import QBLOCK
from repro_torch.core.probes import read_probes
from repro_torch.runtime.clock import ClientSystemModel, build_schedule
from repro_torch.runtime.executor import Executor
from repro_torch.telemetry.comms import CommsSpec


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


_COMMS_ON = {"enabled": True}
_EQUAL_SPEEDS = {"duration_sigma": 0.0, "rate_spread": 0.0, "straggler_prob": 0.0}
# block-aligned shapes so the int8 padding overhead is purely the scales
_TPL = [netmodel._ShapeLeaf((256, 8)), netmodel._ShapeLeaf((256,))]


def _raw(*, mode="sync", rounds=4, chunk=2, comms=None, runtime=None, seed=3,
         strategy="fedavg", **tp_extra):
    tp = {"n_clients": 4, "local_epochs": 1, "client_lr": 0.1,
          "rounds": rounds, "seed": seed, "rounds_per_launch": chunk}
    if mode == "async":
        tp.update({"mode": "async", "async_buffer": 3, "max_staleness": 4,
                   "staleness_exponent": 0.5})
    tp.update(tp_extra)
    raw = {"name": "comms-test", "model": {"arch": "flsim-logreg"},
           "dataset": {"dataset": "synthetic_vision", "n_items": 128,
                       "distribution": {"partition": "dirichlet",
                                        "dirichlet_alpha": 0.5}},
           "strategy": {"strategy": strategy, "train_params": tp}}
    for key, val in (("comms", comms), ("runtime", runtime)):
        if val is not None:
            raw[key] = val
    return raw


def _run(raw, **kw):
    ex = Executor(load_job(raw), device="cpu", **kw).scaffold()
    state, logger = ex.run()
    return ex, state, logger


def _bitwise(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# -- payload sizes ------------------------------------------------------------------

def test_int8_bytes_quarter_dense_plus_scales():
    dense = dense_nbytes(_TPL)
    int8 = uplink_nbytes(_TPL, FLConfig(compression="int8"))
    n = sum(leaf.size for leaf in _TPL)
    assert int8 == n + 4 * (n // QBLOCK)
    assert 0.25 * dense < int8 <= 0.30 * dense


def test_topk_bytes_are_index_value_pairs():
    fl = FLConfig(compression="topk", topk_ratio=0.1)
    n = sum(leaf.size for leaf in _TPL)
    assert uplink_nbytes(_TPL, fl) == 8 * int(np.ceil(0.1 * n))
    assert topk_nbytes(_TPL, 1e-9) == 8     # at least one coordinate


def test_downlink_is_always_dense():
    up, down = netmodel.payload_nbytes(_TPL, FLConfig(compression="int8"))
    assert down == dense_nbytes(_TPL) and up < down


@pytest.mark.parametrize("compression", ["none", "int8", "topk"])
def test_payload_bytes_equal_the_jax_package_on_a_real_model(compression):
    """The flsim-cnn param tree of each package: the same (up, down)."""
    from repro.configs.flsim_small import FLSIM_CNN as J_CNN
    from repro.models.small import SmallModel as JSmallModel
    from repro_torch.configs.base import get_config
    from repro_torch.models.small import SmallModel
    jp = JSmallModel(J_CNN, "cnn").init(jax.random.PRNGKey(0))
    p = SmallModel(get_config("flsim-cnn"), "cnn").init(torch.Generator())
    kw = dict(compression=compression, topk_ratio=0.1)
    got = netmodel.payload_nbytes(shape_template(p), FLConfig(**kw))
    assert got == jnet.payload_nbytes(jnet.shape_template(jp), JFLConfig(**kw))
    assert got[1] == 4 * 188_810


# -- traffic-matrix invariants --------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 3])
def test_gossip_matrix_symmetric_and_scales_with_steps(steps):
    m = gossip_matrix(6, 1000, steps)
    np.testing.assert_array_equal(m, m.T)
    assert np.diagonal(m).sum() == 0
    assert m.sum() == 6 * 2 * 1000 * steps
    np.testing.assert_array_equal(m, steps * gossip_matrix(6, 1000, 1))
    np.testing.assert_array_equal(m, jnet.gossip_matrix(6, 1000, steps))


def test_gossip_matrix_degenerate_sizes():
    assert gossip_matrix(1, 1000).sum() == 0
    m = gossip_matrix(2, 10)
    assert m[0, 1] == m[1, 0] == 20


def test_hierarchical_two_tier_split():
    intra, cross = hierarchical_nbytes(400, 1600, 1000, pods=4)
    assert intra == 2000 and cross == 2 * 4 * 1000
    sb = dense_nbytes(_TPL)
    total = round_nbytes(_TPL, FLConfig(topology="hierarchical", n_clients=4), pods=4)
    assert total == 4 * 2 * sb + 2 * 4 * sb


def test_consensus_overlay_bytes():
    sb = dense_nbytes(_TPL)
    assert consensus_nbytes(FLConfig(n_workers=1), sb) == 0
    assert consensus_nbytes(FLConfig(n_workers=3), sb) == 3 * 2 * sb + 3 * 2 * 16


@pytest.mark.parametrize("kw", [dict(), dict(compression="int8"), dict(topology="decentralized"),
                                dict(n_workers=3, blockchain="hashchain", cohort=2)])
def test_round_nbytes_equals_the_jax_package(kw):
    kw = dict(kw, n_clients=4)
    assert round_nbytes(_TPL, FLConfig(**kw), pods=2) == \
        jnet.round_nbytes(_TPL, JFLConfig(**kw), pods=2)


def test_masked_clients_bill_zero_uplink():
    fl = FLConfig(n_clients=8, cohort=3)
    lane = LaneComms(fl=fl, csm=ClientSystemModel(seed=0), template=_TPL)
    cols = lane.sync_rounds(0, 4)
    up, down = netmodel.payload_nbytes(_TPL, fl)
    assert (cols["up_bytes"] == 3 * up).all() and (cols["down_bytes"] == 3 * down).all()


def test_rejected_async_arrivals_bill_zero_uplink():
    fl = FLConfig(n_clients=4)

    def sched(accept):
        return types.SimpleNamespace(
            client=np.array([0, 1, 2, 3, 0, 1, 2, 3]), task=np.zeros(8, np.int32),
            accept=np.asarray(accept, bool), vtime=np.linspace(1.0, 8.0, 8))

    lane = LaneComms(fl=fl, csm=ClientSystemModel(seed=0), template=_TPL)
    cols = lane.async_rounds(0, 2, sched([True, False, True, False] * 2), events_per_round=4)
    assert (cols["up_bytes"] == 2 * lane.up_payload).all()
    assert (cols["down_bytes"] == 4 * lane.down_payload).all()
    lane2 = LaneComms(fl=fl, csm=ClientSystemModel(seed=0), template=_TPL)
    cols2 = lane2.async_rounds(0, 2, sched([False] * 8), events_per_round=4)
    assert (cols2["up_bytes"] == 0).all() and (cols2["down_bytes"] > 0).all()


def test_decentralized_rounds_symmetric_and_scale_with_steps():
    def total_up(steps):
        fl = FLConfig(n_clients=4, topology="decentralized", gossip_steps=steps)
        cols = LaneComms(fl=fl, csm=ClientSystemModel(seed=0), template=_TPL).sync_rounds(0, 2)
        assert (cols["up_bytes"] == cols["down_bytes"]).all()
        return cols["up_bytes"].sum()
    assert total_up(3) == 3 * total_up(1)


def test_blockchain_block_billed_per_round():
    fl = FLConfig(n_clients=4, blockchain="hashchain")
    cols = LaneComms(fl=fl, csm=ClientSystemModel(seed=0), template=_TPL).sync_rounds(0, 3)
    assert (cols["overlay_bytes"] == netmodel.BLOCK_NBYTES).all()


# -- LinkModel ------------------------------------------------------------------------

def test_client_links_deterministic_tiered_and_the_jax_package_s():
    csm = ClientSystemModel(seed=7, link_tiers=4)
    a, b = client_links(csm, 16), client_links(csm, 16)
    np.testing.assert_array_equal(a.up_Bps, b.up_Bps)
    assert len(np.unique(a.up_Bps)) > 1
    np.testing.assert_array_equal(client_links(csm, 8).up_Bps, a.up_Bps[:8])
    assert len(np.unique(client_links(ClientSystemModel(seed=7), 16).up_Bps)) == 1
    want = jnet.client_links(JCSM(seed=7, link_tiers=4), 16)
    np.testing.assert_array_equal(a.up_Bps, want.up_Bps)
    np.testing.assert_array_equal(a.down_Bps, want.down_Bps)


def test_schedule_bitwise_invariant_to_link_knobs():
    w = np.ones(4, np.float32)
    plain = build_schedule(ClientSystemModel(seed=3), 4, 16, w)
    linked = build_schedule(ClientSystemModel(seed=3, link_tiers=4, up_mbps=10.0,
                                              latency_s=0.2), 4, 16, w)
    for f in ("client", "task", "accept", "vtime", "staleness"):
        np.testing.assert_array_equal(getattr(plain, f), getattr(linked, f))


# -- the same rows as the JAX package ----------------------------------------------------

ROW_CASES = {   # FLConfig over n_clients=4 (cohort = all, no stragglers or drops)
    "fedavg": {},
    "int8": dict(strategy="compressed", compression="int8"),
    "topk": dict(strategy="compressed", compression="topk", topk_ratio=0.1),
    "gossip": dict(strategy="gossip", topology="decentralized", gossip_steps=2),
    "hierarchical": dict(strategy="clustered", topology="hierarchical"),
    "n_workers_3": dict(n_workers=3, byzantine_workers=1),
    "hashchain": dict(blockchain="hashchain"),
    "fedbuff": dict(mode="async", async_buffer=3),
    "fedasync": dict(mode="async", async_buffer=0),
}


def _templates():
    """Each package's flsim-cnn params (the shapes the executors price)."""
    from repro.configs.flsim_small import FLSIM_CNN as J_CNN
    from repro.models.small import SmallModel as JSmallModel
    from repro_torch.configs.base import get_config
    from repro_torch.models.small import SmallModel
    cfg = dict(d_model=8, d_ff=16)
    return (shape_template(SmallModel(get_config("flsim-cnn").replace(**cfg), "cnn")
                           .init(torch.Generator())),
            jnet.shape_template(JSmallModel(J_CNN.replace(**cfg), "cnn")
                                .init(jax.random.PRNGKey(0))))


@pytest.mark.parametrize("case", list(ROW_CASES))
def test_comms_rows_equal_the_jax_package(case):
    """The port's and the JAX package's accountants over 5 rounds, as
    their executors drive them (3 + 2), from each package's params, fault
    model and (async) schedule: byte columns exactly, sim_time_s at 1e-9."""
    kw = dict(ROW_CASES[case], n_clients=4, seed=3)
    rt = dict(duration_sigma=0.25, rate_spread=0.5, link_tiers=3, latency_s=0.02)
    tpl, jtpl = _templates()
    fl, jfl = FLConfig(**kw), JFLConfig(**kw)
    csm, jcsm = ClientSystemModel(seed=3, **rt), JCSM(seed=3, **rt)
    ours = LaneComms(fl=fl, csm=csm, template=tpl, pods=2)
    theirs = jnet.LaneComms(fl=jfl, csm=jcsm, template=jtpl, pods=2)
    w = np.arange(1, 5, dtype=np.float32)
    if fl.mode == "async":
        epr = fl.async_buffer if fl.async_buffer > 1 else fl.n_clients
        sk = dict(buffer_size=fl.async_buffer, staleness_exponent=0.5, max_staleness=4)
        s, js = build_schedule(csm, 4, 5 * epr, w, **sk), j_build_schedule(jcsm, 4, 5 * epr, w, **sk)
        got = [ours.async_rounds(a, n, s, epr) for a, n in ((0, 3), (3, 2))]
        want = [theirs.async_rounds(a, n, js, epr) for a, n in ((0, 3), (3, 2))]
    else:
        got = [ours.sync_rounds(a, n) for a, n in ((0, 3), (3, 2))]
        want = [theirs.sync_rounds(a, n) for a, n in ((0, 3), (3, 2))]
    for g, wnt in zip(got, want):
        assert g.keys() == wnt.keys() == set(netmodel.COMMS_COLUMNS)
        for k in g:
            if k.endswith("_s"):
                np.testing.assert_allclose(g[k], wnt[k], rtol=1e-9, err_msg=k)
            else:
                np.testing.assert_array_equal(g[k], wnt[k], err_msg=k)
    assert ours.summary()["up_bytes"] == theirs.summary()["up_bytes"] > 0


def test_executor_rows_equal_the_jax_executor_s(tmp_path):
    """End to end: both executors on the same fedavg job (cohort = all),
    comms.csv written and read back."""
    raw = _raw(comms={"enabled": True, "out_dir": str(tmp_path / "port")}, rounds=3)
    ex, _, logger = _run(raw)
    jraw = _raw(comms={"enabled": True, "out_dir": str(tmp_path / "jax")}, rounds=3)
    jex = JExecutor(j_load_job(jraw)).scaffold()
    jex.run()
    assert len(ex.comms_rows) == 3
    for row, jrow in zip(ex.comms_rows, jex.comms_rows):
        assert row.keys() == jrow.keys()
        for k, v in jrow.items():
            assert row[k] == pytest.approx(v, rel=1e-9) if k.endswith("_s") else row[k] == v
    assert read_probes(tmp_path / "port" / "comms.csv") == ex.comms_rows
    assert j_read_probes(tmp_path / "jax" / "comms.csv")[0].keys() == ex.comms_rows[0].keys()
    assert all("sim_time_s" in r and "cum_bytes" in r for r in logger.rows)
    assert ex._comms_summaries()[0]["up_bytes"] == jex._comms_summaries()[0]["up_bytes"]


# -- bitwise on == off, chunking invariance ----------------------------------------------

@pytest.mark.parametrize("tp", [dict(), dict(placement="temporal"), dict(mode="async")],
                         ids=["spatial", "temporal", "async"])
def test_bitwise_comms_on_vs_off(tp):
    ex_on, s_on, log_on = _run(_raw(comms=_COMMS_ON, **tp))
    _, s_off, log_off = _run(_raw(**tp))
    assert _bitwise(s_on["params"], s_off["params"])
    assert log_on.series("loss") == log_off.series("loss")
    assert len(ex_on.comms_rows) == 4
    assert [r["sim_time_s"] for r in log_on.rows] == [r["sim_time_s"] for r in ex_on.comms_rows]


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_comms_rows_chunking_invariant(mode):
    ex1, _, _ = _run(_raw(mode=mode, chunk=1, comms=_COMMS_ON))
    ex4, _, _ = _run(_raw(mode=mode, chunk=4, comms=_COMMS_ON))
    assert ex1.comms_rows == ex4.comms_rows


def test_sim_clock_seed_pure_and_stragglers_mask_the_uplink():
    ex1, _, _ = _run(_raw(comms=_COMMS_ON, cohort=2, runtime={"straggler_prob": 0.3}))
    ex2, _, _ = _run(_raw(comms=_COMMS_ON, cohort=2, runtime={"straggler_prob": 0.3}))
    assert ex1.comms_rows == ex2.comms_rows
    assert (np.diff([r["sim_time_s"] for r in ex1.comms_rows]) > 0).all()
    up = ex1._comms.up_payload
    assert all(r["up_bytes"] == 2 * up for r in ex1.comms_rows)


def test_sync_matches_equal_speeds_fedbuff():
    """Equal speeds, FedBuff buffer == cohort: the sync makespan composition
    and the vtime-shifted async one agree."""
    ex_s, _, _ = _run(_raw(comms=_COMMS_ON, runtime=_EQUAL_SPEEDS))
    ex_a, _, _ = _run(_raw(mode="async", comms=_COMMS_ON, runtime=_EQUAL_SPEEDS,
                           async_buffer=4, max_staleness=4, staleness_exponent=0.0))
    np.testing.assert_allclose([r["sim_time_s"] for r in ex_s.comms_rows],
                               [r["sim_time_s"] for r in ex_a.comms_rows], rtol=1e-9)


# -- plumbing ----------------------------------------------------------------------------

def test_comms_csv_falls_back_to_ckpt_dir_and_memory(tmp_path):
    ex, _, _ = _run(_raw(comms=_COMMS_ON, rounds=2), ckpt_dir=str(tmp_path))
    assert read_probes(tmp_path / "comms.csv") == ex.comms_rows
    ex, _, _ = _run(_raw(comms=_COMMS_ON))
    assert ex._comms_path() is None and len(ex.comms_rows) == 4
    _, _, logger = _run(_raw())
    assert "sim_time_s" not in logger.rows[0]


def test_comms_spec_validation():
    with pytest.raises(ValueError, match="pods"):
        CommsSpec(enabled=True, pods=0)
    with pytest.raises(ValueError, match="pods"):
        load_job(_raw(comms={"pods": 0}))
    with pytest.raises(KeyError, match="enabled"):
        load_job(_raw(comms={"enabld": True}))
    assert not CommsSpec.from_job(load_job(_raw())).enabled
    assert not CommsSpec.from_job(load_job(_raw(comms={"enabled": False}))).enabled
    assert CommsSpec.from_job(load_job(_raw(comms={"enabled": True, "pods": 2}))).pods == 2


def test_shape_template_strips_leading():
    t = {"w": np.zeros((3, 4, 5))}
    assert dense_nbytes(shape_template(t)) == 4 * 60
    assert dense_nbytes(shape_template(t, strip_leading=True)) == 4 * 20


def test_decentralized_executor_prices_one_model():
    ex, _, _ = _run(_raw(comms=_COMMS_ON, strategy="gossip", topology="decentralized",
                         rounds=1))
    assert ex.state["params"]["w"].shape[0] == 4
    assert ex._comms.state_nbytes == 4 * (784 * 10 + 10)


# -- satellites of tests/test_comms.py: topology hint, schedule validation, vtime

def test_get_topology_did_you_mean():
    from repro_torch.core.topology import get_topology
    with pytest.raises(ValueError, match="client_server"):
        get_topology("client-server")
    with pytest.raises(ValueError, match="known"):
        get_topology("zzz")


def test_build_schedule_rejects_degenerate_inputs():
    with pytest.raises(ValueError, match="n_events"):
        build_schedule(ClientSystemModel(seed=0), 4, 0, np.ones(4, np.float32))
    with pytest.raises(ValueError, match="n_clients"):
        build_schedule(ClientSystemModel(seed=0), 0, 8, np.ones(0, np.float32))


def test_async_rows_carry_vtime_without_comms():
    _, _, logger = _run(_raw(mode="async"))
    vt = [r["vtime"] for r in logger.rows]
    assert len(vt) == 4 and vt == sorted(vt) and vt[0] > 0
