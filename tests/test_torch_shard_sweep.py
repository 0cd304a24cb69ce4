"""Device-parallel campaigns in the port: the sweep axis sharded over a lane
mesh (``launch/mesh.lane_mesh``, ``runtime/campaign.CampaignExecutor(
lane_devices=)``, ``runtime/scheduler.PlanExecutor(lane_devices=)``): the
port of ``tests/test_shard_sweep.py``'s nine contracts, on 4 ``gloo`` ranks
(``launch/mesh.spawn``, once for the file) and, for chunking, on a 2-rank
lane mesh inside them (ranks 2-3 outside it).

Lane ``s`` of a sharded campaign is bitwise the same campaign's one-process
lane and an independent single run, for sync and async (FedBuff) buckets,
with and without a lane scheduler, across chunkings and across a resume,
elastic between 4 ranks and 1. S that does not split over the ranks pads
with dead lanes (``alive = 0``, the select a scheduler drop uses), which
never reach the results table; ``campaign.csv`` is written once, by rank 0.
The one-process references and single runs run in the test process.
This module imports no JAX: the spawned ranks import it.
"""
import csv
import os

import numpy as np
import pytest
import torch

RANKS = 4
GRID8 = {"seeds": [3, 5], "dirichlet_alpha": [0.3, 3.0], "client_lr": [0.05, 0.1]}
GRID6 = {"seeds": [3, 5, 7], "client_lr": [0.05, 0.1]}
GRID4 = {"seeds": [3, 5], "client_lr": [0.05, 0.1]}
ASYNC8 = {"seeds": [7, 9], "staleness_exponent": [0.0, 1.0], "client_lr": [0.05, 0.1]}
PLAN = {"strategy": ["fedavg", "fedprox"], "seeds": [3, 5, 7]}


def _raw(coord=None, sweep=None, *, mode="sync", rounds=3, chunk=3, ckpt_every=0):
    """One job dict; ``coord`` overrides land in their sections (the
    single-run references of each lane are built this way)."""
    coord = coord or {}
    tp = {"n_clients": 4, "local_epochs": 1, "client_lr": coord.get("client_lr", 0.1),
          "rounds": rounds, "seed": coord.get("seed", 3), "rounds_per_launch": chunk,
          "checkpoint_every": ckpt_every}
    runtime = {"straggler_prob": 0.2, "straggler_overprovision": 1.25}
    if mode == "async":
        tp.update({"mode": "async", "async_buffer": 3, "max_staleness": 4,
                   "staleness_exponent": coord.get("staleness_exponent", 0.5)})
        runtime = {"straggler_prob": 0.2, "duration_sigma": 0.25}
    raw = {"name": "shard-test", "model": {"arch": "flsim-logreg"},
           "dataset": {"dataset": "synthetic_vision", "n_items": 96,
                       "distribution": {"partition": "dirichlet",
                                        "dirichlet_alpha": coord.get("dirichlet_alpha", 0.5)}},
           "strategy": {"strategy": coord.get("strategy", "fedavg"), "train_params": tp},
           "runtime": runtime}
    if sweep:
        raw["sweep"] = sweep
    return raw


def _camp(raw, lane_devices=0, **kw):
    from repro_torch.core.jobs import load_job
    from repro_torch.runtime.campaign import CampaignExecutor
    return CampaignExecutor(load_job(raw), device="cpu", lane_devices=lane_devices, **kw)


def _np(params: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def _plan(lane_devices):
    from repro_torch.core.jobs import load_job
    from repro_torch.runtime.scheduler import PlanExecutor, SuccessiveHalving
    return PlanExecutor(load_job(_raw(sweep=PLAN, rounds=3, chunk=1)), device="cpu",
                        scheduler=SuccessiveHalving(rung_every=1, min_lanes=2),
                        lane_devices=lane_devices).scaffold()


def rank_body(rank, world, tmp):
    """One rank of every contract; returns what the test process checks."""
    import torch.distributed as dist

    from repro_torch.configs.base import MeshConfig
    from repro_torch.launch.mesh import lane_mesh

    torch.set_num_threads(1)
    out = {}
    # 1. the sharded sync grid; the planes' placement
    ex = _camp(_raw(sweep=GRID8), RANKS).scaffold()
    ex.run()
    out["grid8"] = dict(params=_np(ex.gather_trajectories()), S=ex.S, S_pad=ex.S_pad,
                        thread_alive=ex._thread_alive, block=(ex.block.start, ex.block.stop),
                        idx=tuple(ex.staged["idx"].shape), x=ex.staged["x"].shape[0],
                        state=next(iter(ex.state["params"].values())).shape[0])
    # 2. padding: S = 6 over 4 ranks -> 8, the table written once
    ex = _camp(_raw(sweep=GRID6), RANKS, out_dir=os.path.join(tmp, "pad")).scaffold()
    ex.run()
    out["pad"] = dict(params=_np(ex.gather_trajectories()), S=ex.S, S_pad=ex.S_pad,
                      alive=ex.alive.tolist(), thread_alive=ex._thread_alive,
                      scheduling=ex.lane_scheduling, trajs=sorted({r["traj"] for r in ex.results}),
                      rows=len(ex.results), rank_round_s=ex.rank_round_s)
    # 3. chunking invariance on a 2-rank lane mesh, sync and async
    for mode in ("sync", "async"):
        for chunk in (1, 3, 2):
            try:
                ex = _camp(_raw(sweep=GRID4, mode=mode, chunk=chunk), 2).scaffold()
            except ValueError as e:            # ranks 2-3: outside the mesh
                assert rank >= 2 and "outside the lane mesh" in str(e), e
                continue
            ex.run()
            out[("chunk", mode, chunk)] = _np(ex.gather_trajectories())
    # 4. an async FedBuff grid
    ex = _camp(_raw({"seed": 7}, sweep=ASYNC8, mode="async", chunk=2), RANKS).scaffold()
    ex.run()
    out["async"] = dict(params=_np(ex.gather_trajectories()), uniq=len(ex.uniq_schedules),
                        lane_sched=list(ex.lane_sched), S=ex.S)
    # 5. the planner with successive halving: buckets of 3 lanes pad to 4
    pe = _plan(RANKS)
    pe.run()
    out["plan"] = dict(dropped=dict(pe.dropped), S=[(x.S, x.S_pad) for x in pe.execs],
                       params=[_np(x.gather_trajectories()) for x in pe.execs],
                       lane_ids=[list(b.lane_ids) for b in pe.plan.buckets])
    # 6. checkpoint resume under the mesh
    ck = os.path.join(tmp, "ckpt")
    full = _camp(_raw(sweep=GRID4, rounds=4, chunk=2), RANKS).scaffold()
    full.run()
    out["full4"] = _np(full.gather_trajectories())
    ex = _camp(_raw(sweep=GRID4, rounds=4, chunk=2, ckpt_every=2), RANKS, ckpt_dir=ck,
               out_dir=os.path.join(tmp, "ck_out")).scaffold()
    ex.run(rounds=2)                                   # the crash after a chunk
    ex2 = _camp(_raw(sweep=GRID4, rounds=4, chunk=2, ckpt_every=2), RANKS, ckpt_dir=ck,
                out_dir=os.path.join(tmp, "ck_out")).scaffold()
    out["resume_round"] = ex2.round_idx
    ex2.run()
    out["resumed"] = _np(ex2.gather_trajectories())
    # 7. elastic: saved on 4 ranks, resumed on 1; saved on 1, resumed on 4
    raw6 = _raw(sweep=GRID6, rounds=4, chunk=2, ckpt_every=2)
    ck41 = os.path.join(tmp, "ck_4_1")
    _camp(raw6, RANKS, ckpt_dir=ck41).scaffold().run(rounds=2)
    if rank == 0:
        one = _camp(raw6, 0, ckpt_dir=ck41).scaffold()
        out["elastic41_round"] = one.round_idx
        one.run()
        out["elastic41"] = _np(one.gather_trajectories())
        two = _camp(raw6, 0, ckpt_dir=os.path.join(tmp, "ck_1_4")).scaffold()
        two.run(rounds=2)
    dist.barrier()
    back = _camp(raw6, RANKS, ckpt_dir=os.path.join(tmp, "ck_1_4")).scaffold()
    out["elastic14_round"] = back.round_idx
    back.run()
    out["elastic14"] = _np(back.gather_trajectories())
    # 8. MeshConfig's lane axis
    cfg = MeshConfig(lanes=RANKS)
    mesh = lane_mesh(cfg)
    on = _camp(_raw(sweep=GRID4), cfg)
    off = _camp(_raw(sweep=GRID4), MeshConfig())
    out["meshcfg"] = (tuple(mesh.mesh_dim_names), tuple(mesh.shape), on.lane_devices,
                      on.mesh is not None, off.lane_devices, off.mesh is None)
    # 9. more lanes than ranks
    try:
        lane_mesh(RANKS + 1)
    except ValueError as e:
        out["too_many"] = str(e)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.mesh import spawn

    tmp = str(tmp_path_factory.mktemp("shard_sweep"))
    return spawn(rank_body, RANKS, "cpu", tmp), tmp


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _eq(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _single(coord, **kw):
    from repro_torch.core.jobs import load_job
    from repro_torch.runtime.executor import Executor
    state, _ = Executor(load_job(_raw(coord, **kw)), device="cpu").scaffold().run()
    return _np(state["params"])


def _lanes_match(sharded: dict, sweep, **kw):
    """Every lane: sharded == one-process lane == its single run."""
    one = _camp(_raw(sweep=sweep, **kw)).scaffold()
    one.run()
    for s, coord in enumerate(one.spec.coords()):
        lane = {k: v[s] for k, v in sharded.items()}
        _eq(lane, _np(one.trajectory_params(s)))
        _eq(lane, _single(coord, **kw))


def _same_on_every_rank(ranks, key):
    for r in range(1, len(ranks)):
        _eq(ranks[r][key]["params"], ranks[0][key]["params"])


def test_sharded_sync_campaign_bitwise(runs):
    ranks, _ = runs
    _same_on_every_rank(ranks, "grid8")
    for r, o in enumerate(ranks):
        assert o["grid8"]["S"] == 8 and o["grid8"]["S_pad"] == 8 and not o["grid8"]["thread_alive"]
        # the lanes' planes and state are the rank's block, the roots whole
        assert o["grid8"]["block"] == (2 * r, 2 * r + 2)
        assert o["grid8"]["idx"][0] == 2 and o["grid8"]["state"] == 2
        assert o["grid8"]["x"] == 4 * 96                   # 4 unique roots, all staged
    _lanes_match(ranks[0]["grid8"]["params"], GRID8)


def test_sharded_padding_is_dead_lane_maskwork(runs):
    from repro_torch.runtime.campaign import read_results

    ranks, tmp = runs
    _same_on_every_rank(ranks, "pad")
    o = ranks[0]["pad"]
    assert o["S"] == 6 and o["S_pad"] == 8
    assert o["thread_alive"] and not o["scheduling"]
    assert o["alive"] == [1, 1, 1, 1, 1, 1, 0, 0]
    assert o["trajs"] == list(range(6)) and o["rows"] == 6 * 3
    assert all(len(per) == RANKS for per in o["rank_round_s"])
    _lanes_match(o["params"], GRID6)
    rows = read_results(os.path.join(tmp, "pad", "campaign.csv"))
    one = _camp(_raw(sweep=GRID6)).scaffold()
    one.run()
    assert [{k: v for k, v in r.items() if k != "round_s"} for r in rows] == \
        [{k: v for k, v in r.items() if k != "round_s"} for r in read_results_of(one)]
    with open(os.path.join(tmp, "pad", "campaign.csv")) as f:
        assert len(list(csv.reader(f))) == 6 * 3 + 1     # one header, one writer


def read_results_of(ex):
    """The one-process campaign's rows as ``campaign.csv`` gives them back."""
    import tempfile

    from repro_torch.runtime.campaign import read_results
    with tempfile.TemporaryDirectory() as d:
        return read_results(ex.write_results(d))


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_sharded_chunking_invariance(runs, mode):
    ranks, _ = runs
    got = {c: ranks[0][("chunk", mode, c)] for c in (1, 3, 2)}
    assert ("chunk", mode, 1) not in ranks[2]
    _eq(got[1], got[3])
    _eq(got[1], got[2])
    _eq(ranks[1][("chunk", mode, 2)], got[2])


def test_sharded_async_campaign_bitwise(runs):
    ranks, _ = runs
    _same_on_every_rank(ranks, "async")
    o = ranks[0]["async"]
    assert o["S"] == 8 and o["uniq"] == 4 and o["lane_sched"] == [0, 0, 1, 1, 2, 2, 3, 3]
    _lanes_match(o["params"], ASYNC8, mode="async", chunk=2)


def test_sharded_plan_scheduler_device_count_independent(runs):
    ranks, _ = runs
    one = _plan(0)
    one.run()
    for o in ranks:
        p = o["plan"]
        assert p["S"] == [(3, 4), (3, 4)]
        assert p["dropped"] == one.dropped and len(one.dropped) > 0
        for b, params in enumerate(p["params"]):
            for j, lane in enumerate(p["lane_ids"][b]):
                _eq({k: v[j] for k, v in params.items()}, _np(one.lane_params(lane)))


def test_sharded_campaign_checkpoint_resume(runs):
    ranks, _ = runs
    for o in ranks:
        assert o["resume_round"] == 2
        _eq(o["resumed"], o["full4"])


def test_elastic_resume_across_device_counts(runs):
    ranks, _ = runs
    full = _camp(_raw(sweep=GRID6, rounds=4, chunk=2)).scaffold()
    full.run()
    want = _np(full.state["params"])
    assert ranks[0]["elastic41_round"] == 2
    _eq(ranks[0]["elastic41"], want)
    for o in ranks:
        assert o["elastic14_round"] == 2
        _eq(o["elastic14"], want)


def test_mesh_config_lanes_axis(runs):
    ranks, _ = runs
    assert ranks[0]["meshcfg"] == (("lanes",), (RANKS,), RANKS, True, 0, True)


def test_lane_mesh_wants_visible_ranks(runs):
    ranks, _ = runs
    assert ranks[0]["too_many"].startswith(f"lane_mesh({RANKS + 1}) wants {RANKS + 1} devices "
                                           f"but only {RANKS} are visible")
