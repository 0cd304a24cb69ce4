"""The spatial client grid on a device mesh (``core/topology.py``,
``core/rounds.build_spatial_round(ctx=)``, ``launch/steps.make_train_step``)
against the port's meshless round and the JAX package's ``shard_map``.

The port runs on 8 ``gloo`` ranks (``launch/mesh.spawn``, once for the
file), each building every mesh: (2, 2, 2) ``("pod", "data", "model")``
over all 8, and over ranks 0-3 a (2, 2) ``("data", "model")`` mesh and a
4-rank ``("data",)`` ring. The JAX side runs this file as a script under
``shard_map`` on 8 forced host devices (the device count is set before jax
initializes). Rank r (device r) holds clients ``r * C_loc ..``: the grid's
flattened position, as ``rounds._grid_below`` numbers it.

- Gossip on the 4-rank ring == the meshless ring, bitwise (the port of
  ``tests/test_topology.py::test_gossip_meshless_matches_mesh``).
- Two spatial rounds of flsim-logreg, 8 clients, for client-server,
  hierarchical and decentralized, f32 and int8 (B1's plain version on the
  CPU), on both meshes: loss and params within 1e-5 (rtol 1e-4 on params)
  of the JAX ``shard_map`` round and of the port's meshless round, except
  where the mesh's plan is another one (decentralized: a mesh gossips over
  its rank rings, not the client ring; hierarchical with pods: the cloud
  tier averages pod means): there the first round's loss.
  The mesh sums client shards in another order than the meshless round, so
  int8 sends may quantize one step apart: at most 1e-3 of the entries
  (and at least one) may differ by more, each by at most one quantum.
- ``make_train_step`` for reduced xlstm-125m and whisper-base on (2, 2),
  f32, one client a rank (the rematerialized autograd path: the clients'
  ``vmap`` is not entered), against JAX's ``make_train_step`` on the same
  global arrays: loss rtol 1e-5, params atol 1e-5 / rtol 1e-4, the
  tolerances of ``tests/test_torch_lm_train.py``.

This module imports no JAX at its top: the spawned ranks import it.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
MESHES = {"dm": ((2, 2), ("data", "model")),
          "pdm": ((2, 2, 2), ("pod", "data", "model"))}
N_CLIENTS, STEPS, B, ROUNDS = 8, 2, 4, 2
CASES = {
    "client_server": dict(strategy="fedavg"),
    "client_server_int8": dict(strategy="compressed", compression="int8"),
    "hierarchical": dict(strategy="fedavg", topology="hierarchical"),
    "hierarchical_int8": dict(strategy="compressed", compression="int8",
                              topology="hierarchical"),
    "decentralized": dict(strategy="gossip", topology="decentralized", gossip_steps=2),
    "decentralized_int8": dict(strategy="compressed", compression="int8",
                               topology="decentralized"),
}
LM_ARCHS = ("xlstm-125m", "whisper-base")
LM_SHAPE = (16, 4)          # (seq_len, global batch): one client of batch 1 a rank


def _fl_kw(case):
    return dict(n_clients=N_CLIENTS, local_steps=STEPS, batch_size=B, client_lr=0.1,
                **CASES[case])


def _data():
    """Every round's (x, y, w) for the 8 clients, one numpy draw."""
    rng = np.random.RandomState(11)
    out = []
    for r in range(ROUNDS):
        x = rng.randn(N_CLIENTS, STEPS, B, 28, 28, 1).astype(np.float32)
        y = rng.randint(0, 10, (N_CLIENTS, STEPS, B))
        w = rng.uniform(0.5, 2.0, N_CLIENTS).astype(np.float32)
        w[(3 * r) % N_CLIENTS] = 0.0                 # a masked client
        out.append((x, y, w))
    return out


def _port_round(case, ctx, lo, hi):
    """The port's rounds over clients ``lo:hi`` (the whole grid meshless);
    -> (losses, params, client state) as numpy."""
    from repro_torch.configs.base import FLConfig, get_config
    from repro_torch.core import determinism
    from repro_torch.core.rounds import build_spatial_round, init_state
    from repro_torch.core.strategies import get_strategy
    from repro_torch.interop import to_numpy
    from repro_torch.models.small import SmallModel

    fl = FLConfig(**_fl_kw(case))
    model = SmallModel(get_config("flsim-logreg"), "logreg")
    strategy = get_strategy(fl)
    dec = fl.topology == "decentralized"
    state = init_state(model, strategy, fl, determinism.root_key(0), n_clients_local=hi - lo,
                       decentralized=dec)
    round_fn = build_spatial_round(model, strategy, fl, ctx=ctx)
    losses = []
    for r, (x, y, w) in enumerate(_data()):
        state, m = round_fn(state, {"x": torch.from_numpy(x[lo:hi]),
                                    "y": torch.from_numpy(y[lo:hi])},
                            torch.from_numpy(w[lo:hi]),
                            determinism.round_key(determinism.root_key(0), r))
        losses.append(m["loss"].item())
    return losses, to_numpy(state["params"]), to_numpy(state["clients"])


def _lm_cfg(arch):
    from repro_torch.configs.base import get_config
    from repro_torch.configs.reduce import reduced_config
    return reduced_config(get_config(arch))


def _lm_step(arch, mesh):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    return steps.make_train_step(_lm_cfg(arch), ShapeConfig("t", *LM_SHAPE, "train"), mesh,
                                 dtype=torch.float32)


def rank_body(rank, world):
    """One rank: the gossip ring, every case on both meshes, the LM steps."""
    from repro_torch.core import rounds
    from repro_torch.core.topology import Decentralized
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import mesh_ctx

    torch.set_num_threads(1)
    meshes = {m: make_test_mesh(shape, axes, device="cpu") for m, (shape, axes) in MESHES.items()}
    ctxs = {m: mesh_ctx(mesh) for m, mesh in meshes.items()}
    ring = mesh_ctx(make_test_mesh((4,), ("data",), device="cpu"))
    out = {}
    if rank < 4:
        x = _ring_x()
        mixed = Decentralized(gossip_steps=3, ctx=ring).mix({"t": x[rank:rank + 1]})["t"]
        out["ring"] = mixed.float().numpy()
    for m, mesh in meshes.items():
        if rank >= mesh.size():
            continue
        c_loc = N_CLIENTS // mesh.size()
        for case in CASES:
            out[(m, case)] = _port_round(case, ctxs[m], rank * c_loc, (rank + 1) * c_loc)
    if rank < 4:
        def no_vmap(*a, **k):
            raise AssertionError("the clients' vmap was entered")
        rounds.vmap, keep = no_vmap, rounds.vmap
        try:
            for arch in LM_ARCHS:
                built = _lm_step(arch, meshes["dm"])
                state, batch, w, rng = built.shard(_lm_arrays(built), "cpu")
                new, met = built.fn(state, batch, w, rng)
                out[arch] = (met["loss"].item(),
                             {k: v.numpy() for k, v in new["params"].items()})
        finally:
            rounds.vmap = keep
    return out


def _ring_x():
    return torch.from_numpy(np.random.RandomState(0).randn(4, 8).astype(np.float32)) \
        .to(torch.bfloat16)


def _lm_arrays(built):
    """The step's global inputs: ``BuiltStep.global_arrays(0)`` with every
    client at weight 1."""
    state, batch, w, rng = built.global_arrays(0)
    return state, batch, torch.ones_like(w), rng


def _jax_side(out_path):
    """This file as a script: the JAX rounds and steps under ``shard_map``
    on 8 forced host devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.configs.base import FLConfig as JFLConfig
    from repro.configs.base import ShapeConfig
    from repro.configs.flsim_small import FLSIM_LOGREG
    from repro.core import determinism as jdet
    from repro.core.rounds import build_spatial_round, init_state
    from repro.core.strategies import get_strategy
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_test_mesh
    from repro.models.small import SmallModel
    from repro.sharding.axes import AxisCtx
    from repro_torch.models.transformer import unflatten_params
    try:
        from jax.experimental.shard_map import shard_map
    except ImportError:
        from jax.sharding import shard_map

    res = {}
    data = _data()
    for m, (shape, axes) in MESHES.items():
        mesh = make_test_mesh(shape, axes)
        ctx = AxisCtx(**{a: a for a in axes})
        grid = P(tuple(axes))
        for case in CASES:
            fl = JFLConfig(**_fl_kw(case))
            model = SmallModel(FLSIM_LOGREG, "logreg")
            strategy = get_strategy(fl)
            dec = fl.topology == "decentralized"
            state = init_state(model, strategy, fl, jdet.root_key(0),
                               n_clients_local=N_CLIENTS, decentralized=dec)
            specs = {"params": jax.tree.map(lambda _: grid if dec else P(), state["params"]),
                     "server": jax.tree.map(lambda _: grid if dec else P(), state["server"]),
                     "clients": jax.tree.map(lambda _: grid, state["clients"])}
            fn = jax.jit(shard_map(
                lambda s, b, w, k, fl=fl, model=model, strategy=strategy:
                    build_spatial_round(model, strategy, fl)(ctx, s, b, w, k),
                mesh=mesh, in_specs=(specs, {"x": grid, "y": grid}, grid, P()),
                out_specs=(specs, {"loss": P()}), check_rep=False))
            losses = []
            for r, (x, y, w) in enumerate(data):
                state, met = fn(state, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                                jnp.asarray(w), jdet.round_key(jdet.root_key(0), r))
                losses.append(float(met["loss"]))
            res[f"{m}|{case}|loss"] = np.asarray(losses)
            for k, v in state["params"].items():
                res[f"{m}|{case}|params|{k}"] = np.asarray(v)
            for k, v in (state["clients"] or {}).get("residual", {}).items():
                res[f"{m}|{case}|residual|{k}"] = np.asarray(v)
    # the LM steps on (2, 2), fed the port's global arrays
    mesh = make_test_mesh((2, 2), ("data", "model"))
    from repro.configs.base import get_config as j_get_config
    from repro.configs.reduce import reduced_config as j_reduced
    for arch in LM_ARCHS:
        cfg = j_reduced(j_get_config(arch))
        built = jsteps.make_train_step(cfg, ShapeConfig("t", *LM_SHAPE, "train"), mesh)
        state, batch, w, _ = _port_lm_inputs(arch)
        jstate = {"params": jax.tree.map(jnp.asarray, unflatten_params(state["params"])),
                  "server": (), "clients": ()}
        jbatch = {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else jnp.float32)
                  for k, v in batch.items()}
        new, met = jax.jit(built.fn)(jstate, jbatch, jnp.asarray(w), jnp.zeros((2,), jnp.uint32))
        res[f"{arch}|loss"] = np.asarray(float(met["loss"]))
        flat = {}

        def walk(t, prefix=""):
            for k, v in t.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}/")
                else:
                    flat[prefix + k] = np.asarray(v)
        walk(new["params"])
        for k, v in flat.items():
            res[f"{arch}|params|{k}"] = v
    np.savez(out_path, **res)


def _port_lm_inputs(arch):
    """The port step's global arrays on a (2, 2) grid, as numpy (no ranks
    needed: ``steps.train_inputs`` and ``steps.global_arrays``)."""
    from repro_torch.configs.base import FLConfig, ShapeConfig
    from repro_torch.core.strategies import get_strategy
    from repro_torch.launch import steps

    inputs = steps.train_inputs(
        _lm_cfg(arch), ShapeConfig("t", *LM_SHAPE, "train"), {"data": 2, "model": 2},
        get_strategy(FLConfig(strategy="fedavg", local_epochs=1, client_lr=1e-2)),
        torch.float32)

    def np_(t):
        if isinstance(t, dict):
            return {k: np_(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(np_(v) for v in t)
        return t.numpy()
    state, batch, w, rng = np_(steps.global_arrays(inputs, 0))
    return state, batch, np.ones_like(w), rng


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks, the JAX devices and the port's meshless rounds."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.sharding.axes import SINGLE

    out = str(tmp_path_factory.mktemp("spatial") / "jax.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", REPRO_KERNEL_IMPL="jnp",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), out], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = spawn(rank_body, 8, "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        meshless = {case: _port_round(case, SINGLE, 0, N_CLIENTS) for case in CASES}
    finally:
        torch.set_num_threads(threads)
    _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    with np.load(out) as z:
        return ranks, meshless, dict(z)


def _close_but_flips(got: dict, want: dict, int8: bool, quantum: float = 0.0):
    """allclose (atol 1e-5, rtol 1e-4); with int8 sends, at most 1e-3 of the
    entries (and at least one) may be off by up to one quantum."""
    outside = total = 0
    for k in want:
        g, v = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == v.shape, k
        if not int8:
            np.testing.assert_allclose(g, v, atol=1e-5, rtol=1e-4, err_msg=k)
            continue
        diff = np.abs(g - v)
        assert (diff <= quantum + 1e-5).all(), (k, diff.max(), quantum)
        outside += int((diff > 1e-5 + 1e-4 * np.abs(v)).sum())
        total += diff.size
    assert outside <= max(1, 1e-3 * total), (outside, total)


def _mesh_view(ranks, m, case):
    """The mesh run as one state: replicated params from rank 0; per-client
    params and client states concatenated in rank order."""
    n = int(np.prod(MESHES[m][0]))
    outs = [ranks[r][(m, case)] for r in range(n)]
    dec = CASES[case].get("topology") == "decentralized"
    params = ({k: np.concatenate([o[1][k] for o in outs]) for k in outs[0][1]} if dec
              else outs[0][1])
    for o in outs[1:]:
        assert o[0] == outs[0][0]                    # the loss is the grid's
        if not dec:
            for k in params:
                np.testing.assert_array_equal(o[1][k], params[k])   # replicated
    clients = {}
    if outs[0][2]:
        clients = {k: np.concatenate([o[2]["residual"][k] for o in outs])
                   for k in outs[0][2]["residual"]}
    return outs[0][0], params, clients


def test_gossip_on_a_ring_of_ranks_is_the_meshless_ring_bitwise(runs):
    from repro_torch.core.topology import Decentralized

    ranks, _, _ = runs
    meshless = Decentralized(gossip_steps=3).mix({"t": _ring_x()})["t"].float().numpy()
    np.testing.assert_array_equal(np.concatenate([ranks[r]["ring"] for r in range(4)]),
                                  meshless)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_round_matches_meshless_and_jax(runs, mesh, case):
    ranks, meshless, jx = runs
    loss, params, clients = _mesh_view(ranks, mesh, case)
    int8 = "int8" in case
    m_loss, m_params, m_clients = meshless[case]
    j_params = {k[len(f"{mesh}|{case}|params|"):]: v for k, v in jx.items()
                if k.startswith(f"{mesh}|{case}|params|")}
    j_res = {k[len(f"{mesh}|{case}|residual|"):]: v for k, v in jx.items()
             if k.startswith(f"{mesh}|{case}|residual|")}
    np.testing.assert_allclose(loss, jx[f"{mesh}|{case}|loss"], rtol=1e-5)
    # one int8 quantum of a send: 1/127 of the largest client delta, bounded
    # by twice the largest error-feedback residual
    quantum = 2 * max((np.abs(v).max() for v in clients.values()), default=0.0)
    _close_but_flips(params, j_params, int8, quantum)
    if clients:
        _close_but_flips(clients, j_res, int8, quantum)
    topology = CASES[case].get("topology")
    if topology == "decentralized" or (topology == "hierarchical" and mesh == "pdm"):
        # other plans than the meshless round's, as in the JAX package: the
        # mesh gossips each slot with the same slot of the neighbouring
        # ranks along model, then data (the meshless ring rolls the 8
        # clients; the two rings agree on a 1-axis ring, above); two pods
        # average their pod means unweighted. The same first round's loss.
        np.testing.assert_allclose(loss[0], m_loss[0], rtol=1e-5)
        return
    np.testing.assert_allclose(loss, m_loss, rtol=1e-5)
    _close_but_flips(params, m_params, int8, quantum)
    if clients:
        _close_but_flips(clients, m_clients["residual"], int8, quantum)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_spatial_lm_train_step_matches_jax(runs, arch):
    ranks, _, jx = runs
    loss, params = ranks[0][arch]
    for r in range(1, 4):
        assert ranks[r][arch][0] == loss
        for k in params:
            np.testing.assert_array_equal(ranks[r][arch][1][k], params[k])
    np.testing.assert_allclose(loss, float(jx[f"{arch}|loss"]), rtol=1e-5)
    want = {k[len(f"{arch}|params|"):]: v for k, v in jx.items()
            if k.startswith(f"{arch}|params|")}
    assert sorted(want) == sorted(params)
    for k, v in want.items():
        np.testing.assert_allclose(params[k], v, atol=1e-5, rtol=1e-4, err_msg=k)


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    _jax_side(sys.argv[1])
