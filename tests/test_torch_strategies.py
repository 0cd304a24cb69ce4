"""Every FL strategy and the gossip topology of the port against the JAX
package: three chained rounds of the JAX ``build_spatial_round`` (jitted,
meshless) and of the port's ``round_fn`` from the same carried-across state,
with the same numpy batches and client weights each round; then the JAX
package's strategy properties (``tests/test_strategies.py``,
``tests/test_topology.py``) on the port.

Tolerances (those of ``tests/test_torch_slice.py``):
- loss rtol 1e-5; params, server and client state atol 1e-5 / rtol 1e-4:
  f32 convs and matmuls sum in different orders in XLA and PyTorch (~1e-6
  relative per round);
- int8 sends (decentralized compressed): a client value within float noise
  of a rounding boundary can quantize one step apart in the two packages,
  so at most 1e-3 of the entries (and at least one) may differ by more,
  each by at most one quantum;
- the top-k mask is compared bitwise on identical inputs.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.base import FLConfig as JFLConfig
from repro.configs.flsim_small import FLSIM_CNN as J_CNN
from repro.core import determinism as jdet
from repro.core.rounds import build_spatial_round as j_build_spatial_round
from repro.core.rounds import init_state as j_init_state
from repro.core.strategies import REGISTRY as J_REGISTRY
from repro.core.strategies import get_strategy as j_get_strategy
from repro.core.strategies.compressed import _topk_mask as j_topk_mask
from repro.models.small import SmallModel as JSmallModel
from repro.sharding.axes import AxisCtx
from repro_torch.configs.base import FLConfig, get_config
from repro_torch.core import determinism
from repro_torch.core.rounds import build_spatial_round, init_state
from repro_torch.core.strategies import REGISTRY, get_strategy
from repro_torch.core.strategies.compressed import _topk_mask
from repro_torch.core.strategy import global_norm, tree_sub
from repro_torch.core.topology import GOSSIP_NEIGHBORS, Decentralized
from repro_torch.interop import state_from_numpy, to_numpy
from repro_torch.models.small import SmallModel


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


C, STEPS, B, ROUNDS = 4, 2, 4, 3
FL_KW = dict(n_clients=C, local_steps=STEPS, batch_size=B, client_lr=0.05)

CASES = {
    "fedavgm": dict(strategy="fedavgm", server_momentum=0.5),
    "fedadam": dict(strategy="fedadam", server_lr=0.01),
    "fedyogi": dict(strategy="fedyogi", server_lr=0.01),
    "fedprox": dict(strategy="fedprox", prox_mu=0.5),
    "scaffold": dict(strategy="scaffold"),
    "moon": dict(strategy="moon", moon_mu=0.5, moon_tau=0.5),
    # the clip binds (client delta norms are 0.39-0.66 here); no noise, so the
    # two packages' different generators do not enter
    "dp_fedavg_clip": dict(strategy="dp_fedavg", dp_clip=0.05, dp_noise=0.0),
    "topk": dict(strategy="compressed", compression="topk", topk_ratio=0.1),
    "gossip_1": dict(strategy="gossip", topology="decentralized", gossip_steps=1),
    "gossip_2": dict(strategy="gossip", topology="decentralized", gossip_steps=2),
    "int8_gossip": dict(strategy="compressed", compression="int8",
                        topology="decentralized"),
}


def _run_both(case):
    kw = dict(FL_KW, **CASES[case])
    jfl, fl = JFLConfig(**kw), FLConfig(**kw)
    dec = fl.topology == "decentralized"
    jm = JSmallModel(J_CNN.replace(d_model=8, d_ff=16), "cnn")
    m = SmallModel(get_config("flsim-cnn").replace(d_model=8, d_ff=16), "cnn")
    jstrat, strat = j_get_strategy(jfl), get_strategy(fl)
    jround = jax.jit(lambda s, b, w, k: j_build_spatial_round(jm, jstrat, jfl)(
        AxisCtx(), s, b, w, k))
    pround = build_spatial_round(m, strat, fl)
    jstate = j_init_state(jm, jstrat, jfl, jdet.root_key(0), n_clients_local=C,
                          decentralized=dec)
    state = state_from_numpy(jax.tree.map(np.asarray, jstate))
    rng = np.random.RandomState(11)
    out = []
    for r in range(ROUNDS):
        x = rng.randn(C, STEPS, B, 32, 32, 3).astype(np.float32)
        y = rng.randint(0, 10, (C, STEPS, B))
        w = rng.uniform(0.5, 2.0, C).astype(np.float32)
        w[r % C] = 0.0                       # a masked client each round
        jstate, jmet = jround(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                              jnp.asarray(w), jdet.round_key(jdet.root_key(0), r))
        state, met = pround(state, {"x": torch.from_numpy(x),
                                    "y": torch.from_numpy(y)},
                            torch.from_numpy(w), r)
        out.append((jax.tree.map(np.asarray, jstate), float(jmet["loss"]),
                    to_numpy(state), met["loss"].item()))
    return out


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)


def _assert_close_but_flips(got, want, rtol, atol, quantum):
    """Allclose except for at most 1e-3 of the entries (and at least one),
    each within one int8 quantum."""
    outside = total = 0
    for (k, v), (_, g) in zip(_leaves(want), _leaves(got)):
        diff = np.abs(g - v)
        assert (diff <= quantum + atol).all(), k
        outside += int((diff > atol + rtol * np.abs(v)).sum())
        total += diff.size
    assert outside <= max(1, 1e-3 * total), (outside, total)


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_rounds_match_jax(case):
    for jstate, jloss, state, loss in _run_both(case):
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        if case == "int8_gossip":
            # the sends' quantum: 1/127 of the largest client delta, bounded
            # by the largest change of a client model this round
            quantum = 2 * max(np.abs(v).max() for _, v in
                              _leaves(jstate["clients"]["residual"]))
            _assert_close_but_flips(state["params"], jstate["params"], 1e-4, 1e-5,
                                    quantum)
            continue
        for part in ("params", "server", "clients"):
            want, got = list(_leaves(jstate[part])), list(_leaves(state[part]))
            assert [k for k, _ in got] == [k for k, _ in want], part
            for (k, v), (_, g) in zip(want, got):
                assert g.dtype == v.dtype and g.shape == v.shape, (part, k)
                np.testing.assert_allclose(g, v, rtol=1e-4, atol=1e-5,
                                           err_msg=f"{part}{k}")


def test_scaffold_server_c_is_the_weighted_mean_of_the_clients_c_i():
    fl = FLConfig(strategy="scaffold", **FL_KW)
    m = SmallModel(get_config("flsim-cnn").replace(d_model=8, d_ff=16), "cnn")
    strat = get_strategy(fl)
    state = init_state(m, strat, fl, 0, C)
    rng = np.random.RandomState(2)
    batch = {"x": torch.from_numpy(rng.randn(C, STEPS, B, 32, 32, 3).astype(np.float32)),
             "y": torch.from_numpy(rng.randint(0, 10, (C, STEPS, B)))}
    w = torch.tensor([1.0, 0.0, 3.0, 2.0])
    new, _ = build_spatial_round(m, strat, fl)(state, batch, w, 0)
    for k, ci in new["clients"]["c_i"].items():
        assert ci.abs().max() > 0
        torch.testing.assert_close(new["server"]["c"][k],
                                   torch.tensordot(w, ci, dims=1) / w.sum())


def test_registry_names_every_jax_strategy():
    assert sorted(REGISTRY) == sorted(J_REGISTRY)
    for name in REGISTRY:
        assert get_strategy(FLConfig(strategy=name)).name == name


# -- the JAX package's strategy properties, on the port ----------------------

def _toy(seed=0, n=16, lead=()):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(*lead, n, generator=g), "b": torch.zeros(*lead, 4)}


def test_fedavgm_momentum_accumulates():
    s = get_strategy(FLConfig(strategy="fedavgm", server_momentum=0.5, server_lr=1.0))
    p = _toy()
    st = s.server_state_init(p)
    d = {k: torch.ones_like(v) for k, v in p.items()}
    p1, st = s.server_update(p, d, st)
    p2, st = s.server_update(p1, d, st)
    # the second step moves further: 1.0, then 1.5
    torch.testing.assert_close(p1["w"] - p["w"], torch.full((16,), 1.0))
    torch.testing.assert_close(p2["w"] - p1["w"], torch.full((16,), 1.5))


def test_fedprox_penalizes_drift():
    s = get_strategy(FLConfig(strategy="fedprox", prox_mu=10.0))

    def base(params, batch):
        return torch.zeros(())

    far = s.local_loss(base, _toy(1), _toy(0), None, (), None)
    same = s.local_loss(base, _toy(0), _toy(0), None, (), None)
    assert far.item() > same.item() + 1e-3 and abs(same.item()) < 1e-6


def test_moon_contrastive_term_positive():
    s = get_strategy(FLConfig(strategy="moon", moon_mu=1.0, moon_tau=0.5))
    p, g = _toy(2), _toy(0)

    def base(params, batch):
        return torch.zeros(())

    assert s.local_loss(base, p, g, None, {"prev_local": tree_sub(p, g)}, None).item() > 0


def test_scaffold_correction_and_client_state():
    s = get_strategy(FLConfig(strategy="scaffold", client_lr=0.1))
    p = _toy(lead=(3,))
    sst = s.server_state_init(_toy())
    cst = s.client_state_init(p)
    g = {k: torch.ones_like(v) for k, v in p.items()}
    torch.testing.assert_close(s.grad_transform(g, cst, sst)["w"], g["w"])
    delta = {k: -0.1 * v for k, v in g.items()}     # one SGD step of lr 0.1
    cst2 = s.client_state_update(cst, sst, delta, 1, 0.1)
    torch.testing.assert_close(cst2["c_i"]["w"], torch.ones(3, 16))


def _keys(n, round_key=7):
    return determinism.client_keys(round_key, n, "cpu")


def test_dp_clipping_bounds_each_clients_norm():
    s = get_strategy(FLConfig(strategy="dp_fedavg", dp_clip=1.0, dp_noise=0.0))
    d = {"w": torch.full((3, 100), 10.0), "b": torch.zeros(3, 4)}
    d["w"][1] *= 0.001                               # norm 0.1: left as it is
    out, _ = s.postprocess(d, (), _keys(3))
    nrm = global_norm(out, lead=1)
    assert (nrm <= 1.0 + 1e-4).all()
    torch.testing.assert_close(out["w"][1], d["w"][1])


def test_dp_noise_scales_and_is_keyed():
    s = get_strategy(FLConfig(strategy="dp_fedavg", dp_clip=1.0, dp_noise=0.5))
    d = {"w": torch.zeros((2, 100_000)), "b": torch.zeros((2, 8))}
    keys = _keys(2)
    out, _ = s.postprocess(d, (), keys)
    z = out["w"].double()
    assert abs(z.mean().item()) < 0.005
    assert abs(z.std().item() - 0.5) < 0.05 * 0.5
    again, _ = s.postprocess(d, (), keys)
    assert torch.equal(again["w"], out["w"]) and torch.equal(again["b"], out["b"])
    assert not torch.equal(out["w"][0], out["w"][1])          # other client
    other, _ = s.postprocess(d, (), _keys(2, round_key=8))     # other round
    assert not torch.equal(other["w"], out["w"])
    assert not torch.equal(out["w"][0, :8], out["b"][0])       # other leaf


@pytest.mark.parametrize("x", [
    np.ones((2, 100), np.float32),                                   # all tie
    np.tile(np.repeat(np.float32([3, 2, 2, 1]), 25), (3, 1)),         # tied blocks
    np.random.RandomState(0).randn(4, 3, 5, 7).astype(np.float32),   # a leaf
    np.random.RandomState(1).randint(-3, 4, (5, 64)).astype(np.float32),
])
@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.3])
def test_topk_mask_is_jax_bitwise_and_keeps_exactly_k(x, ratio):
    got = _topk_mask(torch.from_numpy(x), ratio).numpy()
    k = max(1, int(x[0].size * ratio))
    for c in range(x.shape[0]):
        np.testing.assert_array_equal(got[c], np.asarray(j_topk_mask(jnp.asarray(x[c]), ratio)))
        assert int(got[c].sum()) == k


def test_topk_postprocess_keeps_exact_budget():
    s = get_strategy(FLConfig(strategy="compressed", compression="topk",
                              topk_ratio=0.1, error_feedback=False))
    sent, _ = s.postprocess({"w": torch.ones((3, 200))}, {}, _keys(3))
    assert ((sent["w"] != 0).sum(1) == 20).all()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 0.05)])
@pytest.mark.parametrize("steps", [1, 3])
def test_gossip_preserves_the_client_mean(dtype, tol, steps):
    g = torch.Generator().manual_seed(3)
    d = {"w": torch.randn(6, 8, 5, generator=g).to(dtype),
         "b": torch.randn(6, 5, generator=g).to(dtype)}
    mixed = Decentralized(gossip_steps=steps).mix(d)
    for k in d:
        assert mixed[k].dtype == dtype and mixed[k].shape == d[k].shape
        torch.testing.assert_close(mixed[k].float().mean(0), d[k].float().mean(0),
                                   rtol=tol, atol=tol)
        assert not torch.equal(mixed[k], d[k])
        assert mixed[k].float().var(0).sum() <= d[k].float().var(0).sum() + 1e-5
    assert GOSSIP_NEIGHBORS == 2
