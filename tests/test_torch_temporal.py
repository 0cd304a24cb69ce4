"""Temporal placement of the port against the JAX package: three chained
rounds of the JAX ``build_temporal_round`` (jitted, meshless ``AxisCtx()``)
and of the port's, from the same carried-across state, with the same numpy
batches and client weights each round; fedavg and int8, with a cohort of 4
and of 1 (the C_t == 1 elision: the raw delta, weight 1).

Tolerances (those of ``tests/test_torch_slice.py``): loss rtol 1e-5,
params atol 1e-5 / rtol 1e-4 (XLA and PyTorch sum convs and matmuls in
other orders). int8: a client value within float noise of a rounding
boundary can quantize one step apart in the two packages; at most 1e-3 of
the entries (and at least one) may differ by more, each by at most one
quantum (the largest block scale the round sent).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.base import FLConfig as JFLConfig
from repro.configs.flsim_small import FLSIM_CNN as J_CNN
from repro.core import determinism as jdet
from repro.core.rounds import build_temporal_round as j_build_temporal_round
from repro.core.rounds import init_state as j_init_state
from repro.core.strategies import get_strategy as j_get_strategy
from repro.models.small import SmallModel as JSmallModel
from repro.sharding.axes import AxisCtx
from repro_torch.configs.base import FLConfig, get_config
from repro_torch.core import rounds
from repro_torch.core.rounds import build_temporal_round
from repro_torch.core.strategies import get_strategy
from repro_torch.interop import state_from_numpy, to_numpy
from repro_torch.kernels import ops
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


STEPS, B, ROUNDS = 2, 4, 3


def _run_both(strategy, compression, n, monkeypatch):
    kw = dict(n_clients=n, local_steps=STEPS, batch_size=B, client_lr=0.05,
              strategy=strategy, compression=compression, placement="temporal")
    jfl, fl = JFLConfig(**kw), FLConfig(**kw)
    jcfg = J_CNN.replace(d_model=8, d_ff=16)
    jm = JSmallModel(jcfg, "cnn")
    m = SmallModel(get_config("flsim-cnn").replace(d_model=8, d_ff=16), "cnn")
    jstrat, strat = j_get_strategy(jfl), get_strategy(fl)
    jround = jax.jit(lambda s, b, w, k: j_build_temporal_round(jm, jstrat, jfl, jcfg)(
        AxisCtx(), s, b, w, k))
    pround = build_temporal_round(m, strat, fl)
    jstate = j_init_state(jm, jstrat, jfl, jdet.root_key(0), n_clients_local=n)
    state = state_from_numpy(jax.tree.map(np.asarray, jstate))
    scales = []
    agg = ops.quant_aggregate

    def recording(q, s, w):
        scales.append(float(s.max()))
        return agg(q, s, w)
    monkeypatch.setattr(rounds.ops, "quant_aggregate", recording)
    rng = np.random.RandomState(5)
    out = []
    for r in range(ROUNDS):
        x = rng.randn(n, STEPS, B, 32, 32, 3).astype(np.float32)
        y = rng.randint(0, 10, (n, STEPS, B))
        w = rng.uniform(0.5, 2.0, n).astype(np.float32)
        if n > 1:
            w[r % n] = 0.0                   # a masked client each round
        jstate, jmet = jround(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                              jnp.asarray(w), jdet.round_key(jdet.root_key(0), r))
        state, met = pround(state, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
                            torch.from_numpy(w), r)
        out.append((jax.tree.map(np.asarray, jstate), float(jmet["loss"]),
                    to_numpy(state), float(met["loss"]), scales[-1] if scales else 0.0))
    return out


@pytest.mark.parametrize("n", [4, 1])
@pytest.mark.parametrize("strategy,compression", [("fedavg", "none"),
                                                  ("compressed", "int8")])
def test_three_temporal_rounds_match_jax(strategy, compression, n, monkeypatch):
    with ops.quant_agg_scope() as frame:
        out = _run_both(strategy, compression, n, monkeypatch)
    for jstate, jloss, state, loss, quantum in out:
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        outside = total = 0
        for k, v in jstate["params"].items():
            diff = np.abs(state["params"][k] - v)
            assert (diff <= quantum + 1e-5 + 1e-4 * np.abs(v)).all(), k
            outside += int((diff > 1e-5 + 1e-4 * np.abs(v)).sum())
            total += diff.size
        assert outside <= (max(1, 1e-3 * total) if compression == "int8" else 0)
        # the driver carries the client state through untouched (none is read)
        for k, v in (jstate["clients"] or {}).get("residual", {}).items():
            np.testing.assert_array_equal(state["clients"]["residual"][k], v)
    # int8: the cohort's sends reduced by ONE B1 launch per round
    assert frame["calls"] == (ROUNDS if compression == "int8" else 0)


def test_temporal_round_of_one_client_applies_its_raw_delta():
    fl = FLConfig(n_clients=1, local_steps=1, batch_size=2, client_lr=0.1,
                  placement="temporal")
    m = SmallModel(get_config("flsim-cnn").replace(d_model=8, d_ff=16), "cnn")
    strat = get_strategy(fl)
    state = rounds.init_state(m, strat, fl, 0, 1)
    rng = np.random.RandomState(0)
    batch = {"x": torch.from_numpy(rng.randn(1, 1, 2, 32, 32, 3).astype(np.float32)),
             "y": torch.from_numpy(rng.randint(0, 10, (1, 1, 2)))}
    new, _ = build_temporal_round(m, strat, fl)(state, batch, torch.tensor([0.25]), 3)
    delta, _, _ = rounds.local_train(m, strat, fl, state["params"], (), (), batch,
                                     torch.zeros(1, dtype=torch.int64))
    for k, p in state["params"].items():
        assert torch.equal(new["params"][k], p + delta[k][0])
