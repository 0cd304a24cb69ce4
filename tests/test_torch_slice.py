"""Slice 1 end to end against the JAX package: three chained rounds of the
JAX ``build_spatial_round`` (jitted, meshless) and of the port's
``round_fn``, from the same carried-across state, with the same numpy
batches and client weights each round.

Tolerances:
- loss rtol 1e-5 and params atol 1e-5 / rtol 1e-4: f32 convs and matmuls sum
  in different orders in XLA and PyTorch (~1e-6 relative per round);
- int8: a client value that lands within float noise of a rounding boundary
  can quantize one step apart in the two packages. Such a flip moves that
  element of the error-feedback residual by one quantum (its block's
  scale, amax/127, about 2e-4 here) and the same element of the aggregate
  by at most one quantum. So for int8 the test allows at most 1e-3 of the
  residual and of the param entries (and at least one) to differ by more
  than the float tolerance, each by at most one quantum (one flip was seen
  in these three rounds).
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
from repro.core.strategies import get_strategy as j_get_strategy
from repro.models.small import SmallModel as JSmallModel
from repro.sharding.axes import AxisCtx
from repro_torch.configs.base import FLConfig, get_config
from repro_torch.core.rounds import build_spatial_round
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


C, STEPS, B, ROUNDS = 4, 2, 4, 3
FL_KW = dict(n_clients=C, local_steps=STEPS, batch_size=B, client_lr=0.05)


def _run_both(strategy, compression):
    kw = dict(FL_KW, strategy=strategy, compression=compression)
    jfl, fl = JFLConfig(**kw), FLConfig(**kw)
    jm = JSmallModel(J_CNN.replace(d_model=8, d_ff=16), "cnn")
    m = SmallModel(get_config("flsim-cnn").replace(d_model=8, d_ff=16), "cnn")
    jstrat, strat = j_get_strategy(jfl), get_strategy(fl)
    jround = jax.jit(lambda s, b, w, k: j_build_spatial_round(jm, jstrat, jfl)(
        AxisCtx(), s, b, w, k))
    pround = build_spatial_round(m, strat, fl)
    jstate = j_init_state(jm, jstrat, jfl, jdet.root_key(0), n_clients_local=C)
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


def _assert_close_but_flips(got, want, rtol, atol, quantum):
    """Allclose except for at most 1e-3 of the entries (and at least one),
    each within one int8 quantum."""
    outside = total = 0
    for k, v in want.items():
        diff = np.abs(got[k] - v)
        assert (diff <= quantum + atol).all(), k
        outside += int((diff > atol + rtol * np.abs(v)).sum())
        total += diff.size
    assert outside <= max(1, 1e-3 * total), (outside, total)


@pytest.mark.parametrize("strategy,compression", [("fedavg", "none"),
                                                  ("compressed", "int8")])
def test_three_rounds_match_jax(strategy, compression):
    ops.reset_quant_agg_stats()
    for jstate, jloss, state, loss in _run_both(strategy, compression):
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        if compression != "int8":
            assert state["clients"] == ()
            for k, v in jstate["params"].items():
                np.testing.assert_allclose(state["params"][k], v, rtol=1e-4,
                                           atol=1e-5, err_msg=k)
            continue
        # |residual| <= quantum / 2 everywhere, so this bounds one quantum
        quantum = 2 * max(np.abs(v).max()
                          for v in jstate["clients"]["residual"].values())
        _assert_close_but_flips(state["clients"]["residual"],
                                jstate["clients"]["residual"], 0, 1e-6, quantum)
        _assert_close_but_flips(state["params"], jstate["params"], 1e-4, 1e-5,
                                quantum)
    # the int8 rounds aggregated through the dispatcher, once per round
    assert ops.quant_agg_stats()["calls"] == (ROUNDS if compression == "int8" else 0)
