"""The port's capacity-bucketed MoE (``repro_torch/models/moe.py``) against
the JAX package's single-device ``moe_ffn``, on the same numpy weights
(JAX's ``init_moe_params`` carried across with ``interop``) and inputs, in
f32, for the "model", "grid" and "subgrid" layouts.

Each comparison first asserts that both packages routed every token to the
same experts (``eids``), then holds the output and ``MoEAux`` to 1e-5
(f32; the frameworks sum the matmuls in other orders). Drops are forced at
``capacity_factor`` 0.25. Without drops the port equals its dense masked
reference (``moe_ffn_dense_ref``) within 1e-5 as well.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import get_config as jget_config
from repro.configs.reduce import reduced_config as jreduced
from repro.models import moe as jmoe
from repro.sharding.axes import AxisCtx
from repro_torch import interop
from repro_torch.configs.base import ModelConfig, MoEConfig, get_config
from repro_torch.configs.reduce import reduced_config
from repro_torch.models import moe


@pytest.fixture(autouse=True)
def one_thread():
    """Every test here on one torch intra-op thread: the suite runs in
    several processes that share the cores, and with a thread per core in
    each, torch's many small CPU ops crawl."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = 1e-5


def _cfgs(ep_mode="model", E=8, k=2, f_sub=1, cf=8.0, aux=True):
    """tests/test_moe_mla.py's MoE config in both packages (with its aux
    losses on unless ``aux`` is False)."""
    kw = dict(n_experts=E, top_k=k, expert_d_ff=16, capacity_factor=cf, ep_mode=ep_mode,
              f_sub=f_sub)
    if not aux:
        kw.update(load_balance_loss=0.0, router_z_loss=0.0)
    base = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                d_ff=16, vocab_size=64)
    return (JModelConfig(**base, moe=JMoEConfig(**kw)),
            ModelConfig(**base, moe=MoEConfig(**kw)))


def _weights(jcfg, seed):
    jw = jmoe.init_moe_params(jax.random.PRNGKey(seed), jcfg)
    return jw, interop.params_from_numpy(jax.tree.map(np.asarray, jw))


def _x(B, T, D, seed):
    return np.random.RandomState(seed).randn(B, T, D).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def _jax_eids(jw, x, jcfg):
    logits = x.reshape(-1, x.shape[-1]) @ np.asarray(jw["router"])
    _, eids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), jcfg.moe.top_k)
    return np.asarray(eids)


def _compare(jcfg, cfg, seed, B=2, T=16):
    jw, w = _weights(jcfg, seed)
    x = _x(B, T, cfg.d_model, seed + 1)
    _, eids, *_ = moe._route(torch.from_numpy(x).reshape(B * T, -1), w["router"], cfg)
    np.testing.assert_array_equal(eids.numpy(), _jax_eids(jw, x, jcfg))
    jout, jaux = jmoe.moe_ffn(AxisCtx(), jw, jnp.asarray(x), jcfg)
    out, aux = moe.moe_ffn(w, torch.from_numpy(x), cfg)
    assert out.shape == (B, T, cfg.d_model) and isinstance(aux, moe.MoEAux)
    _close(out, jout)
    for name in moe.MoEAux._fields:
        _close(getattr(aux, name), getattr(jaux, name))
    return w, x, out, aux


@pytest.mark.parametrize("ep_mode,E,f_sub", [("model", 8, 1), ("grid", 8, 1),
                                             ("subgrid", 4, 2)])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_ffn_matches_the_jax_package(ep_mode, E, f_sub, k):
    jcfg, cfg = _cfgs(ep_mode, E, k, f_sub)
    _, _, _, aux = _compare(jcfg, cfg, seed=3 * k + E)
    assert float(aux.drop_fraction) == 0.0
    assert float(aux.load_balance) > 0 and float(aux.z_loss) > 0


@pytest.mark.parametrize("ep_mode,E,f_sub", [("model", 8, 1), ("subgrid", 4, 2)])
def test_moe_ffn_drops_match_the_jax_package(ep_mode, E, f_sub):
    """capacity_factor 0.25: pairs past an expert's C are dropped and the
    drop fraction is reported, as in the JAX package."""
    jcfg, cfg = _cfgs(ep_mode, E, 2, f_sub, cf=0.25)
    _, _, _, aux = _compare(jcfg, cfg, seed=11, T=64)
    assert float(aux.drop_fraction) > 0.1


@pytest.mark.parametrize("k", [1, 2, 4])
def test_moe_ffn_without_drops_equals_the_dense_reference(k):
    jcfg, cfg = _cfgs(k=k, aux=False)
    _, w = _weights(jcfg, seed=20 + k)
    x = torch.from_numpy(_x(2, 16, cfg.d_model, 30 + k))
    got, aux = moe.moe_ffn(w, x, cfg)
    assert float(aux.drop_fraction) == 0.0
    _close(got, moe.moe_ffn_dense_ref(w, x, cfg))


def test_moe_dense_reference_matches_the_jax_package():
    jcfg, cfg = _cfgs(k=2)
    jw, w = _weights(jcfg, seed=5)
    x = _x(2, 16, cfg.d_model, 6)
    _close(moe.moe_ffn_dense_ref(w, torch.from_numpy(x), cfg),
           jmoe.moe_ffn_dense_ref(jw, jnp.asarray(x), jcfg))


def test_subgrid_equals_the_model_layout_on_its_reassembled_weights():
    """The subgrid packing (E * f_sub, D, F / f_sub) reassembled to (E, D, F)
    is the same function."""
    _, cfg = _cfgs("subgrid", 4, 2, 2)
    w = moe.init_moe_params(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(_x(2, 16, cfg.d_model, 7))
    full = {"router": w["router"], "w1": moe._full(w["w1"], 4, 2),
            "w3": moe._full(w["w3"], 4, 2), "w2": moe._full(w["w2"], 4, 2, transpose=True)}
    flat_cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, ep_mode="model", f_sub=1))
    got, _ = moe.moe_ffn(w, x, cfg)
    want, _ = moe.moe_ffn(full, x, flat_cfg)
    _close(got, want)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "arctic-480b"])
def test_reduced_archs_moe_matches_the_jax_package(arch):
    jcfg, cfg = jreduced(jget_config(arch)), reduced_config(get_config(arch))
    assert moe.moe_param_shapes(cfg) == jmoe.moe_param_shapes(jcfg)
    _compare(jcfg, cfg, seed=9)


def test_moe_shapes_capacity_and_init_match_the_jax_package():
    for arch in ("qwen3-moe-30b-a3b", "arctic-480b"):
        full = get_config(arch)
        assert moe.moe_param_shapes(full) == jmoe.moe_param_shapes(jget_config(arch))
    assert moe.moe_param_shapes(get_config("arctic-480b"))["w1"] == (256, 7168, 2432)
    for args in ((16384, 8, 128, 1.25), (8, 8, 128, 1.25), (4096, 2, 128, 1.25),
                 (64, 2, 8, 0.25), (3, 1, 4, 8.0)):
        assert moe.capacity(*args) == jmoe.capacity(*args)
    assert moe.capacity(16384, 8, 128, 1.25) == 1280
    _, cfg = _cfgs()
    w = moe.init_moe_params(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in w.items()} == moe.moe_param_shapes(cfg)
    assert abs(w["w2"].std().item() - 16 ** -0.5) < 0.03     # fan-in shape[-2] = F


def test_moe_refuses_expert_shards():
    """Weights holding a device's share of the experts ask for the
    mesh's ctx (``moe_ffn(..., ctx=)``, ROADMAP A16.3a)."""
    _, cfg = _cfgs()
    w = moe.init_moe_params(torch.Generator().manual_seed(0), cfg)
    half = {k: (v if k == "router" else v[:4]) for k, v in w.items()}
    with pytest.raises(ValueError, match="ROADMAP A16"):
        moe.moe_ffn(half, torch.zeros(1, 4, cfg.d_model), cfg)


def test_moe_under_vmap_grad_equals_the_loop():
    """The rounds differentiate under vmap(grad): the bucket scatter, the slot
    pick and the gather back all batch, and each client's gradient equals
    its own."""
    jcfg, cfg = _cfgs(cf=0.5)
    _, w = _weights(jcfg, seed=12)
    xs = torch.from_numpy(np.stack([_x(2, 16, cfg.d_model, 40 + i) for i in range(2)]))

    def f(w, x):
        out, aux = moe.moe_ffn(w, x, cfg)
        return out.square().sum() + aux.load_balance + aux.z_loss
    got = vmap(grad(f), in_dims=(None, 0))(w, xs)
    for i in range(2):
        want = grad(f)(w, xs[i])
        for name in w:
            _close(got[name][i], want[name], 1e-6)
