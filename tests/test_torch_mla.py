"""The port's MLA attention (``repro_torch/models/attention.py``: ``_mla_q``,
``_mla_kv_latent``, ``mla_seqsharded`` in both forms, ``mla_decode`` and
the ``LatentCache``) against the JAX package's, on reduced minicpm3-4b in
f32 with the same numpy weights and inputs (JAX on its CPU path,
``REPRO_KERNEL_IMPL=jnp``; the port on its kernels' plain versions).

Tolerances: 1e-5 against JAX (f32; the two frameworks sum the matmuls in
other orders and their sin/cos differ in the last bits). Within the port,
absorbed == expanded and decode == the prefill's last row at
``tests/test_moe_mla.py``'s 2e-4: the two forms multiply in other orders
(W^UK folded into q against per-head keys).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MLAConfig as JMLAConfig
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import get_config as jget_config
from repro.configs.reduce import reduced_config as jreduced
from repro.models import attention as jattn
from repro.sharding.axes import AxisCtx
from repro_torch import interop
from repro_torch.configs.base import MLAConfig, ModelConfig, get_config
from repro_torch.configs.reduce import reduced_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as attn


@pytest.fixture(autouse=True)
def one_thread():
    """Every test here on one torch intra-op thread: the suite runs in
    several processes that share the cores, and with a thread per core in
    each, torch's many small CPU ops crawl."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jnp_kernels(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "jnp")


CTX = AxisCtx()
TOL = 1e-5


def _cfgs():
    return jreduced(jget_config("minicpm3-4b")), reduced_config(get_config("minicpm3-4b"))


def _weights(jcfg, seed=0):
    """One layer's JAX MLA weights (norms moved off 1) and the port's copy."""
    jw = jattn.init_attn_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed)
    jw = {k: (v + 0.1 * rng.randn(*v.shape).astype(np.float32) if k.endswith("norm") else v)
          for k, v in jw.items()}
    return jw, interop.params_from_numpy(jax.tree.map(np.asarray, jw))


def _h(B, S, D, seed=1):
    return np.random.RandomState(seed).randn(B, S, D).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def test_mla_config_and_param_shapes_match_the_jax_package():
    jcfg, cfg = _cfgs()
    assert attn.mla_param_shapes(cfg) == jattn.mla_param_shapes(jcfg)
    assert attn.attn_param_shapes(cfg) == jattn.attn_param_shapes(jcfg)
    full = get_config("minicpm3-4b")
    assert attn.attn_param_shapes(full)["wdkv"] == (2560, 288)
    assert attn.attn_param_shapes(full)["wukv"] == (256, 40 * 128)


def test_mla_q_and_kv_latent_match_the_jax_package(jnp_kernels):
    jcfg, cfg = _cfgs()
    jw, w = _weights(jcfg)
    h = _h(2, 24, cfg.d_model)
    pos = np.arange(24)
    jqn, jqr = jattn._mla_q(jw, jcfg, jnp.asarray(h), jnp.asarray(pos))
    qn, qr = attn._mla_q(w, cfg, torch.from_numpy(h), torch.from_numpy(pos))
    assert qn.shape == (2, 24, 4, 8) and qr.shape == (2, 24, 4, 8)
    _close(qn, jqn)
    _close(qr, jqr)
    jckv, jkr = jattn._mla_kv_latent(jw, jcfg, jnp.asarray(h), jnp.asarray(pos))
    ckv, kr = attn._mla_kv_latent(w, cfg, torch.from_numpy(h), torch.from_numpy(pos))
    assert ckv.shape == (2, 24, 16) and kr.shape == (2, 24, 8)
    _close(ckv, jckv)
    _close(kr, jkr)
    jkn, jv = jattn._mla_expand_kv(jw, jcfg, jckv)
    kn, v = attn._mla_expand_kv(w, cfg, ckv)
    _close(kn, jkn)
    _close(v, jv)


@pytest.mark.parametrize("absorbed", [True, False])
def test_mla_seqsharded_matches_the_jax_package(absorbed, jnp_kernels, monkeypatch):
    """Both forms, with the cache of the rows; the JAX form is chosen by its
    environment switch, the port's by the keyword."""
    monkeypatch.setenv("REPRO_MLA_ABSORBED", "1" if absorbed else "0")
    jcfg, cfg = _cfgs()
    jw, w = _weights(jcfg)
    h = _h(2, 40, cfg.d_model)
    jout, jcache = jattn.mla_seqsharded(CTX, jw, jnp.asarray(h), jcfg, return_cache=True)
    before = fa.flash_attention_fwd.launches
    out, cache = attn.mla_seqsharded(w, torch.from_numpy(h), cfg, return_cache=True,
                                     absorbed=absorbed)
    assert isinstance(cache, attn.LatentCache) and out.shape == (2, 40, cfg.d_model)
    _close(out, jout)
    _close(cache.ckv, jcache.ckv)
    _close(cache.krope, jcache.krope)
    assert fa.flash_attention_fwd.launches == before    # the CPU path: plain


def test_mla_decode_matches_the_jax_package(jnp_kernels):
    """Two decode steps from a padded prefill cache, its rows at lengths 12
    and 9 (the second row's slots from 9 on zeroed, as a shorter prompt
    leaves them: its first step writes mid-cache)."""
    jcfg, cfg = _cfgs()
    jw, w = _weights(jcfg, seed=2)
    h = _h(2, 12, cfg.d_model, seed=3)
    _, jcache = jattn.mla_seqsharded(CTX, jw, jnp.asarray(h), jcfg, return_cache=True)
    padded = [np.pad(np.asarray(t), ((0, 0), (0, 2), (0, 0))) for t in jcache]
    for t in padded:
        t[1, 9:] = 0
    jcache = jattn.LatentCache(*(jnp.asarray(t) for t in padded))
    cache = interop.caches_from_numpy(jattn.LatentCache(*padded))
    length = np.array([12, 9], np.int32)
    for step in range(2):
        x = _h(2, 1, cfg.d_model, seed=10 + step)
        jout, jcache = jattn.mla_decode(CTX, jw, jnp.asarray(x), jcache, jnp.asarray(length),
                                        jcfg)
        out, new = attn.mla_decode(w, torch.from_numpy(x), cache, torch.from_numpy(length),
                                   cfg)
        assert new is cache                                  # written in place
        _close(out, jout)
        _close(cache.ckv, jcache.ckv)
        _close(cache.krope, jcache.krope)
        length = length + 1


def _small_mla():
    """tests/test_moe_mla.py's MLA config."""
    return ModelConfig(
        name="t", family="dense", n_layers=1, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=64, vocab_size=64, attn_type="mla",
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=8,
                      qk_rope_head_dim=8, v_head_dim=8))


def _small_weights(seed):
    jcfg = JModelConfig(
        name="t", family="dense", n_layers=1, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=64, vocab_size=64, attn_type="mla",
        mla=JMLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=8,
                       qk_rope_head_dim=8, v_head_dim=8))
    return _weights(jcfg, seed)[1]


def test_mla_absorbed_equals_expanded():
    cfg, w = _small_mla(), _small_weights(0)
    h = torch.from_numpy(_h(2, 32, 64))
    absorbed = attn.mla_seqsharded(w, h, cfg)
    expanded = attn.mla_seqsharded(w, h, cfg, absorbed=False)
    _close(absorbed, expanded, 2e-4)


def test_mla_decode_matches_prefill_tail():
    """Absorbed decode over a latent cache == the last row of the forward."""
    cfg, w = _small_mla(), _small_weights(1)
    S = 16
    h = torch.from_numpy(_h(2, S + 1, 64, seed=4))
    full = attn.mla_seqsharded(w, h, cfg)
    _, cache = attn.mla_seqsharded(w, h[:, :S], cfg, return_cache=True)
    cache = attn.LatentCache(*(torch.nn.functional.pad(t, (0, 0, 0, 1)) for t in cache))
    out, _ = attn.mla_decode(w, h[:, S:S + 1], cache, torch.full((2,), S, dtype=torch.int32),
                             cfg)
    _close(out[:, 0], full[:, S], 2e-4)


def test_mla_decode_past_the_cache_writes_nothing():
    """As in the JAX package, a position past the cache's end is not written."""
    cfg, w = _small_mla(), _small_weights(2)
    cache = attn.init_cache(cfg, 2, 4, dtype=torch.float32)
    assert isinstance(cache, attn.LatentCache)
    assert cache.ckv.shape == (2, 4, 16) and cache.krope.shape == (2, 4, 8)
    h = torch.from_numpy(_h(2, 1, 64, seed=5))
    _, cache = attn.mla_decode(w, h, cache, torch.tensor([1, 4], dtype=torch.int32), cfg)
    assert cache.ckv[0, 1].abs().sum() > 0 and cache.ckv[0, [0, 2, 3]].abs().sum() == 0
    assert cache.ckv[1].abs().sum() == 0 and cache.krope[1].abs().sum() == 0


def test_latent_cache_crosses_in_both_directions():
    jcache = jattn.init_cache(jreduced(jget_config("minicpm3-4b")), 2, 5, jnp.float32)
    rng = np.random.RandomState(6)
    jcache = jattn.LatentCache(*(jnp.asarray(rng.randn(*t.shape), jnp.float32)
                                 for t in jcache))
    cache = interop.caches_from_numpy(jax.tree.map(np.asarray, jcache))
    assert isinstance(cache, attn.LatentCache)
    back = interop.to_numpy(cache)
    assert type(back).__name__ == "LatentCache"
    np.testing.assert_array_equal(back.ckv, np.asarray(jcache.ckv))
    np.testing.assert_array_equal(back.krope, np.asarray(jcache.krope))
