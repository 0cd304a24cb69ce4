"""The port's LM serving path (``repro_torch.launch.serve`` over
``transformer.Model``) against the JAX package's, on reduced configs in f32
with the same numpy weights (carried across with ``interop``): yi-34b,
then QKV bias and qk-norm (qwen2.5-32b, chameleon-34b), MLA with tied
embeddings (minicpm3-4b) and MoE (qwen3-moe-30b-a3b, arctic-480b).

The JAX side runs its CPU path (``REPRO_KERNEL_IMPL=jnp``); the port takes
its kernels' plain versions on the CPU.

Tolerances: logits 1e-4 and caches 1e-5 (f32; the two frameworks sum the
matmuls in another order and their sin/cos differ in the last bits);
greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.reduce import reduced_config as jreduced
from repro.launch.serve import generate as jgenerate
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtf
from repro.sharding.axes import AxisCtx
from repro_torch import interop
from repro_torch.configs.base import get_config
from repro_torch.configs.reduce import reduced_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rms
from repro_torch.launch import serve
from repro_torch.models import model_zoo, transformer


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


@pytest.fixture
def jnp_kernels(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "jnp")


@pytest.fixture(scope="module")
def both():
    """Reduced yi-34b in both packages from the JAX package's weights."""
    jcfg = jreduced(jget_config("yi-34b"))
    jmodel = jzoo.build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    model = model_zoo.build(reduced_config(get_config("yi-34b")))
    return jmodel, jparams, model, interop.params_from_numpy(np_params)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def test_config_and_param_tree_match_the_jax_package():
    cfg, jcfg = get_config("yi-34b"), jget_config("yi-34b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduced_config(cfg)) == dataclasses.asdict(jreduced(jcfg))
    assert transformer.param_shapes(cfg) == jtf.param_shapes(jcfg)
    assert model_zoo.count_params(cfg) == jzoo.count_params(jcfg)
    assert model_zoo.count_params(cfg, padded=True) == jzoo.count_params(jcfg, padded=True)


def test_init_params_has_the_jax_tree_and_initializers():
    cfg = reduced_config(get_config("yi-34b"))
    p = model_zoo.build(cfg).init(torch.Generator().manual_seed(0))
    want = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(
        jtf.param_shapes(jreduced(jget_config("yi-34b"))),
        is_leaf=lambda x: isinstance(x, tuple))[0]}
    mine = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
            jax.tree_util.tree_flatten_with_path(p)[0]}
    assert mine == want
    assert torch.equal(p["blocks"]["ln1"]["w"], torch.ones(2, 64))
    assert torch.equal(p["final_norm"]["w"], torch.ones(64))
    assert abs(p["embed"].std().item() - 0.02) < 2e-3
    assert abs(p["blocks"]["mlp"]["w2"].std().item() - 128 ** -0.5) < 0.01


def test_prefill_and_teacher_forced_decode_match_the_jax_package(both, jnp_kernels):
    jmodel, jparams, model, params = both
    B, S, steps = 2, 64, 4
    rng = np.random.RandomState(0)
    prompts = rng.randint(0, 512, (B, S)).astype(np.int32)
    forced = rng.randint(0, 512, (steps, B)).astype(np.int32)
    ctx = AxisCtx()

    jcaches, jlogits, _ = jmodel.prefill(ctx, jparams, {"tokens": jnp.asarray(prompts)})
    before = (rms.rmsnorm.launches, fa.flash_attention_fwd.launches,
              da.decode_attention_fwd.launches)
    caches, logits, _ = model.prefill(params, {"tokens": torch.from_numpy(prompts).long()})
    assert logits.shape == (B, 512) and logits.dtype == torch.float32
    _close(logits, jlogits, 1e-4)
    _close(caches.k, jcaches.k, 1e-5)
    _close(caches.v, jcaches.v, 1e-5)

    jcaches = jtf.pad_caches(jcaches, steps)
    caches = transformer.pad_caches(caches, steps)
    assert caches.k.shape == (2, B, S + steps, 2, 16)
    length = np.full((B,), S, np.int32)
    for i in range(steps):
        jlogits, jcaches = jmodel.decode_step(ctx, jparams, jnp.asarray(forced[i]), jcaches,
                                              jnp.asarray(length), tp=False)
        logits, caches = model.decode_step(params, torch.from_numpy(forced[i]).long(),
                                           caches, torch.from_numpy(length))
        _close(logits, jlogits, 1e-4)
        length = length + 1
    got = interop.to_numpy(caches)
    _close(got.k, jcaches.k, 1e-5)
    _close(got.v, jcaches.v, 1e-5)
    # the CPU path takes the plain versions: no kernel launched
    assert before == (rms.rmsnorm.launches, fa.flash_attention_fwd.launches,
                      da.decode_attention_fwd.launches)


def test_decode_from_a_jax_cache_matches(both, jnp_kernels):
    """A JAX cache carried into the port decodes to the same logits."""
    jmodel, jparams, model, params = both
    B, S = 2, 16
    prompts = np.random.RandomState(1).randint(0, 512, (B, S)).astype(np.int32)
    ctx = AxisCtx()
    jcaches, jlogits, _ = jmodel.prefill(ctx, jparams, {"tokens": jnp.asarray(prompts)})
    jcaches = jtf.pad_caches(jcaches, 1)
    caches = interop.caches_from_numpy(jax.tree.map(np.asarray, jcaches))
    tok = np.array(jmodel.greedy_token(ctx, jlogits))
    length = np.full((B,), S, np.int32)
    jl, _ = jmodel.decode_step(ctx, jparams, jnp.asarray(tok), jcaches, jnp.asarray(length),
                               tp=False)
    tl, _ = model.decode_step(params, torch.from_numpy(tok).long(), caches,
                              torch.from_numpy(length))
    _close(tl, jl, 1e-4)


def test_generate_gives_the_jax_packages_tokens(both, jnp_kernels):
    jmodel, jparams, model, params = both
    prompts = np.random.RandomState(2).randint(0, 512, (2, 64)).astype(np.int32)
    want = np.asarray(jgenerate(jmodel, jparams, jnp.asarray(prompts), 8))
    got = serve.generate(model, params, torch.from_numpy(prompts).long(), 8)
    assert got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        serve.generate(model, params, torch.from_numpy(prompts).long(), 8).numpy(), want)


def test_decode_past_the_cache_writes_nothing(both):
    """As in the JAX package, a position past the cache's end is not written."""
    _, _, model, params = both
    cfg = model.cfg
    from repro_torch.models import attention as attn
    cache = attn.init_cache(cfg, 2, 4, dtype=torch.float32)
    h = torch.randn(2, 1, cfg.d_model, generator=torch.Generator().manual_seed(0))
    w = {k: v[0] for k, v in params["blocks"]["attn"].items()}
    _, cache = attn.gqa_decode(w, h, cache, torch.tensor([1, 4], dtype=torch.int32), cfg)
    assert cache.k[0, 1].abs().sum() > 0 and cache.k[0, [0, 2, 3]].abs().sum() == 0
    assert cache.k[1].abs().sum() == 0 and cache.v[1].abs().sum() == 0


def test_serve_main_runs_on_the_cpu(capsys):
    toks = serve.main(["--arch", "yi-34b", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--max-new", "3"])
    assert toks.shape == (2, 3) and toks.device.type == "cpu"
    assert "arch=yi-34b-reduced device=cpu" in capsys.readouterr().out


# qwen2.5-32b and yi-34b with qkv_bias or qk_norm build since QKV bias and
# qk-norm were ported (test_bias_and_qk_norm_archs_give_the_jax_packages_tokens
# runs them), MLA, MoE and tied embeddings since they were
# (test_mla_and_moe_archs_match_the_jax_package); the families that were
# still refused took their places. Slice 12 ported those families (ROADMAP
# A15.5, A15.6): the cases keep their ids; the three archs build their
# family's model, and a config switched to a family it lacks the settings of
# (an SSMConfig, a HybridConfig, encoder layers) is refused with a
# ValueError naming what it lacks.
@pytest.mark.parametrize("arch,change", [
    ("whisper-base", None), ("xlstm-125m", None), ("jamba-1.5-large-398b", None),
    ("yi-34b", {"family": "encdec"}), ("yi-34b", {"family": "ssm"}),
    ("minicpm3-4b", {"family": "hybrid"}), ("qwen3-moe-30b-a3b", {"family": "hybrid"}),
    ("arctic-480b", {"family": "encdec"}),
])
def test_build_refuses_what_is_not_yet_ported(arch, change):
    if change is None:
        model = model_zoo.build(arch)
        assert type(model).__name__ == ("EncDecModel" if arch == "whisper-base" else "Model")
        assert model.cfg == get_config(arch)
        return
    lacks = {"encdec": "encoder layers", "ssm": "ssm config", "hybrid": "config"}
    with pytest.raises(ValueError, match=lacks[change["family"]]):
        model_zoo.build(get_config(arch).replace(**change))


NEW_ARCHS = ("minicpm3-4b", "qwen3-moe-30b-a3b", "arctic-480b")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_mla_and_moe_configs_match_the_jax_package(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduced_config(cfg)) == dataclasses.asdict(jreduced(jcfg))
    assert transformer.param_shapes(cfg) == jtf.param_shapes(jcfg)
    assert ("lm_head" in transformer.param_shapes(cfg)) == (not cfg.tie_embeddings)
    p = model_zoo.build(reduced_config(cfg)).init(torch.Generator().manual_seed(0))
    want = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(
        jtf.param_shapes(jreduced(jcfg)), is_leaf=lambda x: isinstance(x, tuple))[0]}
    assert {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
            jax.tree_util.tree_flatten_with_path(p)[0]} == want


def _moved_params(arch, seed):
    """The JAX reduced model and its init, the norm weights moved off 1."""
    jmodel = jzoo.build(jreduced(jget_config(arch)))
    rng = np.random.RandomState(seed)

    def move(path, t):
        if any(f"['{n}']" in jax.tree_util.keystr(path) for n in ("q_norm", "k_norm",
                                                                   "kv_norm")):
            return t + 0.3 * jnp.asarray(rng.randn(*t.shape), t.dtype)
        return t
    return jmodel, jax.tree_util.tree_map_with_path(move, jmodel.init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_mla_and_moe_archs_match_the_jax_package(arch, jnp_kernels):
    """Reduced minicpm3-4b (MLA, tied), qwen3-moe-30b-a3b (MoE, qk-norm) and
    arctic-480b (subgrid MoE, dense residual): prefill logits and caches
    (a LatentCache for MLA), two teacher-forced decode steps, and the JAX
    ``generate``'s greedy tokens."""
    jmodel, jparams = _moved_params(arch, 4)
    model = model_zoo.build(reduced_config(get_config(arch)))
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams))
    B, S, steps = 2, 24, 2
    rng = np.random.RandomState(5)
    prompts = rng.randint(0, 512, (B, S)).astype(np.int32)
    forced = rng.randint(0, 512, (steps, B)).astype(np.int32)
    ctx = AxisCtx()
    jcaches, jlogits, _ = jmodel.prefill(ctx, jparams, {"tokens": jnp.asarray(prompts)})
    caches, logits, _ = model.prefill(params, {"tokens": torch.from_numpy(prompts).long()})
    assert type(caches).__name__ == type(jcaches).__name__
    _close(logits, jlogits, 1e-4)
    for got, want in zip(caches, jcaches):
        _close(got, want, 1e-5)
    jcaches, caches = jtf.pad_caches(jcaches, steps), transformer.pad_caches(caches, steps)
    length = np.full((B,), S, np.int32)
    for i in range(steps):
        jlogits, jcaches = jmodel.decode_step(ctx, jparams, jnp.asarray(forced[i]), jcaches,
                                              jnp.asarray(length), tp=False)
        logits, caches = model.decode_step(params, torch.from_numpy(forced[i]).long(),
                                           caches, torch.from_numpy(length))
        _close(logits, jlogits, 1e-4)
        length = length + 1
    for got, want in zip(interop.to_numpy(caches), jcaches):
        _close(got, want, 1e-5)
    want = np.asarray(jgenerate(jmodel, jparams, jnp.asarray(prompts), 6))
    got = serve.generate(model, params, torch.from_numpy(prompts).long(), 6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "qwen1.5-32b", "chameleon-34b"])
def test_bias_and_qk_norm_configs_match_the_jax_package(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert transformer.param_shapes(cfg) == jtf.param_shapes(jcfg)
    assert model_zoo.count_params(cfg) == jzoo.count_params(jcfg)
    small = reduced_config(cfg)
    attn = model_zoo.build(small).init(torch.Generator().manual_seed(0))["blocks"]["attn"]
    if cfg.qkv_bias:
        kv = 16 * small.n_kv_heads
        assert all(torch.equal(attn[b], torch.zeros(2, n))
                   for b, n in (("bq", 64), ("bk", kv), ("bv", kv)))
    if cfg.qk_norm:
        assert torch.equal(attn["q_norm"], torch.ones(2, 16))
        assert torch.equal(attn["k_norm"], torch.ones(2, 16))


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "chameleon-34b"])
def test_bias_and_qk_norm_archs_give_the_jax_packages_tokens(arch, jnp_kernels):
    """Reduced qwen2.5-32b (QKV bias) and chameleon-34b (qk-norm), with the
    biases and qk-norm weights moved off 0 and 1: the JAX ``generate``'s
    greedy tokens and its prefill logits."""
    jcfg = jreduced(jget_config(arch))
    jmodel = jzoo.build(jcfg)
    rng = np.random.RandomState(3)

    def move(path, t):
        if any(f"['{n}']" in jax.tree_util.keystr(path)
               for n in ("bq", "bk", "bv", "q_norm", "k_norm")):
            return t + 0.5 * jnp.asarray(rng.randn(*t.shape), t.dtype)
        return t
    jparams = jax.tree_util.tree_map_with_path(move, jmodel.init(jax.random.PRNGKey(0)))
    model = model_zoo.build(reduced_config(get_config(arch)))
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams))
    prompts = rng.randint(0, 512, (2, 32)).astype(np.int32)
    _, jlogits, _ = jmodel.prefill(AxisCtx(), jparams, {"tokens": jnp.asarray(prompts)})
    _, logits, _ = model.prefill(params, {"tokens": torch.from_numpy(prompts).long()})
    _close(logits, jlogits, 1e-4)
    want = np.asarray(jgenerate(jmodel, jparams, jnp.asarray(prompts), 6))
    got = serve.generate(model, params, torch.from_numpy(prompts).long(), 6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "chameleon-34b", *NEW_ARCHS])
def test_serve_main_runs_the_new_archs_on_the_cpu(arch, capsys):
    toks = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--max-new", "3"])
    assert toks.shape == (2, 3)
    assert f"arch={arch}-reduced device=cpu" in capsys.readouterr().out
