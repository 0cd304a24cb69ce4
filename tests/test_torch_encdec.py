"""The port's encoder-decoder (whisper-base: ``layers.layer_norm``, the
sinusoidal positions, the GELU MLP with biases, ``gqa_seqsharded(causal=
False)``, cross-attention, ``EncDecModel``) against the JAX package's, in
f32 on the same numpy weights (JAX's initializers, the LayerNorm weights
and every bias moved off 1 and 0, carried across with ``interop``), frames
and tokens, at reduced size (``repro.configs.reduce``: 2 encoder and 2
decoder layers), JAX on its CPU path (``REPRO_KERNEL_IMPL=jnp``), the port
on its kernels' plain versions.

- ``layer_norm``, ``_sinusoid``, the MLP (tanh GELU, as ``jax.nn.gelu``'s
  default; the exact erf differs), the encoder's non-causal
  self-attention and ``_cross_attn`` (Sq = S_dec over S_enc keys).
- reduced whisper-base: ``EncDecModel.loss`` and every gradient against
  ``jax.value_and_grad`` (loss rtol 1e-5, gradients atol and rtol 1e-4, as
  ``tests/test_torch_lm_train.py``; the B3 backward non-causal at Sq != Sk
  through the cross-attention), the same under the rounds' ``vmap``;
  prefill logits within 1e-4 and the ``EncDecCaches``; 4 teacher-forced
  decode steps from the JAX caches carried in (B4 ``combine=False`` over
  the encoder cache); the prefill-then-decode consistency of
  ``tests/test_models_smoke.py:85`` inside the port.

Batches are built as ``tests/test_models_smoke.py:24-36`` builds them:
frames (B, S, D), decoder tokens of S // 8 (at least 8).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro.configs.base import get_config as jget_config
from repro.configs.reduce import reduced_config as jreduced
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtf
from repro.sharding.axes import AxisCtx
from repro_torch import interop
from repro_torch.configs.base import get_config
from repro_torch.configs.reduce import reduced_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as attn
from repro_torch.models import layers, model_zoo, transformer
from repro_torch.models.transformer import flatten_params


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
ARCH = "whisper-base"
MOVED = ("w", "b", "b1", "b2")
B, S_ENC, STEPS = 2, 32, 4
S_DEC = max(S_ENC // 8, 8)


def _close(got, want, tol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol,
                               err_msg=msg)


def _cfgs():
    return jreduced(jget_config(ARCH)), reduced_config(get_config(ARCH))


def _moved(tree, seed):
    rng = np.random.RandomState(seed)

    def move(path, t):
        if path and getattr(path[-1], "key", None) in MOVED:
            return t + 0.1 * jnp.asarray(rng.randn(*t.shape), t.dtype)
        return t
    return jax.tree_util.tree_map_with_path(move, tree)


def _x(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _block(seed, which="blocks"):
    """Layer 0 of the JAX init's encoder or decoder blocks, moved, and the
    port's copy."""
    jcfg, _ = _cfgs()
    jblk = jax.tree.map(lambda t: t[0], _moved(jtf.init_params(
        jax.random.PRNGKey(seed), jcfg), seed)[which])
    return jblk, interop.params_from_numpy(jax.tree.map(np.asarray, jblk))


def test_config_and_param_shapes_match_the_jax_package():
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduced_config(cfg)) == dataclasses.asdict(jreduced(jcfg))
    assert transformer.param_shapes(cfg) == jtf.param_shapes(jcfg)
    assert model_zoo.count_params(cfg) == jzoo.count_params(jcfg)
    p = model_zoo.build(reduced_config(cfg)).init(torch.Generator().manual_seed(0))
    assert torch.equal(p["enc_blocks"]["ln1"]["w"], torch.ones(2, 64))
    assert not p["enc_blocks"]["ln1"]["b"].any() and not p["blocks"]["mlp"]["b1"].any()
    assert torch.equal(p["enc_final_norm"]["w"], torch.ones(64))


def test_layer_norm_sinusoid_and_mlp_match_the_jax_package():
    jcfg, cfg = _cfgs()
    x = _x(3, 7, 64, seed=0) * 2 + 1
    w, b = _x(64, seed=1), _x(64, seed=2)
    _close(layers.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)),
           jlayers.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    pos = np.arange(1500)
    _close(transformer._sinusoid(torch.from_numpy(pos), 512), jtf._sinusoid(pos, 512), 2e-4)
    _close(transformer._sinusoid(torch.arange(40), 64), jtf._sinusoid(np.arange(40), 64))
    jblk, blk = _block(3)
    assert set(blk["mlp"]) == {"w1", "b1", "w2", "b2"}
    _close(transformer.mlp_forward(blk["mlp"], torch.from_numpy(x), cfg),
           jtf.mlp_forward(CTX, jblk["mlp"], jnp.asarray(x), jcfg))
    h = torch.from_numpy(x) @ blk["mlp"]["w1"] + blk["mlp"]["b1"]
    erf = torch.nn.functional.gelu(h) @ blk["mlp"]["w2"] + blk["mlp"]["b2"]
    assert not torch.allclose(erf, transformer.mlp_forward(blk["mlp"], torch.from_numpy(x),
                                                            cfg), atol=1e-5)


def test_encoder_and_cross_attention_match_the_jax_package(jnp_kernels):
    """The encoder's self-attention (non-causal, rope) and the decoder's
    cross-attention over the encoder's K/V (non-causal, no rope, S_DEC
    queries over S_ENC keys) on B3's plain version."""
    jcfg, cfg = _cfgs()
    jblk, blk = _block(4, "enc_blocks")
    h = _x(B, S_ENC, 64, seed=5)
    before = fa.flash_attention_fwd.launches
    full = attn.gqa_seqsharded(blk["attn"], torch.from_numpy(h), cfg, causal=False)
    _close(full, jattn.gqa_seqsharded(CTX, jblk["attn"], jnp.asarray(h), jcfg, causal=False))
    causal = attn.gqa_seqsharded(blk["attn"], torch.from_numpy(h), cfg)
    assert not torch.allclose(full, causal, atol=1e-3)
    jdec, dec = _block(6)
    xd = _x(B, S_DEC, 64, seed=7)
    jk, jv = jtf._enc_kv(CTX, jcfg, jdec["xattn"], jnp.asarray(h))
    k, v = transformer._enc_kv(cfg, dec["xattn"], torch.from_numpy(h))
    _close(k, jk)
    _close(v, jv)
    _close(transformer._cross_attn(cfg, dec["xattn"], torch.from_numpy(xd), k, v),
           jtf._cross_attn(CTX, jcfg, jdec["xattn"], jnp.asarray(xd), jk, jv))
    assert fa.flash_attention_fwd.launches == before       # the CPU path: plain


# -- reduced whisper-base as a whole -----------------------------------------

@pytest.fixture(scope="module")
def jax_ref():
    """The JAX model on one set of weights, frames and tokens, computed
    once: the loss and its gradients, the prefill, and 4 teacher-forced
    decode steps (the prefill's caches kept as they were before the
    first)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_KERNEL_IMPL", "jnp")
        jmodel = jzoo.build(jreduced(jget_config(ARCH)))
        jparams = _moved(jmodel.init(jax.random.PRNGKey(0)), 0)
        rng = np.random.RandomState(1)
        toks = rng.randint(0, 512, (B, S_DEC + 1)).astype(np.int32)
        batch = {"frames": rng.randn(B, S_ENC, 64).astype(np.float32),
                 "tokens": toks[:, :-1], "labels": toks[:, 1:]}
        forced = rng.randint(0, 512, (STEPS, B)).astype(np.int32)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jmodel.loss(CTX, p, batch), has_aux=True))(jparams)
        caches, logits, _ = jax.jit(lambda p, b: jmodel.prefill(CTX, p, b))(
            jparams, {k: batch[k] for k in ("frames", "tokens")})
        caches = jtf.pad_caches(caches, STEPS)
        out = {"params": jax.tree.map(np.asarray, jparams), "batch": batch, "forced": forced,
               "loss": float(loss), "grads": flatten_params(jax.tree.map(np.asarray, grads)),
               "logits": np.asarray(logits), "caches": jax.tree.map(np.asarray, caches)}
        dec = jax.jit(lambda p, t, c, n: jmodel.decode_step(CTX, p, t, c, n, tp=False))
        length, steps = np.full((B,), S_DEC, np.int32), []
        for i in range(STEPS):
            lg, caches = dec(jparams, jnp.asarray(forced[i]), caches, jnp.asarray(length + i))
            steps.append(np.asarray(lg))
        out["steps"], out["final_caches"] = steps, jax.tree.map(np.asarray, caches)
    return out


def _model():
    return model_zoo.build(reduced_config(get_config(ARCH)))


def _tbatch(batch):
    return {k: torch.from_numpy(v) if v.dtype == np.float32 else torch.from_numpy(v).long()
            for k, v in batch.items()}


def test_encdec_loss_and_gradients_match_the_jax_package(jax_ref):
    model = transformer.FlatModel(_model())
    assert type(model.model).__name__ == "EncDecModel"
    params = interop.params_from_numpy(flatten_params(jax_ref["params"]))
    batch = _tbatch(jax_ref["batch"])
    grads, loss = grad_and_value(model.loss)(params, batch)
    np.testing.assert_allclose(loss.item(), jax_ref["loss"], rtol=1e-5)
    want = jax_ref["grads"]
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], atol=1e-4, rtol=1e-4, err_msg=k)
    for k in ("blocks/xattn/wk", "enc_blocks/attn/wq", "enc_blocks/ln1/b", "blocks/mlp/b1"):
        assert np.abs(want[k]).max() > 1e-5, k     # reached through the cross-attention
    g1, l1 = vmap(grad_and_value(model.loss))({k: v[None] for k, v in params.items()},
                                              {k: v[None] for k, v in batch.items()})
    assert torch.equal(l1[0], loss)
    for k in grads:
        np.testing.assert_allclose(g1[k][0].numpy(), grads[k].numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=k)


def test_encdec_prefill_and_teacher_forced_decode_match_the_jax_package(jax_ref):
    model = _model()
    params = interop.params_from_numpy(jax_ref["params"])
    batch = _tbatch(jax_ref["batch"])
    caches, logits, _ = model.prefill(params, {k: batch[k] for k in ("frames", "tokens")})
    _close(logits, jax_ref["logits"], 1e-4)
    assert isinstance(caches, transformer.EncDecCaches)
    assert caches.cross_k.shape == (2, B, S_ENC, 4, 16)
    padded = transformer.pad_caches(caches, STEPS)
    assert padded.self_caches.k.shape[2] == S_DEC + STEPS and padded.cross_k is caches.cross_k
    for got, want in zip(jax.tree.leaves(interop.to_numpy(padded)),
                         jax.tree.leaves(jax_ref["caches"])):
        _close(got, want, 1e-4)
    caches = interop.caches_from_numpy(jax_ref["caches"])
    length = torch.full((B,), S_DEC, dtype=torch.int32)
    before = da.decode_attention_fwd.launches
    for i in range(STEPS):
        logits, caches = model.decode_step(params, torch.from_numpy(jax_ref["forced"][i]).long(),
                                           caches, length + i)
        _close(logits, jax_ref["steps"][i], 1e-4)
    assert da.decode_attention_fwd.launches == before      # the CPU path: plain
    for got, want in zip(jax.tree.leaves(interop.to_numpy(caches)),
                         jax.tree.leaves(jax_ref["final_caches"])):
        _close(got, want, 1e-4)


def test_encdec_prefill_then_decode_is_the_longer_prefill(jax_ref):
    """``tests/test_models_smoke.py:85`` inside the port."""
    model = _model()
    params = interop.params_from_numpy(jax_ref["params"])
    batch = _tbatch(jax_ref["batch"])
    caches, logits, _ = model.prefill(params, {k: batch[k] for k in ("frames", "tokens")})
    nxt = model.greedy_token(logits)
    step, _ = model.decode_step(params, nxt, transformer.pad_caches(caches, 8),
                                torch.full((B,), S_DEC, dtype=torch.int32))
    ext = {"frames": batch["frames"], "tokens": torch.cat([batch["tokens"], nxt[:, None]], 1)}
    _, last, _ = model.prefill(params, ext)
    _close(step, last, 1e-4)
