"""The port's recurrent blocks (``repro_torch/models/ssm.py``: Mamba's
chunked selective scan and decode, the chunkwise mLSTM, the sequential
sLSTM) and the xLSTM LM (xlstm-125m) against the JAX package's, in f32 on
the same numpy weights (JAX's initializers, carried across with
``interop``) and inputs, at reduced size (``repro.configs.reduce``), JAX on
its CPU path (``REPRO_KERNEL_IMPL=jnp``), the port on its kernels' plain
versions.

- Mamba at Q < S (two chunks) and Q = S, from a fresh state and from a
  carried one, and ``mamba_decode``; the log-step scan against a step by
  step loop and ``jax.lax.associative_scan``; under ``vmap(grad)``.
- The mLSTM across four chunks and the sLSTM, each also from a carried
  state; one ``_xlstm_period``.
- reduced xlstm-125m: ``Model.loss`` and every gradient against
  ``jax.value_and_grad`` (loss rtol 1e-5, gradients atol and rtol 1e-4, as
  ``tests/test_torch_lm_train.py``), prefill logits within 1e-4, 4
  teacher-forced decode steps from the JAX caches carried in, and the
  prefill-then-decode consistency of ``tests/test_models_smoke.py:85``
  inside the port.

Tolerance 1e-5 for the blocks (f32; the two frameworks sum the matmuls and
scans in other orders), 1e-4 for the model's logits and states.
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
from repro.models import model_zoo as jzoo
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.sharding.axes import AxisCtx
from repro_torch import interop
from repro_torch.configs.base import get_config
from repro_torch.configs.reduce import reduced_config
from repro_torch.models import model_zoo, ssm, transformer
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


CTX = AxisCtx()
TOL = 1e-5
ARCH = "xlstm-125m"


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol,
                               err_msg=msg)


def _cfgs(arch):
    return jreduced(jget_config(arch)), reduced_config(get_config(arch))


def _x(B, S, D, seed):
    return np.random.RandomState(seed).randn(B, S, D).astype(np.float32)


def _moved(tree, seed, names, scale=0.1):
    """JAX params with the leaves named in ``names`` moved off their
    initial constants (so their gradients and effects are exercised)."""
    rng = np.random.RandomState(seed)

    def move(path, t):
        if path and getattr(path[-1], "key", None) in names:
            return t + scale * jnp.asarray(rng.randn(*t.shape), t.dtype)
        return t
    return jax.tree_util.tree_map_with_path(move, tree)


def _mamba_weights(seed=0):
    jcfg, cfg = _cfgs("jamba-1.5-large-398b")
    jw = _moved(jssm.init_mamba_params(jax.random.PRNGKey(seed), jcfg), seed,
                ("A_log", "D_skip", "conv_b", "dt_bias"))
    return jcfg, cfg, jw, interop.params_from_numpy(jax.tree.map(np.asarray, jw))


def test_configs_and_param_shapes_match_the_jax_package():
    for arch in (ARCH, "jamba-1.5-large-398b"):
        cfg, jcfg = get_config(arch), jget_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(reduced_config(cfg)) == dataclasses.asdict(jreduced(jcfg))
        assert transformer.param_shapes(cfg) == jtf.param_shapes(jcfg)
        assert transformer.n_stacks(cfg) == jtf.n_stacks(jcfg)
        for active in (False, True):
            assert model_zoo.count_params(cfg, active_only=active) == \
                jzoo.count_params(jcfg, active_only=active)
    cfg = get_config(ARCH)
    assert ssm.xlstm_dims(cfg) == (1536, 4, 384)          # matrix memory (B, 4, 384, 384)
    assert ssm.mamba_dims(get_config("jamba-1.5-large-398b")) == (16384, 512, 16, 4)
    assert ssm.mamba_chunk_len(get_config("jamba-1.5-large-398b"), 8, 2048) == 16


def test_log_step_scan_is_the_recurrence():
    """The Hillis-Steele doubling against the recurrence step by step and
    against ``jax.lax.associative_scan`` with the JAX package's combine, at
    a chunk length that is not a power of two."""
    rng = np.random.RandomState(0)
    a = rng.uniform(0.2, 1.0, (2, 13, 3, 4)).astype(np.float32)
    b = rng.randn(2, 13, 3, 4).astype(np.float32)
    aa, bb = ssm._linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    h, hs, p, ps = np.zeros_like(b[:, 0]), [], np.ones_like(a[:, 0]), []
    for t in range(13):
        h, p = a[:, t] * h + b[:, t], p * a[:, t]
        hs.append(h)
        ps.append(p)
    _close(bb, np.stack(hs, 1))
    _close(aa, np.stack(ps, 1))
    ja, jb = jax.lax.associative_scan(
        lambda l, r: (l[0] * r[0], l[1] * r[0] + r[1]), (jnp.asarray(a), jnp.asarray(b)),
        axis=1)
    _close(bb, jb)
    _close(aa, ja)


@pytest.mark.parametrize("S", [64, 32])        # Q = 32: two chunks, then Q = S
def test_mamba_forward_matches_the_jax_package(S):
    jcfg, cfg, jw, w = _mamba_weights()
    assert ssm.mamba_chunk_len(cfg, 2, S) == 32
    x = _x(2, S, cfg.d_model, 1)
    jy, jst = jssm.mamba_forward(jw, jnp.asarray(x), jcfg)
    y, st = ssm.mamba_forward(w, torch.from_numpy(x), cfg)
    assert isinstance(st, ssm.MambaState) and y.shape == (2, S, cfg.d_model)
    _close(y, jy)
    _close(st.h, jst.h)
    _close(st.conv, jst.conv)
    # on from the carried state
    x2 = _x(2, S, cfg.d_model, 2)
    jy2, jst2 = jssm.mamba_forward(jw, jnp.asarray(x2), jcfg, state=jst)
    y2, st2 = ssm.mamba_forward(w, torch.from_numpy(x2), cfg,
                                state=interop.caches_from_numpy(jax.tree.map(np.asarray, jst)))
    _close(y2, jy2)
    _close(st2.h, jst2.h)


def test_mamba_decode_matches_the_jax_package_and_the_longer_scan():
    jcfg, cfg, jw, w = _mamba_weights(3)
    x = _x(2, 20, cfg.d_model, 4)
    _, jst = jssm.mamba_forward(jw, jnp.asarray(x[:, :16]), jcfg)
    st = interop.caches_from_numpy(jax.tree.map(np.asarray, jst))
    ys = []
    for t in range(16, 20):
        jy, jst = jssm.mamba_decode(jw, jnp.asarray(x[:, t:t + 1]), jcfg, jst)
        y, st = ssm.mamba_decode(w, torch.from_numpy(x[:, t:t + 1]), cfg, st)
        _close(y, jy)
        ys.append(y)
    _close(st.h, jst.h)
    _close(st.conv, jst.conv)
    full, _ = ssm.mamba_forward(w, torch.from_numpy(x), cfg)
    _close(torch.cat(ys, 1), full[:, 16:])


def test_mamba_gradients_under_vmap_match_the_jax_package():
    """``vmap(grad_and_value)`` over two clients (the FL rounds' transform)
    against ``jax.value_and_grad`` of each client."""
    jcfg, cfg, jw, w = _mamba_weights(5)
    xs = _x(4, 64, cfg.d_model, 6).reshape(2, 2, 64, cfg.d_model)   # two chunks each

    def jloss(p, x):
        return jnp.mean(jssm.mamba_forward(p, x, jcfg)[0] ** 2)

    def loss(p, x):
        return torch.mean(ssm.mamba_forward(p, x, cfg)[0] ** 2)
    g, l = vmap(grad_and_value(loss), in_dims=(None, 0))(w, torch.from_numpy(xs))
    for c in range(2):
        jl, jg = jax.value_and_grad(jloss)(jw, jnp.asarray(xs[c]))
        np.testing.assert_allclose(l[c].item(), float(jl), rtol=1e-5)
        for k in jg:
            _close(g[k][c], jg[k], 1e-4, k)


def test_mamba_refuses_a_sharded_mixer():
    _, cfg, _, w = _mamba_weights()
    half = dict(w, in_proj_x=w["in_proj_x"][:, :64])
    with pytest.raises(ValueError, match="ROADMAP A16"):
        ssm.mamba_forward(half, torch.zeros(1, 4, cfg.d_model), cfg)


def _xlstm_weights(seed=0):
    jcfg, cfg = _cfgs(ARCH)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    jm = _moved(jssm.init_mlstm_params(k1, jcfg), seed, ("o_norm",))
    js = _moved(jssm.init_slstm_params(k2, jcfg), seed + 1, ("b",), scale=0.5)
    to = lambda t: interop.params_from_numpy(jax.tree.map(np.asarray, t))  # noqa: E731
    return jcfg, cfg, jm, js, to(jm), to(js)


def test_mlstm_matches_the_jax_package_across_chunks():
    """S = 128 at the reduced chunk of 32: four chunks; then 32 more steps
    from the carried state."""
    jcfg, cfg, jw, _, w, _ = _xlstm_weights()
    x = _x(2, 128, cfg.d_model, 1)
    jy, jst = jssm.mlstm_forward(jw, jnp.asarray(x), jcfg)
    y, st = ssm.mlstm_forward(w, torch.from_numpy(x), cfg)
    assert isinstance(st, ssm.MLSTMState) and st.C.shape == (2, 4, 32, 32)
    _close(y, jy)
    for got, want in zip(st, jst):
        _close(got, want)
    x2 = _x(2, 32, cfg.d_model, 2)
    jy2, jst2 = jssm.mlstm_forward(jw, jnp.asarray(x2), jcfg, state=jst)
    y2, st2 = ssm.mlstm_forward(w, torch.from_numpy(x2), cfg,
                                state=interop.caches_from_numpy(jax.tree.map(np.asarray, jst)))
    _close(y2, jy2)
    for got, want in zip(st2, jst2):
        _close(got, want)


def test_slstm_matches_the_jax_package():
    jcfg, cfg, _, jw, _, w = _xlstm_weights(2)
    x = _x(2, 24, cfg.d_model, 3)
    jy, jst = jssm.slstm_forward(jw, jnp.asarray(x[:, :16]), jcfg)
    y, st = ssm.slstm_forward(w, torch.from_numpy(x[:, :16]), cfg)
    _close(y, jy)
    for got, want in zip(st, jst):
        _close(got, want)
    jy, jst = jssm.slstm_forward(jw, jnp.asarray(x[:, 16:]), jcfg, state=jst)
    y, st = ssm.slstm_forward(w, torch.from_numpy(x[:, 16:]), cfg, state=st)
    _close(y, jy)
    # the FFN's GELU is the tanh form: the exact erf would differ
    h = torch.randn(4, cfg.d_model) * 3
    assert not torch.allclose(torch.nn.functional.gelu(h), torch.nn.functional.gelu(
        h, approximate="tanh"), atol=1e-5)


def test_xlstm_period_matches_the_jax_package():
    jcfg, cfg = _cfgs(ARCH)
    jp = _moved(jtf.init_params(jax.random.PRNGKey(7), jcfg), 7, ("o_norm", "w", "b"))
    jblk = jax.tree.map(lambda t: t[0], jp["blocks"])
    blk = interop.params_from_numpy(jax.tree.map(np.asarray, jblk))
    x = _x(2, 40, cfg.d_model, 8)
    jy, jc, _ = jtf._xlstm_period(CTX, jcfg, jblk, jnp.asarray(x), phase="prefill")
    y, c, aux = transformer._xlstm_period(cfg, blk, torch.from_numpy(x), phase="prefill")
    assert aux == 0.0 and len(c["mlstm"]) == 1
    _close(y, jy)
    for got, want in zip(jax.tree.leaves(interop.to_numpy(c)), jax.tree.leaves(jc)):
        _close(got, want)


# -- reduced xlstm-125m as a whole -------------------------------------------

B, S, STEPS = 2, 32, 4


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX model on one set of weights and tokens, computed once: the
    loss and its gradients, the prefill, and 4 teacher-forced decode steps
    (the prefill's caches kept as they were before the first)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_KERNEL_IMPL", "jnp")
        jmodel = jzoo.build(jreduced(jget_config(ARCH)))
        jparams = _moved(jmodel.init(jax.random.PRNGKey(0)), 0, ("o_norm", "w", "b"))
        rng = np.random.RandomState(1)
        toks = rng.randint(0, 512, (B, S + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        forced = rng.randint(0, 512, (STEPS, B)).astype(np.int32)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jmodel.loss(CTX, p, batch), has_aux=True))(jparams)
        caches, logits, _ = jax.jit(lambda p, b: jmodel.prefill(CTX, p, b))(
            jparams, {"tokens": batch["tokens"]})
        caches = jtf.pad_caches(caches, STEPS)
        out = {"params": jax.tree.map(np.asarray, jparams), "batch": batch, "forced": forced,
               "loss": float(loss), "grads": flatten_params(jax.tree.map(np.asarray, grads)),
               "logits": np.asarray(logits), "caches": jax.tree.map(np.asarray, caches)}
        dec = jax.jit(lambda p, t, c, n: jmodel.decode_step(CTX, p, t, c, n, tp=False))
        length, steps = np.full((B,), S, np.int32), []
        for i in range(STEPS):
            lg, caches = dec(jparams, jnp.asarray(forced[i]), caches, jnp.asarray(length + i))
            steps.append(np.asarray(lg))
        out["steps"], out["final_caches"] = steps, jax.tree.map(np.asarray, caches)
    return out


def _model():
    return model_zoo.build(reduced_config(get_config(ARCH)))


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def test_xlstm_loss_and_gradients_match_the_jax_package(jax_ref):
    model = transformer.FlatModel(_model())
    params = interop.params_from_numpy(flatten_params(jax_ref["params"]))
    batch = _tbatch(jax_ref["batch"])
    grads, loss = grad_and_value(model.loss)(params, batch)
    np.testing.assert_allclose(loss.item(), jax_ref["loss"], rtol=1e-5)
    want = jax_ref["grads"]
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], atol=1e-4, rtol=1e-4, err_msg=k)
    assert np.abs(want["blocks/slstm/rh"]).max() > 1e-4     # through the recurrence
    # the same under the rounds' vmap over one client
    g1, l1 = vmap(grad_and_value(model.loss))({k: v[None] for k, v in params.items()},
                                              {k: v[None] for k, v in batch.items()})
    assert torch.equal(l1[0], loss)
    for k in grads:
        np.testing.assert_allclose(g1[k][0].numpy(), grads[k].numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=k)


def test_xlstm_prefill_and_teacher_forced_decode_match_the_jax_package(jax_ref):
    model = _model()
    params = interop.params_from_numpy(jax_ref["params"])
    caches, logits, _ = model.prefill(params, {"tokens": torch.from_numpy(
        jax_ref["batch"]["tokens"]).long()})
    _close(logits, jax_ref["logits"], 1e-4)
    assert isinstance(caches["slstm"], ssm.SLSTMState) and \
        isinstance(caches["mlstm"][0], ssm.MLSTMState)
    for got, want in zip(jax.tree.leaves(interop.to_numpy(transformer.pad_caches(
            caches, STEPS))), jax.tree.leaves(jax_ref["caches"])):
        _close(got, want, 1e-4)
    # decode from the JAX caches carried in
    caches = interop.caches_from_numpy(jax_ref["caches"])
    length = torch.full((B,), S, dtype=torch.int32)
    for i in range(STEPS):
        logits, caches = model.decode_step(params, torch.from_numpy(jax_ref["forced"][i]).long(),
                                           caches, length + i)
        _close(logits, jax_ref["steps"][i], 1e-4)
    for got, want in zip(jax.tree.leaves(interop.to_numpy(caches)),
                         jax.tree.leaves(jax_ref["final_caches"])):
        _close(got, want, 1e-4)


def test_xlstm_prefill_then_decode_is_the_longer_prefill(jax_ref):
    """``tests/test_models_smoke.py:85`` inside the port: prefill on S
    tokens, then one decode step, against the prefill over S + 1."""
    model = _model()
    params = interop.params_from_numpy(jax_ref["params"])
    toks = torch.from_numpy(jax_ref["batch"]["tokens"]).long()
    caches, logits, _ = model.prefill(params, {"tokens": toks})
    nxt = model.greedy_token(logits)
    step, _ = model.decode_step(params, nxt, transformer.pad_caches(caches, 8),
                                torch.full((B,), S, dtype=torch.int32))
    _, last, _ = model.prefill(params, {"tokens": torch.cat([toks, nxt[:, None]], 1)})
    _close(step, last, 1e-4)
