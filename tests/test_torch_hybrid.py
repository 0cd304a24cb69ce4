"""The port's Mamba + attention + MoE hybrid (jamba-1.5-large-398b,
``transformer._hybrid_period`` and the hybrid branches of the stack)
against the JAX package's, in f32 on the same numpy weights (JAX's
initializers, with the norms, biases and Mamba's constants moved off their
initial values, carried across with ``interop``) and tokens, at reduced
size (``repro.configs.reduce``: a period of 4, attention at index 2, MoE
at the odd sublayers), JAX on its CPU path (``REPRO_KERNEL_IMPL=jnp``), the
port on its kernels' plain versions.

- One ``_hybrid_period`` in the train and prefill phases (output, aux and
  the period's caches) and in decode from the JAX caches.
- reduced jamba: ``Model.loss`` (the aux losses added) and every gradient
  against ``jax.value_and_grad`` (loss rtol 1e-5, gradients atol and rtol
  1e-4, as ``tests/test_torch_lm_train.py``), the same under the rounds'
  ``vmap``; prefill logits within 1e-4 and the cache tree
  (``{"attn": KVCache, "mamba": [MambaState] * 3}``, each leaf stacked over
  the periods); 4 teacher-forced decode steps from the JAX caches carried
  in; the prefill-then-decode consistency of ``tests/test_models_smoke.py:85``
  inside the port; and the train launcher's rounds on the CPU.

Tolerance 1e-5 for the period (f32; the frameworks sum in other orders),
1e-4 for the model's logits and states.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro.configs.base import get_config as jget_config
from repro.configs.reduce import reduced_config as jreduced
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtf
from repro.sharding.axes import AxisCtx
from repro_torch import interop
from repro_torch.configs.base import get_config
from repro_torch.configs.reduce import reduced_config
from repro_torch.launch import train_fl_lm
from repro_torch.models import attention as attn
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
ARCH = "jamba-1.5-large-398b"
MOVED = ("w", "A_log", "D_skip", "conv_b", "dt_bias")
B, S, STEPS = 2, 32, 4


def _close(got, want, tol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol,
                               err_msg=msg)


def _moved(tree, seed):
    rng = np.random.RandomState(seed)

    def move(path, t):
        if path and getattr(path[-1], "key", None) in MOVED:
            return t + 0.1 * jnp.asarray(rng.randn(*t.shape), t.dtype)
        return t
    return jax.tree_util.tree_map_with_path(move, tree)


def _leaves_close(got, want, tol):
    got, want = jax.tree.leaves(interop.to_numpy(got)), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, tol)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX model on one set of weights and tokens, computed once: the
    loss and its gradients, the prefill, 4 teacher-forced decode steps (the
    prefill's caches kept as they were before the first), and one period in
    each phase."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_KERNEL_IMPL", "jnp")
        jcfg = jreduced(jget_config(ARCH))
        jmodel = jzoo.build(jcfg)
        jparams = _moved(jmodel.init(jax.random.PRNGKey(0)), 0)
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
        # one period on its own: train and prefill over x, then a decode token
        blk = jax.tree.map(lambda t: t[0], jparams["blocks"])
        x = rng.randn(B, S, jcfg.d_model).astype(np.float32)
        xd = rng.randn(B, 1, jcfg.d_model).astype(np.float32)
        period = jax.jit(lambda w, x, c, n, phase: jtf._hybrid_period(
            CTX, jcfg, w, x, phase=phase, caches=c, length=n), static_argnames="phase")
        y_tr, _, aux_tr = period(blk, jnp.asarray(x), None, None, phase="train")
        y_pf, c_pf, _ = period(blk, jnp.asarray(x), None, None, phase="prefill")
        # one free slot on the sequence dim of the period's (unstacked) KV cache
        pad = c_pf["attn"]._replace(**{f: jnp.pad(t, ((0, 0), (0, 1), (0, 0), (0, 0)))
                                       for f, t in c_pf["attn"]._asdict().items()})
        c_in = dict(c_pf, attn=pad)
        y_dc, c_dc, _ = period(blk, jnp.asarray(xd), c_in, jnp.full((B,), S, jnp.int32),
                               phase="decode")
        out["period"] = {"x": x, "xd": xd, "y_train": np.asarray(y_tr),
                         "aux_train": float(aux_tr), "y_prefill": np.asarray(y_pf),
                         "caches_prefill": jax.tree.map(np.asarray, c_pf),
                         "caches": jax.tree.map(np.asarray, c_in),
                         "y_decode": np.asarray(y_dc),
                         "caches_decode": jax.tree.map(np.asarray, c_dc)}
    return out


def _model():
    return model_zoo.build(reduced_config(get_config(ARCH)))


def test_hybrid_period_matches_the_jax_package(jax_ref):
    cfg = reduced_config(get_config(ARCH))
    ref = jax_ref["period"]
    blk = transformer._take(interop.params_from_numpy(jax_ref["params"])["blocks"], 0)
    x = torch.from_numpy(ref["x"])
    y, caches, aux = transformer._hybrid_period(cfg, blk, x, phase="train")
    assert caches["attn"] is None         # training keeps no attention cache
    _close(y, ref["y_train"])
    np.testing.assert_allclose(float(aux), ref["aux_train"], rtol=1e-5)
    y, caches, _ = transformer._hybrid_period(cfg, blk, x, phase="prefill")
    _close(y, ref["y_prefill"])
    assert isinstance(caches["attn"], attn.KVCache) and len(caches["mamba"]) == 3
    assert all(isinstance(st, ssm.MambaState) for st in caches["mamba"])
    _leaves_close(caches, ref["caches_prefill"], 1e-5)
    carried = interop.caches_from_numpy(ref["caches"])
    y, new, _ = transformer._hybrid_period(cfg, blk, torch.from_numpy(ref["xd"]),
                                           phase="decode", caches=carried,
                                           length=torch.full((B,), S, dtype=torch.int32))
    _close(y, ref["y_decode"])
    assert new["attn"].k.data_ptr() == carried["attn"].k.data_ptr()   # written in place
    _leaves_close(new, ref["caches_decode"], 1e-5)


def test_hybrid_loss_and_gradients_match_the_jax_package(jax_ref):
    model = transformer.FlatModel(_model())
    params = interop.params_from_numpy(flatten_params(jax_ref["params"]))
    batch = {k: torch.from_numpy(v).long() for k, v in jax_ref["batch"].items()}
    grads, loss = grad_and_value(model.loss)(params, batch)
    np.testing.assert_allclose(loss.item(), jax_ref["loss"], rtol=1e-5)
    want = jax_ref["grads"]
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], atol=1e-4, rtol=1e-4, err_msg=k)
    for k in ("blocks/mamba/A_log", "blocks/mamba/dt_proj", "blocks/moe/router",
              "blocks/attn/wq"):
        assert np.abs(want[k]).max() > 1e-6, k
    g1, l1 = vmap(grad_and_value(model.loss))({k: v[None] for k, v in params.items()},
                                              {k: v[None] for k, v in batch.items()})
    assert torch.equal(l1[0], loss)
    for k in grads:
        np.testing.assert_allclose(g1[k][0].numpy(), grads[k].numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=k)


def test_hybrid_prefill_and_teacher_forced_decode_match_the_jax_package(jax_ref):
    model = _model()
    params = interop.params_from_numpy(jax_ref["params"])
    caches, logits, _ = model.prefill(params, {"tokens": torch.from_numpy(
        jax_ref["batch"]["tokens"]).long()})
    _close(logits, jax_ref["logits"], 1e-4)
    assert isinstance(caches["attn"], attn.KVCache) and caches["attn"].k.shape[0] == 1
    assert caches["mamba"][0].h.shape == (1, B, 128, 4)
    _leaves_close(transformer.pad_caches(caches, STEPS), jax_ref["caches"], 1e-4)
    caches = interop.caches_from_numpy(jax_ref["caches"])
    length = torch.full((B,), S, dtype=torch.int32)
    for i in range(STEPS):
        logits, caches = model.decode_step(params, torch.from_numpy(jax_ref["forced"][i]).long(),
                                           caches, length + i)
        _close(logits, jax_ref["steps"][i], 1e-4)
    _leaves_close(caches, jax_ref["final_caches"], 1e-4)


def test_hybrid_prefill_then_decode_is_the_longer_prefill(jax_ref):
    """``tests/test_models_smoke.py:85`` inside the port."""
    model = _model()
    params = interop.params_from_numpy(jax_ref["params"])
    toks = torch.from_numpy(jax_ref["batch"]["tokens"]).long()
    caches, logits, _ = model.prefill(params, {"tokens": toks})
    nxt = model.greedy_token(logits)
    step, _ = model.decode_step(params, nxt, transformer.pad_caches(caches, 8),
                                torch.full((B,), S, dtype=torch.int32))
    _, last, _ = model.prefill(params, {"tokens": torch.cat([toks, nxt[:, None]], 1)})
    _close(step, last, 1e-4)


def test_train_fl_lm_runs_the_recurrent_archs_on_the_cpu(capsys):
    """``python -m repro_torch.launch.train_fl_lm --arch <arch>`` on the CPU
    at the reduced config's one period: jamba's loss falls over 3 rounds of
    fedavg. xlstm-125m's 3 rounds run with finite losses; at the example's
    client_lr 0.05 its loss rises in the JAX package's example too
    (``examples/train_fl_lm.py --arch xlstm-125m``: 6.2138 -> 6.3849 over 6
    rounds on the CPU), so no fall is asserted for it."""
    _, logger = train_fl_lm.main(["--arch", ARCH, "--device", "cpu", "--rounds", "3",
                                  "--seq", "32", "--local-steps", "2", "--strategy", "fedavg"])
    assert f"arch={reduced_config(get_config(ARCH)).name}" in capsys.readouterr().out
    assert logger.rows[-1]["loss"] < logger.rows[0]["loss"]
    cfg = train_fl_lm.scaled_config("xlstm-125m", "tiny")
    fl = train_fl_lm.FLConfig(strategy="fedavgm", n_clients=4, client_lr=0.05,
                              server_momentum=0.9)
    _, round_fn, state = train_fl_lm.setup(cfg, fl, torch.device("cpu"))
    lm = train_fl_lm.SyntheticLM(vocab=cfg.vocab_size, seed=0)
    _, logger = train_fl_lm.run_rounds(round_fn, state, lm, 0, 3, clients=4, cohort=2,
                                       batch=2, seq=32, local_steps=2, device="cpu")
    assert len(logger.rows) == 3 and all(np.isfinite(r["loss"]) for r in logger.rows)
