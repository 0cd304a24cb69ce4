"""The port's LM training path against the JAX package's, on reduced
configs with the same numpy weights (carried across with ``interop`` and
``transformer.flatten_params``) and the same numpy token batches.

- ``Model.loss`` and every gradient leaf against ``jax.value_and_grad`` of
  the JAX ``Model.loss`` (its CPU path: jnp flash attention under its
  ``custom_vjp``, RMSNorm differentiated through ``ref.rmsnorm_ref``), for
  yi-34b, qwen2.5-32b (QKV bias), chameleon-34b (qk-norm), minicpm3-4b
  (MLA, tied embeddings), qwen3-moe-30b-a3b (MoE, qk-norm; the loss adds
  the aux losses) and arctic-480b (subgrid MoE, dense residual), with the
  biases and norm weights moved off their initial 0 and 1 so that their
  gradients are exercised. Tolerances: loss rtol 1e-5; gradients atol and
  rtol 1e-4 (f32; the port's RMSNorm backward is the analytic formula, the
  JAX package's the autodiff of the forward, and the two sum in other
  orders).
- ``SyntheticLM`` tokens bitwise.
- 3 temporal rounds of fedavg, fedavgm and fedprox on fixed client data
  (as ``tests/test_system.py::test_fl_lm_round_with_strategies``) against
  the JAX ``build_temporal_round``, each strategy on one or two archs. Tolerances those of ``tests/test_torch_strategies.py``: loss rtol
  1e-5, params and server state atol 1e-5 / rtol 1e-4.
- A tied (MLA) LM checkpoint written by either package restores in the
  other. A checkpoint resume bitwise the uninterrupted run, bf16 leaves too, and
  ``python -m repro_torch.launch.train_fl_lm --device cpu`` end to end.
"""
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

import jax
import jax.numpy as jnp
from repro.configs.base import FLConfig as JFLConfig
from repro.configs.base import get_config as jget_config
from repro.configs.reduce import reduced_config as jreduced
from repro.core import determinism as jdet
from repro.core.rounds import build_temporal_round as j_build_temporal_round
from repro.core.rounds import init_state as j_init_state
from repro.core.strategies import get_strategy as j_get_strategy
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model_zoo as jzoo
from repro.sharding.axes import AxisCtx
from repro_torch import interop
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import FLConfig, get_config
from repro_torch.configs.reduce import reduced_config
from repro_torch.core import determinism
from repro_torch.core.jobs import load_job
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rms
from repro_torch.launch import train_fl_lm
from repro_torch.models import model_zoo
from repro_torch.models.transformer import FlatModel, flatten_params, unflatten_params
from repro_torch.runtime.executor import Executor


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


ARCHS = ("yi-34b", "qwen2.5-32b", "chameleon-34b", "minicpm3-4b", "qwen3-moe-30b-a3b",
         "arctic-480b")
MOVED = ("bq", "bk", "bv", "q_norm", "k_norm", "kv_norm")


@pytest.fixture
def jnp_kernels(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "jnp")


def _jax_params(arch):
    """The JAX model and its init, biases and qk-norm weights moved."""
    jmodel = jzoo.build(jreduced(jget_config(arch)))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)

    def move(path, t):
        if any(f"['{n}']" in jax.tree_util.keystr(path) for n in MOVED):
            return t + 0.1 * jnp.asarray(rng.randn(*t.shape), t.dtype)
        return t
    return jmodel, jax.tree_util.tree_map_with_path(move, jparams)


def _flat(tree):
    return flatten_params(jax.tree.map(np.asarray, tree))


def _tokens(seed, B=2, S=32):
    toks = np.random.RandomState(seed).randint(0, 512, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("arch", ARCHS)
def test_model_loss_and_gradients_match_the_jax_package(arch, jnp_kernels):
    jmodel, jparams = _jax_params(arch)
    batch = _tokens(1)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(AxisCtx(), p, batch), has_aux=True))(jparams)
    model = FlatModel(model_zoo.build(reduced_config(get_config(arch))))
    params = interop.params_from_numpy(_flat(jparams))
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    launches = (rms.rmsnorm.launches, fa.flash_attention_fwd.launches)
    grads, loss = grad_and_value(model.loss)(params, tbatch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = _flat(jgrads)
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], atol=1e-4, rtol=1e-4, err_msg=k)
    if arch not in ("yi-34b", "arctic-480b"):     # the two without biases or norms
        moved = [k for k in want if k.split("/")[-1] in MOVED]
        assert moved and all(np.abs(want[k]).max() > 1e-3 for k in moved)
    if get_config(arch).tie_embeddings:     # one embedding, its gradient from both ends
        assert "lm_head" not in grads and np.abs(want["embed"]).max() > 0
    if get_config(arch).moe is not None:    # the router learns (through the gates and aux)
        assert np.abs(want["blocks/moe/router"]).max() > 1e-6
    # the same under the rounds' vmap over one client with its own params
    g1, l1 = vmap(grad_and_value(model.loss))({k: v[None] for k, v in params.items()},
                                              {k: v[None] for k, v in tbatch.items()})
    assert torch.equal(l1[0], loss)
    for k in grads:
        np.testing.assert_allclose(g1[k][0].numpy(), grads[k].numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=k)
    # the CPU path takes the plain versions: no kernel launched
    assert launches == (rms.rmsnorm.launches, fa.flash_attention_fwd.launches)


def test_flat_view_round_trips_and_keeps_the_leaf_order():
    params = model_zoo.build(reduced_config(get_config("qwen2.5-32b"))).init(
        torch.Generator().manual_seed(0))
    flat = flatten_params(params)
    assert "blocks/attn/bq" in flat and flat["embed"] is params["embed"]
    back = unflatten_params(flat)
    assert all(back["blocks"][a][b] is params["blocks"][a][b]
               for a in params["blocks"] for b in params["blocks"][a])
    # a checkpoint numbers the flat state's leaves in the nested tree's order
    assert [t.data_ptr() for t in ckpt.leaves(flat)] == \
        [t.data_ptr() for t in ckpt.leaves(params)]


@pytest.mark.parametrize("seq,steps,salt", [(32, 2, 0), (7, 3, 5)])
def test_synthetic_lm_gives_the_jax_packages_tokens(seq, steps, salt):
    mine, theirs = SyntheticLM(vocab=512, seed=salt), JSyntheticLM(vocab=512, seed=salt)
    for c in (0, 3):
        got = mine.client_batches(c, steps, 2, seq, round_idx=1)
        want = theirs.client_batches(c, steps, 2, seq, round_idx=1)
        assert sorted(got) == ["labels", "tokens"]
        for k in got:
            assert got[k].dtype == want[k].dtype and got[k].shape == (steps, 2, seq)
            np.testing.assert_array_equal(got[k], want[k])


def _state_from_jax(jstate):
    server = jstate["server"]
    return {"params": interop.params_from_numpy(_flat(jstate["params"])),
            "server": ({k: interop.params_from_numpy(_flat(v)) for k, v in server.items()}
                       if server else ()),
            "clients": ()}


@pytest.mark.parametrize("arch,strategy", [
    ("qwen2.5-32b", "fedavgm"), ("chameleon-34b", "fedprox"), ("yi-34b", "fedavg"),
    ("minicpm3-4b", "fedavgm"), ("qwen3-moe-30b-a3b", "fedprox")])
def test_temporal_lm_rounds_match_the_jax_package(arch, strategy, jnp_kernels):
    kw = dict(strategy=strategy, client_lr=0.05, prox_mu=0.01, local_epochs=1,
              server_momentum=0.9, seed=0, n_clients=4)
    jfl, fl = JFLConfig(**kw), FLConfig(**kw)
    jcfg = jreduced(jget_config(arch))
    jmodel = jzoo.build(jcfg)
    jstrat = j_get_strategy(jfl)
    jround = jax.jit(lambda s, b, w, r: j_build_temporal_round(
        jmodel, jstrat, jfl, jcfg)(AxisCtx(), s, b, w, r))
    jstate = j_init_state(jmodel, jstrat, jfl, jdet.root_key(0))
    _, round_fn, _ = train_fl_lm.setup(reduced_config(get_config(arch)), fl, "cpu")
    state = _state_from_jax(jax.tree.map(np.asarray, jstate))
    lm = SyntheticLM(vocab=512, seed=0)
    # fixed client data across rounds: clients 0 and 1, their round-0 data
    batches = [lm.client_batches(c, 2, 2, 16, round_idx=0) for c in (0, 1)]
    batch = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    w = np.ones((2,), np.float32)
    losses = []
    for r in range(3):
        jstate, jm = jround(jstate, batch, jnp.asarray(w),
                            jdet.round_key(jdet.root_key(0), r))
        state, m = round_fn(state, tbatch, torch.from_numpy(w),
                            determinism.round_key(determinism.root_key(0), r))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
        want = _state_from_jax(jax.tree.map(np.asarray, jstate))
        for part in ("params", "server"):
            for k, v in ckpt._leaves(want[part]):
                got = dict(ckpt._leaves(state[part]))[k]
                np.testing.assert_allclose(got.numpy(), v.numpy(), atol=1e-5, rtol=1e-4,
                                           err_msg=f"round {r} {part}{k}")
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "minicpm3-4b"])
def test_int8_temporal_lm_rounds_match_the_jax_package(arch, jnp_kernels, monkeypatch):
    """``compressed`` with int8 through the temporal round: each client's
    send quantized leaf by leaf into its row of the (C_t, N) matrix, ONE B1
    call a round. A value within float noise of a rounding boundary can
    quantize one step apart in the two packages: at most 1e-3 of the
    entries may differ by more than the params' tolerance, each by at most
    one quantum (the largest block scale the round sent). Each round starts
    the port from the JAX package's state: a flipped value moves the next
    round's gradients, so flips compound over chained rounds (8-10x a round
    at this size, on either gradient path), and the rule holds for one
    quantization."""
    from repro_torch.core import rounds
    from repro_torch.kernels import ops
    kw = dict(strategy="compressed", compression="int8", client_lr=0.05, local_epochs=1,
              seed=0, n_clients=4)
    jfl, fl = JFLConfig(**kw), FLConfig(**kw)
    jcfg = jreduced(jget_config(arch))
    jmodel = jzoo.build(jcfg)
    jstrat = j_get_strategy(jfl)
    jround = jax.jit(lambda s, b, w, r: j_build_temporal_round(
        jmodel, jstrat, jfl, jcfg)(AxisCtx(), s, b, w, r))
    jstate = j_init_state(jmodel, jstrat, jfl, jdet.root_key(0))
    _, round_fn, _ = train_fl_lm.setup(reduced_config(get_config(arch)), fl, "cpu")
    scales = []
    agg = rounds.ops.quant_aggregate

    def recording(q, s, w):
        scales.append(float(s.max()))
        return agg(q, s, w)
    monkeypatch.setattr(rounds.ops, "quant_aggregate", recording)
    lm = SyntheticLM(vocab=512, seed=0)
    batches = [lm.client_batches(c, 2, 2, 16, round_idx=0) for c in (0, 1)]
    batch = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    w = np.array([1.0, 3.0], np.float32)
    losses = []
    with ops.quant_agg_scope() as frame:
        for r in range(3):
            state = _state_from_jax(jax.tree.map(np.asarray, jstate))
            jstate, jm = jround(jstate, batch, jnp.asarray(w),
                                jdet.round_key(jdet.root_key(0), r))
            state, m = round_fn(state, tbatch, torch.from_numpy(w),
                                determinism.round_key(determinism.root_key(0), r))
            np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
            want = _state_from_jax(jax.tree.map(np.asarray, jstate))["params"]
            outside = total = 0
            for k, v in want.items():
                diff = np.abs(state["params"][k].numpy() - v.numpy())
                tol = 1e-5 + 1e-4 * np.abs(v.numpy())
                assert (diff <= scales[-1] + tol).all(), (r, k)
                outside += int((diff > tol).sum())
                total += diff.size
            assert outside <= max(1, 1e-3 * total), (r, outside, total)
            losses.append(m["loss"].item())
    assert frame["calls"] == 3 and len(scales) == 3     # one B1 call a round
    assert losses[-1] < losses[0], losses


def _run(round_fn, state, lm, start, stop, ckpt_dir=None):
    return train_fl_lm.run_rounds(round_fn, state, lm, start, stop, clients=4, cohort=2,
                                  batch=2, seq=16, local_steps=2, device="cpu",
                                  ckpt_dir=ckpt_dir)


def test_lm_checkpoint_resume_is_bitwise_the_uninterrupted_run(tmp_path, monkeypatch):
    monkeypatch.setattr(train_fl_lm, "CKPT_EVERY", 2)
    cfg = train_fl_lm.scaled_config("qwen2.5-32b", "tiny")
    fl = FLConfig(strategy="fedavgm", n_clients=4, client_lr=0.05, server_momentum=0.9)
    lm = SyntheticLM(vocab=cfg.vocab_size, seed=0)
    _, round_fn, state0 = train_fl_lm.setup(cfg, fl, "cpu")
    whole, log_a = _run(round_fn, state0, lm, 0, 4)
    # the checkpoint of round 2, restored into a fresh state
    _run(round_fn, train_fl_lm.setup(cfg, fl, "cpu")[2], lm, 0, 3, ckpt_dir=tmp_path)
    assert ckpt.latest_round(tmp_path) == 2
    fresh = train_fl_lm.setup(cfg, fl, "cpu")[2]
    restored, extra = ckpt.restore(tmp_path, 2, fresh)
    assert extra == {"next_round": 2}
    resumed, log_b = _run(round_fn, restored, lm, 2, 4)
    assert log_b.series("loss") == log_a.series("loss")[2:]
    for part in ("params", "server"):
        for (k, a), (_, b) in zip(ckpt._leaves(whole[part]), ckpt._leaves(resumed[part])):
            assert torch.equal(a, b), k


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tied_lm_checkpoint_restores_in_both_packages(writer, tmp_path):
    """Reduced minicpm3-4b (tied: no ``lm_head`` leaf; MLA's leaf names):
    a FedAvgM state written by one package restores bitwise into the
    other's, leaf for leaf in the JAX flatten order."""
    from repro.checkpoint import ckpt as j_ckpt
    fl_kw = dict(strategy="fedavgm", n_clients=4, server_momentum=0.9)
    jcfg = jreduced(jget_config("minicpm3-4b"))
    jfl = JFLConfig(**fl_kw)
    jstate = j_init_state(jzoo.build(jcfg), j_get_strategy(jfl), jfl, jdet.root_key(3))
    state = _state_from_jax(jax.tree.map(np.asarray, jstate))
    assert "lm_head" not in state["params"] and "blocks/attn/wdkv" in state["params"]
    _, _, fresh = train_fl_lm.setup(reduced_config(get_config("minicpm3-4b")),
                                    FLConfig(**fl_kw), "cpu")
    if writer == "jax":
        j_ckpt.save(tmp_path, 1, jstate, extra={"next_round": 1}, async_write=False)
        back, extra = ckpt.restore(tmp_path, 1, fresh)
        assert extra == {"next_round": 1}
        for (k, a), (_, b) in zip(ckpt._leaves(state), ckpt._leaves(back)):
            assert torch.equal(a, b), k
    else:
        ckpt.save(tmp_path, 1, state)
        jfresh = jax.tree.map(jnp.zeros_like, jstate)
        jback, _ = j_ckpt.restore(tmp_path, 1, jfresh)
        for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(jback)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_lm_state_saves_and_restores_bitwise(tmp_path):
    cfg = train_fl_lm.scaled_config("chameleon-34b", "tiny")
    fl = FLConfig(strategy="fedavgm", n_clients=4)
    _, _, state = train_fl_lm.setup(cfg, fl, "cpu", dtype=torch.bfloat16)
    assert {t.dtype for t in ckpt.leaves(state)} == {torch.bfloat16}
    ckpt.save(tmp_path, 3, state)
    fresh = {"params": {k: torch.zeros_like(v) for k, v in state["params"].items()},
             "server": {"momentum": {k: torch.zeros_like(v) for k, v in
                                     state["server"]["momentum"].items()}},
             "clients": ()}
    back, _ = ckpt.restore(tmp_path, 3, fresh)
    for a, b in zip(ckpt.leaves(state), ckpt.leaves(back)):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b)


def test_train_fl_lm_main_runs_on_the_cpu_and_the_loss_falls(capsys):
    _, logger = train_fl_lm.main(["--device", "cpu", "--rounds", "3",
                                  "--arch", "qwen2.5-32b"])
    out = capsys.readouterr().out
    assert "arch=qwen2.5-32b-reduced scale=tiny device=cpu" in out
    assert "round    0 loss" in out and "FL dashboard" in out
    losses = logger.series("loss")
    assert len(losses) == 3 and losses[-1] < losses[0]


def test_the_executor_sends_an_lm_job_to_train_fl_lm():
    job = load_job({"model": {"arch": "qwen2.5-32b"},
                    "dataset": {"dataset": "synthetic_lm"},
                    "strategy": {"strategy": "fedavg", "train_params": {"rounds": 1}}})
    assert isinstance(job.dataset, SyntheticLM) and job.dataset.vocab == 152064
    with pytest.raises(ValueError, match="repro_torch.launch.train_fl_lm"):
        Executor(job, device="cpu").scaffold()
