"""Rematerialization of the LM training step and the client gradient rule
of ``core/rounds.local_train`` (ROADMAP A15.2a).

For every LM family at its reduced size (dense GQA yi-34b, QKV bias
qwen2.5-32b, tied MLA minicpm3-4b, MoE qwen3-moe-30b-a3b, encoder-decoder
whisper-base, xLSTM xlstm-125m, the Mamba + attention + MoE hybrid
jamba-1.5-large-398b), on token batches drawn from a seed with numpy:

- ``model.loss`` under plain autograd (rematerialized) gives the loss of
  ``torch.func.grad_and_value(model.loss)`` bitwise, and every gradient
  within 1e-6 of max(1, max |want|) of it (functorch's backward sums some
  gradients, the embedding's among them, in another order); and bitwise
  the gradient of plain autograd keeping every activation (the test's
  baseline: ``layers.func_transform_active`` patched to answer yes, so
  that ``checkpointed`` makes a plain call, as under a transform);
- each checkpointed stack entry (a layer, a period, an encoder or decoder
  block) runs its forward twice under plain autograd, against once under
  ``grad_and_value``: once in the forward, once in the backward's
  recompute; a jamba period's nested Mamba mixers, scan chunks and MoE
  FFNs run in its recompute too, then in their own;
- the activations saved for the backward (counted with
  ``torch.autograd.graph.saved_tensors_hooks``, parameters left out) fall
  to at most the entries' inputs plus what the model saves outside the
  stack (embedding, final norm, head, cross-entropy), below what the
  baseline keeps;
- an LM's temporal round goes through the rematerialized autograd path
  and agrees with the ``vmap(grad_and_value)`` path (the model's
  ``autograd_remat`` declaration taken away) within 1e-6; a paper model's
  round never reaches ``torch.autograd.grad`` or a checkpoint, so it stays
  bitwise what the unchanged ``vmap`` path gives; an LM client under a
  ``torch.func`` transform is refused, not sent to another path.
"""
import collections

import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro_torch.configs.base import FLConfig, get_config
from repro_torch.configs.reduce import reduced_config
from repro_torch.core import rounds
from repro_torch.core.strategies import get_strategy
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train_fl_lm
from repro_torch.models import layers, model_zoo, moe, ssm
from repro_torch.models import transformer as T
from repro_torch.models.small import SmallModel
from repro_torch.models.transformer import FlatModel


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


ARCHS = ("yi-34b", "qwen2.5-32b", "minicpm3-4b", "qwen3-moe-30b-a3b", "whisper-base",
         "xlstm-125m", "jamba-1.5-large-398b")
B, S = 2, 32
GRAD_TOL = 1e-6      # against grad_and_value: of max(1, max |want|)


def _setup(arch):
    """The reduced arch behind ``FlatModel``, its params and a batch of
    numpy tokens (and frames for the encoder-decoder)."""
    cfg = reduced_config(get_config(arch))
    model = FlatModel(model_zoo.build(cfg))
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S + 1)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rng.randn(B, S * cfg.dec_len_ratio, cfg.d_model).astype(np.float32))
    return cfg, model, params, batch


@pytest.fixture
def keep_every_activation(monkeypatch):
    """Within the test, ``checkpointed`` makes a plain call, as under a
    ``torch.func`` transform: plain autograd then keeps every activation,
    the baseline the rematerialized step is held against."""
    def keep():
        monkeypatch.setattr(layers, "func_transform_active", lambda: True)
    return keep


def _autograd(model, params, batch):
    """Plain autograd's loss and gradients."""
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = model.loss(p, batch)
    return dict(zip(p, torch.autograd.grad(loss, list(p.values())))), loss.detach()


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_match_autograd_bitwise_and_grad_and_value(
        arch, keep_every_activation):
    cfg, model, params, batch = _setup(arch)
    want, want_loss = grad_and_value(model.loss)(params, batch)
    got, loss = _autograd(model, params, batch)
    keep_every_activation()
    plain, plain_loss = _autograd(model, params, batch)
    assert torch.equal(loss, want_loss) and torch.equal(loss, plain_loss)
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        assert torch.equal(g, plain[k]), k           # the recompute changes no bit
        err = (g - want[k]).abs().max().item()
        assert err <= GRAD_TOL * max(1.0, want[k].abs().max().item()), (k, err)


def _count_calls(monkeypatch, targets):
    """Wrap ``module.name`` for each (module, name) with a call counter."""
    counts = collections.Counter()
    for mod, name in targets:
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    return counts


@pytest.mark.parametrize("arch", ARCHS)
def test_each_checkpointed_entry_runs_its_forward_twice(arch, monkeypatch):
    cfg, model, params, batch = _setup(arch)
    counts = _count_calls(monkeypatch, [
        (T, "_dense_block"), (T, "_hybrid_period"), (T, "_xlstm_period"), (T, "_enc_block"),
        (T, "_dec_block"), (ssm, "mamba_forward"), (ssm, "_mamba_chunk"), (moe, "moe_ffn")])
    grad_and_value(model.loss)(params, batch)       # keeps every activation
    once = dict(counts)
    counts.clear()
    _autograd(model, params, batch)
    entries = {"encdec": ("_enc_block", "_dec_block"), "hybrid": ("_hybrid_period",),
               "ssm": ("_xlstm_period",)}.get(cfg.family, ("_dense_block",))
    for name in entries:
        assert once[name] > 0 and counts[name] == 2 * once[name], (name, once, counts)
    if cfg.family == "hybrid":
        # each mixer, chunk and MoE FFN: the forward, the period's recompute
        # (which stops early once the period's own saved tensors are back,
        # so a trailing sublayer may be left to its own recompute) and its
        # own recompute; a chunk once more, in its mixer's recompute
        for name, most in (("mamba_forward", 3), ("moe_ffn", 3), ("_mamba_chunk", 4)):
            assert 2 * once[name] <= counts[name] <= most * once[name], (name, counts)
    elif cfg.family == "moe":
        # the MoE FFN runs inside its layer's checkpoint, not one of its own
        assert counts["moe_ffn"] == 2 * once["moe_ffn"]


def _saved_bytes(params, fn):
    """Bytes of the distinct storages saved for the backward while ``fn``
    runs, the parameters' own left out."""
    owned = {v.untyped_storage().data_ptr() for v in params.values()}
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in owned:
            seen[st.data_ptr()] = st.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(seen.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_saved_activations_fall_to_the_entry_inputs_and_the_head(
        arch, monkeypatch, keep_every_activation):
    cfg, model, params, batch = _setup(arch)
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    remat = _saved_bytes(p, lambda: model.loss(p, batch))
    keep_every_activation()
    full = _saved_bytes(p, lambda: model.loss(p, batch))
    # each entry's input: (B, S, D) f32; the encoder's at its frame length,
    # and the encoder's output, which every decoder block reads
    x_bytes = B * S * cfg.d_model * 4
    if cfg.family == "encdec":
        enc_bytes = x_bytes * cfg.dec_len_ratio
        inputs = cfg.n_enc_layers * enc_bytes + cfg.n_layers * x_bytes + enc_bytes
    else:
        inputs = T.n_stacks(cfg) * x_bytes
    # what the model saves outside the stack: the stack's entries as identities
    monkeypatch.setattr(T, "stack_train", lambda cfg, blocks, x, **kw: (x, 0.0, None))
    monkeypatch.setattr(T, "_enc_block", lambda cfg, blk, x: x)
    monkeypatch.setattr(T, "_dec_block", lambda cfg, blk, x, enc, prefill=False: (x, None))
    head = _saved_bytes(p, lambda: model.loss(p, batch))
    if cfg.family == "encdec":
        # the encoder's final norm, which an identity encoder leaves with no
        # input that needs a gradient
        x = torch.zeros(B, S * cfg.dec_len_ratio, cfg.d_model, requires_grad=True)
        norm = T.unflatten_params(p)["enc_final_norm"]
        head += _saved_bytes(p, lambda: T._apply_norm(norm, x, cfg))
    assert remat <= inputs + head < full, (remat, inputs, head, full)


def _lm_round(arch, monkeypatch=None):
    """One temporal fedavgm round of the reduced arch on fixed client data
    (cohort 2, 2 local steps) -> (state, loss)."""
    cfg = reduced_config(get_config(arch))
    fl = FLConfig(strategy="fedavgm", n_clients=4, client_lr=0.05, server_momentum=0.9)
    _, round_fn, state = train_fl_lm.setup(cfg, fl, "cpu")
    state, logger = train_fl_lm.run_rounds(round_fn, state, SyntheticLM(vocab=cfg.vocab_size),
                                           0, 1, clients=4, cohort=2, batch=2, seq=16,
                                           local_steps=2, device="cpu")
    return state, logger.series("loss")[0]


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "jamba-1.5-large-398b"])
def test_lm_round_takes_the_remat_path_and_agrees_with_the_vmap_path(arch, monkeypatch):
    cfg = reduced_config(get_config(arch))
    entry = "_hybrid_period" if cfg.family == "hybrid" else "_dense_block"
    counts = _count_calls(monkeypatch, [(T, entry)])
    state, loss = _lm_round(arch)
    steps = 2 * 2                           # cohort 2 x 2 local steps
    assert counts[entry] == 2 * T.n_stacks(cfg) * steps     # forward + recompute
    counts.clear()
    monkeypatch.setattr(FlatModel, "autograd_remat", False)
    want, want_loss = _lm_round(arch)
    assert counts[entry] == T.n_stacks(cfg) * steps
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    for part in ("params", "server"):
        got = state[part] if part == "params" else state[part]["momentum"]
        ref = want[part] if part == "params" else want[part]["momentum"]
        for k, v in ref.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-6, rtol=0,
                                       err_msg=f"{part} {k}")


def _plain_autograd_calls(monkeypatch):
    """Record each ``torch.autograd.grad`` call made outside a ``torch.func``
    transform (``grad_and_value`` calls it too, inside its own level)."""
    grad, calls = torch.autograd.grad, []

    def recorded(*a, **kw):
        if not layers.func_transform_active():
            calls.append(1)
        return grad(*a, **kw)
    monkeypatch.setattr(torch.autograd, "grad", recorded)
    return calls


def test_paper_model_rounds_never_reach_autograd_or_a_checkpoint(monkeypatch):
    fl = FLConfig(n_clients=2, local_steps=2, batch_size=2, client_lr=0.05,
                  placement="temporal", strategy="fedprox", prox_mu=0.01)
    model = SmallModel(get_config("flsim-cnn").replace(d_model=8, d_ff=16), "cnn")
    assert not getattr(model, "autograd_remat", False)
    strat = get_strategy(fl)
    state = rounds.init_state(model, strat, fl, 0, 1)
    rng = np.random.RandomState(0)
    batch = {"x": torch.from_numpy(rng.randn(2, 2, 2, 32, 32, 3).astype(np.float32)),
             "y": torch.from_numpy(rng.randint(0, 10, (2, 2, 2)))}
    w = torch.tensor([1.0, 2.0])
    want, _ = rounds.build_temporal_round(model, strat, fl)(state, batch, w, 3)
    calls = _plain_autograd_calls(monkeypatch)

    def refused(*a, **kw):
        raise AssertionError("a paper model's round reached a checkpoint")
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", refused)
    got, _ = rounds.build_temporal_round(model, strat, fl)(state, batch, w, 3)
    assert not calls
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k


def test_the_gradient_rule_follows_the_declaration_and_the_clients(monkeypatch):
    cfg, model, params, batch = _setup("yi-34b")
    assert FlatModel.autograd_remat is True
    one = {k: v[None, None] for k, v in batch.items()}            # (C=1, steps=1, ...)
    two = {k: torch.cat([v, v]) for k, v in one.items()}
    fl = FLConfig(strategy="fedavg", client_lr=0.05, local_steps=1)
    strat = get_strategy(fl)
    key = torch.zeros(1, dtype=torch.int64)
    calls = _plain_autograd_calls(monkeypatch)
    delta, _, loss = rounds.local_train(model, strat, fl, params, (), (), one, key)
    assert len(calls) == 1                      # one client of an LM: plain autograd
    # two clients, or per-client params: vmap(grad_and_value), as every model
    keys = torch.zeros(2, dtype=torch.int64)
    delta2, _, loss2 = rounds.local_train(model, strat, fl, params, (), (), two, keys)
    per_client = {k: v[None] for k, v in params.items()}
    delta3, _, _ = rounds.local_train(model, strat, fl, per_client, (), (), one, key,
                                      per_client_params=True)
    assert len(calls) == 1
    assert torch.equal(loss2, torch.cat([loss, loss]))
    for k, d in delta.items():
        for other in (delta2[k][0], delta2[k][1], delta3[k][0]):
            err = (other - d[0]).abs().max().item()
            assert err <= GRAD_TOL * max(1.0, d.abs().max().item() / fl.client_lr) \
                * fl.client_lr, (k, err)
    # no fallback: under a torch.func transform (a campaign lane's vmap, which
    # an LM job never reaches) the LM client's plain autograd is refused
    with pytest.raises(RuntimeError, match="functorch transform"):
        vmap(lambda p: rounds.local_train(model, strat, fl, p, (), (), one, key),
             randomness="same")({k: torch.stack([v, v]) for k, v in params.items()})


def _b2_b3_step(x, w, q, k, v):
    """A norm and a causal attention, as a stack entry runs them."""
    from repro_torch.kernels import ops
    h = ops.rmsnorm(x, w)
    return ops.flash_attention(q * h[..., :1, None], k, v).sum() + h.square().sum()


def test_b2_and_b3_run_their_forward_again_in_the_recompute(monkeypatch):
    """``ops._RMSNorm`` and ``ops._FlashAttention`` under
    ``torch.utils.checkpoint``: the recompute calls each kernel wrapper a
    second time at the forward's shapes, the loss is the forward's bits, and
    the gradients are bitwise those of plain autograd (whose backward reads
    the contexts of the first forward)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    rng = np.random.RandomState(5)
    x, w = (torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ((2, 16, 32), (32,)))
    q, k, v = (torch.from_numpy(rng.randn(2, 16, 4, 8).astype(np.float32)) for _ in range(3))
    counts = _count_calls(monkeypatch, [(rms, "rmsnorm"), (fa, "flash_attention_fwd")])
    out = {}
    for remat in (False, True):
        leaves = [t.clone().requires_grad_() for t in (x, w, q, k, v)]
        counts.clear()
        loss = (layers.checkpointed(_b2_b3_step, *leaves) if remat
                else _b2_b3_step(*leaves))
        fwd = dict(counts)
        grads = torch.autograd.grad(loss, leaves)
        out[remat] = (loss.detach(), grads, fwd, dict(counts))
    assert out[False][2] == out[False][3] == {"rmsnorm": 1, "flash_attention_fwd": 1}
    assert out[True][2] == {"rmsnorm": 1, "flash_attention_fwd": 1}
    assert out[True][3] == {"rmsnorm": 2, "flash_attention_fwd": 2}
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)
