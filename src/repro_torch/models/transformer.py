"""The LMs: the training loss, prefill and greedy decode (port of
``repro/models/transformer.py``) for every family of the JAX package:
dense and MoE decoders, the encoder-decoder (whisper-base), xLSTM
(xlstm-125m) and the Mamba + attention + MoE hybrid (jamba).

Params are a plain nested ``dict[str, Tensor]`` with the JAX package's
names and layouts, blocks stacked on a leading stack dim
(``blocks/attn/wq`` is ``(L, D, H*HD)``), so ``interop.params_from_numpy``
is a copy of each leaf. The JAX ``lax.scan`` over the stack is a Python
loop over that dim.

Every entry point takes ``ctx`` (``sharding/axes.AxisCtx``, default
``SINGLE``: one device, every collective the identity). The dense and MoE
decoders (GQA or MLA) also run on a rank of the temporal placement's
``(data, model[, pod])`` mesh,
as the JAX package's ``shard_map`` step does: weights ZeRO-3-sharded over
``model`` and gathered per layer (``gather_fn``, inside the layer's
checkpoint, so the backward's recompute gathers again), the batch over
``(pod, data)``, the sequence over ``model`` (``layout="sp"``; "dp2d":
the batch over ``model`` too, whole sequences, the JAX package's
``REPRO_TRAIN_LAYOUT=dp2d``), the embedding D-sharded and the head
vocab-sharded over ``model``; at decode the weights are tensor-parallel
(``tp``) and the cache sequence-sharded; the MoE experts stay resident
(``moe.moe_ffn(ctx=)``); tied embeddings (minicpm3-4b) are vocab-sharded,
all-gathered whole in training and prefill and looked up masked and summed
at decode. The embedding, the loss and the
prefill logits compute the meshless function exactly (ROADMAP C10: the JAX
package's mesh step does not): the embedding gathers the rank's token rows
over the vocab axis, looks them all up in its D slice and all-to-alls the
slices back; the loss gathers the final hidden rows over the vocab axis,
so each rank holds every row's logits over its vocab slice; prefill
broadcasts the last position's row before the head and gathers the
vocab. The MoE aux losses are each rank's, averaged over ``(pod, data,
model)`` as the JAX package averages them, their gradient scaled so that
the synced gradient is the averaged aux's (ROADMAP C11).

The other families run there too. A jamba period (hybrid) trains with the
batch over ``(data, model, pod)`` and whole sequences, its mixers meshless
and its MoE FFNs on the grid ring; its prefill shards the sequence (the
Mamba mixers through ``ssm.mamba_forward``'s cross-shard handoff) and its
decode is tensor-parallel (the Mamba channels over ``model``). xlstm-125m
runs whole sequences on every rank (its recurrences take no ctx).
whisper-base (``EncDecModel``) shards the encoder's and the decoder's
sequences over ``model``: the encoder's K/V gathered along the sequence,
the cross-attention from the rank's decoder rows over the gathered encoder
output, and at decode B4 over the rank's shard of the encoder cache, the
shards' ``(o, m, l)`` combined over ``model``.

Rematerialization: the training forward is ``layers.checkpointed`` where
the JAX package's is ``jax.checkpoint``ed: each stack entry of
``stack_train`` at phase 'train' (a layer, or a period), each encoder
block, each decoder block when not prefilling, and, nested inside a jamba
period, each Mamba mixer and MoE FFN (and, in ``ssm.mamba_forward``, each
scan chunk). Under plain autograd (``core/rounds.local_train`` takes it
for an LM client) the backward then keeps the entries' inputs and the
head's activations, not every layer's. ``torch.utils.checkpoint`` does not
run under ``torch.func``'s transforms, so under them, and without grad, the
stack keeps every activation. The training and prefill loops take their
entries with one ``torch.unbind`` of each stacked leaf (``_unstack``), so a
stacked leaf's gradient is one stack of its entries' gradients instead of a
sum of one zero-padded full-size gradient per entry. ``FlatModel`` is the
LM as the FL core sees it: one flat param dict with ``/``-joined keys.

A dense block's attention is GQA or MLA (``cfg.attn_type``), its FFN the
SwiGLU MLP or, for the MoE family, ``moe.moe_ffn`` (plus a dense residual
MLP after ``ln3`` where ``dense_residual_d_ff`` is set, as in arctic-480b),
whose aux losses add to the training loss. Tied embeddings (minicpm3-4b)
use ``embed.T`` as the head and have no ``lm_head`` leaf. The hybrid and
ssm families stack periods, not layers (``n_stacks``): a jamba period is
one attention and ``period - 1`` Mamba mixers, each followed by an MoE or a
SwiGLU FFN; an xLSTM period ``slstm_every - 1`` mLSTM blocks and one
sLSTM. Their caches are per-period trees stacked as the JAX scan's ``ys``.
The encoder-decoder (``EncDecModel``) uses LayerNorm with a bias and a
two-matrix GELU MLP with biases, a full-attention encoder over frame
embeddings (its conv frontend is a stub in the JAX package too) and a
decoder with cross-attention over the encoder's output.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import checkpointed, dense_init, embed_init, layer_norm, \
    rms_norm
from repro_torch.sharding.axes import SINGLE, AxisCtx


def mlp_param_shapes(cfg: ModelConfig, d_ff: int = 0) -> dict:
    """The FFN of width ``d_ff`` (default ``cfg.d_ff``): SwiGLU with gate
    ``w1``, up ``w3``, down ``w2``; whisper's two matrices with biases for
    the encdec family."""
    D, F_ = cfg.d_model, d_ff or cfg.d_ff
    if cfg.family == "encdec":
        return {"w1": (D, F_), "b1": (F_,), "w2": (F_, D), "b2": (D,)}
    return {"w1": (D, F_), "w3": (D, F_), "w2": (F_, D)}


def mlp_forward(w: dict, x, cfg: ModelConfig, *, ctx: AxisCtx = SINGLE, tp: bool = False):
    """silu(x @ w1) * (x @ w3) @ w2, or gelu(x @ w1 + b1) @ w2 + b2 with
    ``jax.nn.gelu``'s default, the tanh form (``F.gelu``'s default is the
    exact erf); with ``tp`` on a model axis w1/w3 column- and w2
    row-parallel (``attention.col_matmul``, ``row_matmul``)."""
    if "w3" in w:
        g = attn.col_matmul(ctx, x, w["w1"], None, tp)
        u = attn.col_matmul(ctx, x, w["w3"], None, tp)
        return attn.row_matmul(ctx, F.silu(g) * u, w["w2"], tp)
    h = F.gelu(attn.col_matmul(ctx, x, w["w1"], w["b1"], tp), approximate="tanh")
    return attn.row_matmul(ctx, h, w["w2"], tp) + w["b2"]


def embed_lookup(embed, tokens, *, ctx: AxisCtx = SINGLE, tied: bool = False,
                 tokens_replicated: bool = False):
    """Rows of the embedding for ``tokens``, through ``F.embedding``, whose
    gradient sums each row's tokens in one order on every run and on the
    CPU too, where indexing's (an accumulating ``index_put_``) is
    documented as nondeterministic.

    Off the vocab axis (``ctx.vaxis`` None) ``embed`` is the whole matrix.
    On it:
    - untied, ``embed`` (V, D_loc) D-sharded: with ``tokens_replicated``
      (decode) the rank looks them up in its slice and the slices are
      all-gathered; otherwise the ranks' token rows are all-gathered, each
      rank looks every row up in its slice and an all-to-all gives each
      rank its own rows at full width. Exact for any sharding of the rows
      (the JAX package looks each rank's own rows up and gathers the
      feature dim, which mixes ranks' rows: ROADMAP C10);
    - tied, ``embed`` (V_loc, D) vocab-sharded: with ``tokens_replicated``
      a masked local lookup summed over the axis (the JAX package's);
      otherwise the caller passes the gathered whole matrix."""
    va = ctx.vaxis
    if va is None or (tied and not tokens_replicated):
        return F.embedding(tokens, embed)
    if tied:
        V = embed.shape[0]
        ids = tokens - ctx.index(va) * V
        ok = (ids >= 0) & (ids < V)
        x = F.embedding(torch.clamp(ids, 0, V - 1), embed) * ok[..., None].to(embed.dtype)
        return ctx.psum(x.to(torch.float32), va).to(embed.dtype)
    if tokens_replicated:
        x = F.embedding(tokens, embed)
        return ctx.all_gather(x, va, axis=x.dim() - 1)
    every = ctx.all_gather(tokens.reshape(-1), va, axis=0)
    x = ctx.all_to_all(F.embedding(every, embed), va, split_axis=0, concat_axis=1)
    return x.reshape(*tokens.shape, -1)


class _ScaleGrad(torch.autograd.Function):
    """The identity, its gradient scaled by ``s``."""

    @staticmethod
    def forward(x, s):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.s = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def softmax_xent_vshard(logits, labels, *, ctx: AxisCtx = SINGLE):
    """Stable cross-entropy, the mean over the tokens. logits: (..., V_loc)
    f32, this rank's vocab slice of every row's logits (the whole vocab off
    the vocab axis); labels: (...) global ids. The shard max (a stabilizer,
    held out of the gradient: the loss's does not depend on it), the sums
    of ``exp`` and of the target logit over the vocab axis, the mean over
    the rows, averaged over ``(pod, data)``. (The JAX package's ``valid``
    mask, which ``Model.loss`` never passes, is left out.)

    On the vocab axis the rows' losses are the same on every rank of it,
    and each rank's cotangent reaches every rank's logits through the
    sums' backward (a ``psum``): the rows' loss gradient is scaled by
    1 / the axis size here, so every gradient is the meshless one."""
    va = ctx.vaxis
    m = ctx.pmax(logits.amax(dim=-1), va)
    lse = m + torch.log(ctx.psum(torch.exp(logits - m[..., None]).sum(dim=-1), va))
    if va is None:
        tgt = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    else:
        V = logits.shape[-1]
        ids = labels.long() - ctx.index(va) * V
        ok = (ids >= 0) & (ids < V)
        tgt = torch.gather(logits, -1, torch.clamp(ids, 0, V - 1)[..., None])[..., 0]
        tgt = ctx.psum(tgt * ok, va)
    nll = lse - tgt
    if va is not None:
        nll = _ScaleGrad.apply(nll, 1.0 / ctx.size(va))
    return ctx.pmean(nll.mean(), ctx.data_axes)


def _norm_shapes(cfg: ModelConfig) -> dict:
    """A norm's leaves: LayerNorm's weight and bias for encdec, else the
    RMSNorm weight."""
    if cfg.family == "encdec":
        return {"w": (cfg.d_model,), "b": (cfg.d_model,)}
    return {"w": (cfg.d_model,)}


def _apply_norm(w: dict, x, cfg: ModelConfig):
    """LayerNorm (eps 1e-5) where the norm has a bias, else B2."""
    if "b" in w:
        return layer_norm(x, w["w"], w["b"], eps=1e-5)
    return rms_norm(x, w["w"], cfg.norm_eps)


def dense_block_shapes(cfg: ModelConfig) -> dict:
    """One block: two norms, GQA or MLA attention, and the MLP or, for
    the MoE family, the router and experts (with a dense residual MLP and
    its norm ``ln3`` where the config has one)."""
    s = {"ln1": _norm_shapes(cfg), "ln2": _norm_shapes(cfg),
         "attn": attn.attn_param_shapes(cfg)}
    if cfg.moe is not None and cfg.family == "moe":
        s["moe"] = moe_mod.moe_param_shapes(cfg)
        if cfg.moe.dense_residual_d_ff:
            s["dense_mlp"] = mlp_param_shapes(cfg, cfg.moe.dense_residual_d_ff)
            s["ln3"] = _norm_shapes(cfg)
    else:
        s["mlp"] = mlp_param_shapes(cfg)
    return s


def _map_shapes(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_shapes(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stacked(n: int, tree: dict) -> dict:
    return _map_shapes(lambda sh: (n,) + sh, tree)


def hybrid_period_shapes(cfg: ModelConfig) -> dict:
    """A jamba period: one attention and ``period - 1`` Mamba mixers, an MoE
    FFN every ``moe_every`` sublayers and the SwiGLU MLP at the others, and
    a norm before each mixer and each FFN (4 MoE + 4 MLP FFNs and 16 norms
    at jamba's period of 8)."""
    P = cfg.hybrid.period
    n_moe = P // cfg.moe.moe_every
    return {
        "attn": attn.attn_param_shapes(cfg),
        "mamba": _stacked(P - 1, ssm_mod.mamba_param_shapes(cfg)),
        "moe": _stacked(n_moe, moe_mod.moe_param_shapes(cfg)),
        "mlp": _stacked(P - n_moe, mlp_param_shapes(cfg)),
        "ln_mix": {"w": (P, cfg.d_model)},
        "ln_ffn": {"w": (P, cfg.d_model)},
    }


def xlstm_period_shapes(cfg: ModelConfig) -> dict:
    """An xLSTM period: ``slstm_every - 1`` mLSTM blocks, one sLSTM, and a
    norm before each."""
    n_m = cfg.ssm.slstm_every - 1
    return {
        "mlstm": _stacked(n_m, ssm_mod.mlstm_param_shapes(cfg)),
        "slstm": ssm_mod.slstm_param_shapes(cfg),
        "ln": {"w": (cfg.ssm.slstm_every, cfg.d_model)},
    }


def encdec_block_shapes(cfg: ModelConfig, cross: bool) -> dict:
    """A whisper block: self-attention and the MLP, each after a LayerNorm;
    a decoder block (``cross``) adds cross-attention after ``ln_x``."""
    s = {"ln1": _norm_shapes(cfg), "attn": attn.attn_param_shapes(cfg),
         "ln2": _norm_shapes(cfg), "mlp": mlp_param_shapes(cfg)}
    if cross:
        s["ln_x"] = _norm_shapes(cfg)
        s["xattn"] = attn.attn_param_shapes(cfg)
    return s


def block_shapes(cfg: ModelConfig) -> dict:
    """One entry of the stack: a period for hybrid and ssm, else a block."""
    if cfg.family == "hybrid":
        return hybrid_period_shapes(cfg)
    if cfg.family == "ssm":
        return xlstm_period_shapes(cfg)
    return dense_block_shapes(cfg)


def n_stacks(cfg: ModelConfig) -> int:
    """Entries of the stack: periods for hybrid and ssm, else layers."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid.period
    if cfg.family == "ssm":
        return cfg.n_layers // cfg.ssm.slstm_every
    return cfg.n_layers


def param_shapes(cfg: ModelConfig) -> dict:
    """Full logical shapes, as the JAX package's ``param_shapes`` gives
    them: a nested dict of tuples, the stack's entries on a leading dim; no
    ``lm_head`` when the embeddings are tied; for encdec the encoder's
    blocks and final norm beside the decoder's."""
    Vp, D = cfg.padded_vocab, cfg.d_model
    p = {"embed": (Vp, D), "final_norm": _norm_shapes(cfg),
         "blocks": _stacked(n_stacks(cfg), block_shapes(cfg))}
    if not cfg.tie_embeddings:
        p["lm_head"] = (D, Vp)
    if cfg.family == "encdec":
        p["enc_blocks"] = _stacked(cfg.n_enc_layers, encdec_block_shapes(cfg, cross=False))
        p["blocks"] = _stacked(cfg.n_layers, encdec_block_shapes(cfg, cross=True))
        p["enc_final_norm"] = _norm_shapes(cfg)
    return p


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


_ZERO_INIT = ("b", "b1", "b2", "bq", "bk", "bv", "conv_b", "dt_bias")


def init_tree(generator: torch.Generator, shapes: dict, dtype=torch.float32) -> dict:
    """Random leaves for a nested dict of shapes, on the generator's
    device, with the JAX package's initializers by leaf name: norm weights
    1 and their biases 0, the other biases 0, Mamba's ``A_log`` = log(1..N)
    on every channel and ``D_skip`` 1, embed N(0, 0.02), matrices (the
    router and expert weights too) N(0, 1/fan_in), fan-in ``shape[-2]``.
    (``torch.Generator`` and ``jax.random`` draw different numbers; tests
    carry JAX's params across with ``interop`` instead.)"""
    out: dict = {}
    dev = generator.device
    for path, shape in _leaves(shapes):
        name = path[-1]
        owner = path[-2] if len(path) > 1 else ""
        if (name == "w" and (owner.startswith("ln") or owner.endswith("norm"))) \
                or name.endswith("norm") or name == "D_skip":
            leaf = torch.ones(shape, dtype=dtype, device=dev)
        elif name in _ZERO_INIT:
            leaf = torch.zeros(shape, dtype=dtype, device=dev)
        elif name == "A_log":
            n = torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=dev)
            leaf = torch.log(n).expand(shape).to(dtype).contiguous()
        elif name == "embed":
            leaf = embed_init(generator, shape, dtype)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[0]
            leaf = dense_init(generator, shape, in_dim=fan_in, dtype=dtype)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[name] = leaf
    return out


def init_params(generator: torch.Generator, cfg: ModelConfig,
                dtype=torch.float32) -> dict:
    """The model's random params (``init_tree`` of ``param_shapes``)."""
    return init_tree(generator, param_shapes(cfg), dtype)


def _attn(cfg: ModelConfig, w: dict, h, *, phase: str, cache=None, length=None,
          ctx: AxisCtx = SINGLE, tp: bool = False):
    """The attention sublayer -> (out, cache): phase 'train' gives no cache,
    'prefill' the KVCache or LatentCache of the rows, 'decode' the cache
    written in place."""
    mla = cfg.attn_type == "mla"
    if phase == "decode":
        decode = attn.mla_decode if mla else attn.gqa_decode
        return decode(w, h, cache, length, cfg, ctx=ctx, tp=tp)
    fwd = attn.mla_seqsharded if mla else attn.gqa_seqsharded
    if phase == "prefill":
        return fwd(w, h, cfg, return_cache=True, ctx=ctx)
    return fwd(w, h, cfg, ctx=ctx), None


def _dense_block(cfg: ModelConfig, w: dict, x, *, phase: str, caches=None,
                 length=None, ctx: AxisCtx = SINGLE, tp: bool = False):
    """One block -> (x, cache, aux): aux is the MoE layer's load-balance +
    z loss, else 0.0. ``ctx``: the mixer's (``mixer_ctx``); ``tp``: the
    decode's tensor-parallel projections."""
    h = _apply_norm(w["ln1"], x, cfg)
    o, new_cache = _attn(cfg, w["attn"], h, phase=phase, cache=caches, length=length,
                         ctx=ctx, tp=tp)
    x = x + o
    h = _apply_norm(w["ln2"], x, cfg)
    if "moe" not in w:
        return x + mlp_forward(w["mlp"], h, cfg, ctx=ctx, tp=tp), new_cache, 0.0
    mo, maux = moe_mod.moe_ffn(w["moe"], h, cfg, ctx=ctx,
                               tokens_replicated=phase == "decode")
    if "dense_mlp" in w:
        mo = mo + mlp_forward(w["dense_mlp"], _apply_norm(w["ln3"], x, cfg), cfg,
                              ctx=ctx, tp=tp)
    return x + mo, new_cache, maux.load_balance + maux.z_loss


def _take(tree, i):
    return {k: _take(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _unstack(tree) -> list:
    """The entries of a stacked param tree, each leaf unbound once
    (``torch.unbind``): the gradient of a stacked leaf is then one stack of
    its entries' gradients, where indexing entry by entry (``_take``) would
    sum one zero-padded full-size gradient per entry."""
    parts = {k: torch.unbind(v) for k, v in flatten_params(tree).items()}
    n = len(next(iter(parts.values())))
    return [unflatten_params({k: p[i] for k, p in parts.items()}) for i in range(n)]


def _call(fn, *args):
    return fn(*args)


def _hybrid_period(cfg: ModelConfig, w: dict, x, *, phase: str, caches=None,
                   length=None, ctx: AxisCtx = SINGLE, tp: bool = False,
                   mix: AxisCtx | None = None, quant_ring: bool = False):
    """One jamba period -> (x, {"attn": cache, "mamba": [MambaState, ...]},
    aux). Sublayer i mixes with the attention at ``attn_index`` and with the
    next Mamba mixer elsewhere; its FFN is MoE ``i // moe_every`` where ``i %
    moe_every == moe_offset``, else MLP ``i // 2`` (the JAX package's
    indices, as written). At phase 'train' each Mamba mixer and each MoE FFN
    is ``checkpointed`` on its own, nested in the period's, as the JAX
    package nests them: without them the period's recompute would hold all
    its mixers' and MoE layers' activations at once.

    On a mesh, as the JAX period: the attention runs with the mixers' ctx
    ``mix`` (``mixer_ctx``; ``ctx`` when None) and ``tp``; each Mamba mixer
    with ``mix`` in training and prefill and with ``ctx, tp`` at decode;
    each MoE FFN with the full ``ctx`` (its tokens replicated at decode;
    ``quant_ring``: int8 ring payloads); each MLP with ``ctx, tp``."""
    P, eps = cfg.hybrid.period, cfg.norm_eps
    mix = ctx if mix is None else mix
    decode = phase == "decode"
    ckpt = checkpointed if phase == "train" else _call
    new = {"attn": None, "mamba": []}
    aux, mi = 0.0, 0
    for i in range(P):
        h = rms_norm(x, w["ln_mix"]["w"][i], eps)
        if i == cfg.hybrid.attn_index:
            o, new["attn"] = _attn(cfg, w["attn"], h, phase=phase,
                                   cache=None if caches is None else caches["attn"],
                                   length=length, ctx=mix, tp=tp)
        else:
            st = None if caches is None else caches["mamba"][mi]
            mixer = functools.partial(ssm_mod.mamba_forward, cfg=cfg, state=st,
                                      ctx=ctx if decode else mix, tp=tp and decode)
            o, st = ckpt(mixer, _take(w["mamba"], mi), h)
            new["mamba"].append(st)
            mi += 1
        x = x + o
        h = rms_norm(x, w["ln_ffn"]["w"][i], eps)
        if i % cfg.moe.moe_every == cfg.moe.moe_offset:
            wmoe = _take(w["moe"], i // cfg.moe.moe_every)
            ffn = functools.partial(moe_mod.moe_ffn, cfg=cfg, ctx=ctx,
                                    tokens_replicated=decode, quant_ring=quant_ring)
            mo, maux = ckpt(ffn, wmoe, h)
            aux = aux + maux.load_balance + maux.z_loss
            x = x + mo
        else:
            x = x + mlp_forward(_take(w["mlp"], i // 2), h, cfg, ctx=ctx, tp=tp)
    return x, new, aux


def _xlstm_period(cfg: ModelConfig, w: dict, x, *, phase: str, caches=None,
                  length=None, ctx: AxisCtx = SINGLE, tp: bool = False):
    """One xLSTM period (residual mLSTM blocks, then the sLSTM) -> (x,
    {"mlstm": [MLSTMState, ...], "slstm": SLSTMState}, 0.0). Its mixers
    take no ctx (the JAX package's): on a mesh every rank runs whole
    sequences, and the states are replicated over ``model``."""
    n_m, eps = cfg.ssm.slstm_every - 1, cfg.norm_eps
    new = {"mlstm": [], "slstm": None}
    for i in range(n_m):
        h = rms_norm(x, w["ln"]["w"][i], eps)
        st = None if caches is None else caches["mlstm"][i]
        o, st = ssm_mod.mlstm_forward(_take(w["mlstm"], i), h, cfg, state=st)
        new["mlstm"].append(st)
        x = x + o
    h = rms_norm(x, w["ln"]["w"][n_m], eps)
    o, new["slstm"] = ssm_mod.slstm_forward(
        w["slstm"], h, cfg, state=None if caches is None else caches["slstm"])
    return x + o, new, 0.0


LAYOUTS = ("sp", "dp2d")


def seq_sharded_in(cfg: ModelConfig, phase: str, layout: str = "sp") -> bool:
    """Whether the sequence dim is sharded over ``model`` in this phase:
    never for ssm (the recurrences cross shard boundaries), not in hybrid
    training (the JAX package's rule), not in training with ``layout`` "dp2d"
    (the batch over data x model, whole sequences: no per-layer K/V gather;
    the JAX package's ``REPRO_TRAIN_LAYOUT=dp2d``), else always."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: want one of {LAYOUTS}")
    if cfg.family == "ssm":
        return False
    if phase == "train" and (cfg.family == "hybrid" or layout == "dp2d"):
        return False
    return True


def mixer_ctx(ctx: AxisCtx, cfg: ModelConfig, phase: str, layout: str = "sp") -> AxisCtx:
    """The token mixers' ctx: without the model axis where the sequences
    are whole (the vocab axis and the data and pod axes kept)."""
    if seq_sharded_in(cfg, phase, layout) or ctx.model is None:
        return ctx
    return dataclasses.replace(ctx, model=None, vocab=ctx.vaxis)


def _block_fn(cfg: ModelConfig):
    if cfg.family == "hybrid":
        return _hybrid_period
    if cfg.family == "ssm":
        return _xlstm_period
    return _dense_block


def _block_ctx(cfg: ModelConfig, ctx: AxisCtx, phase: str, layout: str,
               quant_ring: bool) -> dict:
    """An entry's ctx keywords: a jamba period takes the mesh's ctx, its
    mixers' (``mix``) and ``quant_ring``; a dense block and an xLSTM period
    the mixers' ctx."""
    mix = mixer_ctx(ctx, cfg, phase, layout)
    if cfg.family == "hybrid":
        return {"ctx": ctx, "mix": mix, "quant_ring": quant_ring}
    return {"ctx": mix}


def _stack_trees(trees: list):
    """Per-entry caches (dicts, lists and NamedTuples of tensors) -> one
    tree of their leaves stacked on a new leading dim."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack_trees(list(f)) for f in zip(*trees)))
    if isinstance(first, list):
        return [_stack_trees(list(f)) for f in zip(*trees)]
    return torch.stack(trees)


def _index(tree, i):
    """Entry i of a stacked cache tree: views into its leaves."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_index(v, i) for v in tree))
    if isinstance(tree, list):
        return [_index(v, i) for v in tree]
    return tree[i]


def _write_back(tree, i, new) -> None:
    """Entry i of a stacked cache tree set to ``new`` in place. KV and
    latent caches were written in place through their views already;
    recurrent states are new tensors and are copied in."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _write_back(v, i, new[k])
    elif isinstance(tree, (tuple, list)):
        for v, n in zip(tree, new):
            _write_back(v, i, n)
    elif not _same_place(tree[i], new):
        tree[i].copy_(new)


def _same_place(a, b) -> bool:
    """Whether two tensors start at one byte of one storage (a meta
    tensor's data pointer is its offset, so pointers cannot tell)."""
    return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
            and a.storage_offset() * a.element_size() == b.storage_offset() * b.element_size())


def stack_train(cfg: ModelConfig, blocks: dict, x, *, phase: str = "train",
                ctx: AxisCtx = SINGLE, gather_fn=None, layout: str = "sp",
                quant_ring: bool = False):
    """Forward through the stacked entries (layers, or periods for hybrid
    and ssm). Returns (x, aux, caches): aux sums the MoE layers' aux losses
    (0.0 without MoE); caches are None for phase 'train' and for 'prefill'
    the entries' caches stacked, as the JAX scan's ``ys``: a KVCache (L, B,
    S, KV, HD) or LatentCache (L, B, S, *), for hybrid ``{"attn": KVCache,
    "mamba": [MambaState] * (period - 1)}``, for ssm ``{"mlstm":
    [MLSTMState] * (slstm_every - 1), "slstm": SLSTMState}``, each leaf (L,
    ...). At phase 'train' each entry is ``checkpointed`` (see the module
    docstring), its ZeRO-3 gather (``gather_fn``, on a mesh) inside, so the
    recompute gathers the entry's weights again, as ``jax.checkpoint``
    does around the JAX scan's body."""
    if phase not in ("train", "prefill"):
        raise ValueError(f"stack_train runs phase 'train' or 'prefill', not {phase!r}")
    block = functools.partial(_block_fn(cfg), cfg, phase=phase,
                              **_block_ctx(cfg, ctx, phase, layout, quant_ring))

    def entry(w, x):
        return block(w if gather_fn is None else gather_fn(w), x)
    ckpt = checkpointed if phase == "train" else _call
    aux, caches = 0.0, []
    for w in _unstack(blocks):
        x, cache, a = ckpt(entry, w, x)
        aux = aux + a
        if phase == "prefill":
            caches.append(cache)
    return x, aux, (_stack_trees(caches) if caches else None)


def stack_decode(cfg: ModelConfig, blocks: dict, x, caches, length, *,
                 ctx: AxisCtx = SINGLE, gather_fn=None, tp: bool = False):
    """One decode token through the stacked entries; each writes its slot
    of ``caches`` (the tree ``stack_train`` gives; on a mesh this rank's
    sequence shard of it) in place. Returns (x, caches)."""
    fn = functools.partial(_block_fn(cfg), cfg, phase="decode", length=length, tp=tp,
                           **_block_ctx(cfg, ctx, "decode", "sp", False))
    for i in range(n_stacks(cfg)):
        blk = _take(blocks, i)
        if gather_fn is not None:
            blk = gather_fn(blk)
        x, new, _ = fn(blk, x, caches=_index(caches, i))
        _write_back(caches, i, new)
    return x, caches


@dataclasses.dataclass(frozen=True)
class Model:
    """An LM over a param dict: the training loss, prefill and greedy
    decode, on one device or a rank of a mesh (``ctx``).
    ``layout``: the training layout on a mesh (``seq_sharded_in``);
    ``quant_ring``: int8 payloads on a jamba period's grid ring (the JAX
    package's ``REPRO_QUANT_RING=1``)."""
    cfg: ModelConfig
    layout: str = "sp"
    quant_ring: bool = False

    def init(self, generator: torch.Generator, dtype=torch.float32) -> dict:
        return init_params(generator, self.cfg, dtype)

    def _embed(self, params: dict, tokens, ctx: AxisCtx, replicated: bool = False):
        emb = params["embed"]
        if self.cfg.tie_embeddings and not replicated and ctx.vaxis is not None:
            emb = ctx.all_gather(emb, ctx.vaxis, axis=0)       # the whole matrix
        return embed_lookup(emb, tokens, ctx=ctx, tied=self.cfg.tie_embeddings,
                            tokens_replicated=replicated)

    def _head(self, params: dict, x):
        """x @ the head (``embed.T`` when tied; this rank's vocab slice on
        the vocab axis) -> f32 logits."""
        head = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        return (x @ head.to(x.dtype)).to(torch.float32)

    def _logits(self, params: dict, x, last: bool = False):
        """The final norm over every row, then the head over every row or
        only the last position -> f32 logits."""
        x = _apply_norm(params["final_norm"], x, self.cfg)
        return self._head(params, x[:, -1:] if last else x)

    def loss(self, params: dict, batch: dict, *, ctx: AxisCtx = SINGLE, gather_fn=None):
        """batch["tokens"], batch["labels"]: (B, S) ids (this rank's rows
        on a mesh) -> the scalar ``loss + aux`` (the JAX package's first
        output; aux sums the MoE layers' aux losses, 0 without MoE):
        next-token cross-entropy over f32 logits; the stack rematerialized
        under plain autograd (see the module docstring). On a mesh: the
        mean over every row of the ``(pod, data)`` batch, the same on every
        rank."""
        x = self._embed(params, batch["tokens"], ctx)
        x, aux, _ = stack_train(self.cfg, params["blocks"], x, phase="train", ctx=ctx,
                                gather_fn=gather_fn, layout=self.layout,
                                quant_ring=self.quant_ring)
        x = _apply_norm(params["final_norm"], x, self.cfg)
        labels = batch["labels"]
        if ctx.vaxis is not None:
            # every row of the batch shard on each rank of the vocab axis
            x = ctx.all_gather(x.reshape(-1, x.shape[-1]), ctx.vaxis, axis=0)
            labels = ctx.all_gather(labels.reshape(-1), ctx.vaxis, axis=0)
        loss = softmax_xent_vshard(self._head(params, x), labels, ctx=ctx)
        if isinstance(aux, torch.Tensor) and ctx.grid_axes:
            # each rank's aux, averaged over the grid (the JAX package's);
            # pmean's backward gives every rank's aux the cotangent 1, and
            # the sync sums a leaf's gradient over model: 1 / M here makes
            # it the averaged aux's gradient (ROADMAP C11)
            if ctx.model is not None:
                aux = _ScaleGrad.apply(aux, 1.0 / ctx.size(ctx.model))
            aux = ctx.pmean(aux, ctx.grid_axes)
        return loss + aux

    def prefill(self, params: dict, batch: dict, *, ctx: AxisCtx = SINGLE, gather_fn=None):
        """batch["tokens"]: (B, S) -> (caches, last-position logits (B, Vp)
        f32, None). On a mesh the caches are this rank's shard (its sequence
        shard of the KV rows; a jamba Mamba state's ``h`` the global final
        state and ``conv`` the rank's last rows, which
        ``launch/steps.make_prefill_step`` puts in the decode's layout) and
        the logits the whole vocab's on every rank: the last position's row
        (on the last rank of ``model``, where the sequence is sharded)
        summed over ``model`` before the head, the vocab slices gathered
        after it (the JAX package sums each rank's vocab slice of the logits
        and keeps one slice: ROADMAP C10)."""
        x = self._embed(params, batch["tokens"], ctx)
        x, _, caches = stack_train(self.cfg, params["blocks"], x, phase="prefill", ctx=ctx,
                                   gather_fn=gather_fn, quant_ring=self.quant_ring)
        last = self._last_row(_apply_norm(params["final_norm"], x, self.cfg), ctx)
        logits = self._head(params, last)
        if ctx.vaxis is not None:
            logits = ctx.all_gather(logits, ctx.vaxis, axis=logits.dim() - 1)
        return caches, logits[:, 0], None

    def _last_row(self, x, ctx: AxisCtx):
        """x[:, -1:], on a mesh whose sequence is sharded the last rank of
        ``model``'s, summed over ``model`` to every rank."""
        last = x[:, -1:]
        if ctx.model is not None and seq_sharded_in(self.cfg, "prefill"):
            is_last = float(ctx.index(ctx.model) == ctx.size(ctx.model) - 1)
            last = ctx.psum(last * is_last, ctx.model)
        return last

    def decode_step(self, params: dict, tokens, caches, length, *, ctx: AxisCtx = SINGLE,
                    gather_fn=None, tp: bool = True):
        """tokens: (B,) previous token ids; length: (B,) int32 context
        length. Returns (logits (B, Vp) f32, caches written in place). On a
        mesh: tensor-parallel weights (``tp``), this rank's shard of the
        caches, and this rank's vocab slice of the logits (B, V_loc)."""
        x = self._embed(params, tokens[:, None], ctx, replicated=True)
        x, caches = stack_decode(self.cfg, params["blocks"], x, caches, length, ctx=ctx,
                                 gather_fn=gather_fn, tp=tp)
        return self._logits(params, x)[:, 0], caches

    def greedy_token(self, logits, *, ctx: AxisCtx = SINGLE):
        """(B, V_loc) -> (B,) the first index of each row's maximum, as
        ``jnp.argmax`` takes it (``torch.argmax`` documents the same rule);
        over the vocab axis, each slice's first maximum and its value
        gathered, the first slice holding the largest taken."""
        idx = torch.argmax(logits, dim=-1)
        if ctx.vaxis is None:
            return idx
        val = torch.gather(logits, -1, idx[:, None])[:, 0]
        glob = (idx + ctx.index(ctx.vaxis) * logits.shape[-1]).to(val.dtype)
        every = ctx.all_gather(torch.stack([val, glob], dim=-1)[None], ctx.vaxis, axis=0)
        best = torch.argmax(every[..., 0], dim=0)
        return torch.gather(every[..., 1], 0, best[None])[0].long()


# ---------------------------------------------------------------------------
# Encoder-decoder (whisper)
# ---------------------------------------------------------------------------

def _sinusoid(positions, D: int):
    """Sinusoidal position embeddings (S, D): f64 numpy frequencies, cast
    to f32 (as the JAX package's product takes them), f32 angles."""
    half = D // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / half)
    ang = positions[:, None].to(torch.float32) * torch.tensor(
        freqs, dtype=torch.float32, device=positions.device)[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_kv(cfg: ModelConfig, w: dict, enc_out):
    """K and V of the encoder's output for cross-attention: (B, S_enc, KV,
    HD) each, with the biases where the config has them."""
    B = enc_out.shape[0]
    KV, HD = cfg.n_kv_heads, cfg.resolved_head_dim
    k, v = enc_out @ w["wk"], enc_out @ w["wv"]
    if "bk" in w:
        k, v = k + w["bk"], v + w["bv"]
    return k.reshape(B, -1, KV, HD), v.reshape(B, -1, KV, HD)


def _cross_q(cfg: ModelConfig, w: dict, x_dec):
    q = x_dec @ w["wq"]
    if "bq" in w:
        q = q + w["bq"]
    return q.reshape(x_dec.shape[0], x_dec.shape[1], cfg.n_heads, cfg.resolved_head_dim)


def _cross_attn(cfg: ModelConfig, w: dict, x_dec, enc_k, enc_v):
    """Cross-attention: queries from the decoder's rows over the encoder's
    K/V, B3 non-causal (Sq = S_dec over Sk = S_enc), no rope. On a mesh the
    rank's decoder rows over the whole (gathered) encoder."""
    B, S = x_dec.shape[0], x_dec.shape[1]
    o = ops.flash_attention(_cross_q(cfg, w, x_dec), enc_k, enc_v, 0, False)
    return o.reshape(B, S, -1) @ w["wo"]


def _mesh_kw(ctx: AxisCtx) -> dict:
    """``{"ctx": ctx}`` on a model axis, else nothing: the encdec blocks
    are called as before off the mesh."""
    return {} if ctx.model is None else {"ctx": ctx}


def _enc_block(cfg: ModelConfig, blk: dict, x, ctx: AxisCtx = SINGLE):
    """One encoder block: full self-attention and the MLP, pre-norm; on a
    mesh over the rank's rows, K/V gathered along the sequence."""
    x = x + attn.gqa_seqsharded(blk["attn"], _apply_norm(blk["ln1"], x, cfg), cfg,
                                ctx=ctx, causal=False)
    return x + mlp_forward(blk["mlp"], _apply_norm(blk["ln2"], x, cfg), cfg)


def encoder_forward(cfg: ModelConfig, enc_blocks: dict, frames, *, ctx: AxisCtx = SINGLE):
    """frames: (B, S_enc, D) frame embeddings (the conv frontend's stub; on
    a mesh the rank's ``S_enc / M`` rows) -> the encoder's output before
    its final norm: sinusoidal positions (from ``index(model) * S_loc``),
    then pre-norm blocks of full (non-causal) self-attention and the MLP,
    each block ``checkpointed`` (as the JAX package's, at every phase)."""
    S_loc = frames.shape[1]
    pos = ctx.index(ctx.model) * S_loc + torch.arange(S_loc, device=frames.device)
    x = frames + _sinusoid(pos, cfg.d_model)[None].to(frames.dtype)
    block = functools.partial(_enc_block, **_mesh_kw(ctx))
    for blk in _unstack(enc_blocks):
        x = checkpointed(block, cfg, blk, x)
    return x


def _dec_block(cfg: ModelConfig, blk: dict, x, enc, prefill: bool = False,
               ctx: AxisCtx = SINGLE):
    """One decoder block -> (x, its EncDecCaches at prefill, else None):
    causal self-attention, cross-attention over ``enc`` (its K/V computed
    here), the MLP. On a mesh ``x`` is the rank's decoder rows and ``enc``
    the whole (gathered) encoder output; the prefill caches the rank's own
    slice of the cross K/V (the JAX package's layout)."""
    h = _apply_norm(blk["ln1"], x, cfg)
    if prefill:
        o, cache = attn.gqa_seqsharded(blk["attn"], h, cfg, ctx=ctx, return_cache=True)
    else:
        o = attn.gqa_seqsharded(blk["attn"], h, cfg, ctx=ctx)
    x = x + o
    ek, ev = _enc_kv(cfg, blk["xattn"], enc)
    x = x + _cross_attn(cfg, blk["xattn"], _apply_norm(blk["ln_x"], x, cfg), ek, ev)
    x = x + mlp_forward(blk["mlp"], _apply_norm(blk["ln2"], x, cfg), cfg)
    if not prefill:
        return x, None
    if ctx.model is not None:
        n = ek.shape[1] // ctx.size(ctx.model)
        ek, ev = (t.narrow(1, ctx.index(ctx.model) * n, n) for t in (ek, ev))
    return x, EncDecCaches(cache, ek, ev)


class EncDecCaches(NamedTuple):
    """The decoder's caches: its self-attention KVCache (L, B, S_dec, KV,
    HD) and the cross-attention K and V of the encoder's output (L, B,
    S_enc, KV, HD) each; on a mesh each rank's sequence shard of all
    three."""
    self_caches: Any
    cross_k: Any
    cross_v: Any


@dataclasses.dataclass(frozen=True)
class EncDecModel(Model):
    """whisper: batches carry ``frames`` (B, S_enc, D) beside the decoder's
    ``tokens`` (and ``labels`` for the loss). On a mesh both sequences are
    sharded over ``model`` (``S_enc`` and ``S_dec`` must divide by it)."""

    def _decoder(self, params: dict, batch: dict, ctx: AxisCtx, *, prefill: bool):
        """The encoder, its final norm and the decoder's blocks over
        ``batch["tokens"]`` -> (x, EncDecCaches or None); each decoder
        block ``checkpointed`` when not prefilling. On a mesh the encoder's
        output is all-gathered along the sequence for the cross K/V."""
        cfg = self.cfg
        enc = encoder_forward(cfg, params["enc_blocks"], batch["frames"], ctx=ctx)
        enc = _apply_norm(params["enc_final_norm"], enc, cfg)
        enc = ctx.all_gather(enc, ctx.model, axis=1)
        x = self._embed(params, batch["tokens"], ctx).to(enc.dtype)
        block = functools.partial(_dec_block, **_mesh_kw(ctx))
        caches = []
        for blk in _unstack(params["blocks"]):
            x, cache = (block(cfg, blk, x, enc, prefill) if prefill
                        else checkpointed(block, cfg, blk, x, enc))
            caches.append(cache)
        return x, (_stack_trees(caches) if prefill else None)

    def loss(self, params: dict, batch: dict, *, ctx: AxisCtx = SINGLE, gather_fn=None):
        """Next-token cross-entropy of the decoder's tokens (no aux),
        averaged over ``(pod, data)``; on a model axis (the sequences
        sharded) each rank's mean averaged over it too."""
        x, _ = self._decoder(params, batch, ctx, prefill=False)
        loss = softmax_xent_vshard(self._logits(params, x), batch["labels"],
                                   ctx=dataclasses.replace(ctx, vocab=None))
        return ctx.pmean(loss, ctx.model)

    def prefill(self, params: dict, batch: dict, *, ctx: AxisCtx = SINGLE, gather_fn=None):
        """The encoder over the frames and the decoder's prefill over the
        prompt tokens -> (EncDecCaches, last-position logits, None); on a
        mesh the caches are the rank's sequence shards (the cross K/V too),
        the logits the last decoder row's on every rank."""
        x, caches = self._decoder(params, batch, ctx, prefill=True)
        last = self._last_row(_apply_norm(params["final_norm"], x, self.cfg), ctx)
        logits = self._head(params, last)
        if ctx.vaxis is not None:
            logits = ctx.all_gather(logits, ctx.vaxis, axis=logits.dim() - 1)
        return caches, logits[:, 0], None

    def decode_step(self, params: dict, tokens, caches, length, *, ctx: AxisCtx = SINGLE,
                    gather_fn=None, tp: bool = True):
        """One token: self-attention over the decoder's cache (written in
        place; ``attention.gqa_decode``), cross-attention by B4 over the
        encoder cache (``combine=False``) normalised by
        ``attention._lse_combine``; on a mesh each rank's shard of both
        caches, the shards' ``(o, m, l)`` combined over ``model``, and with
        ``tp`` the projections tensor-parallel."""
        cfg = self.cfg
        x = self._embed(params, tokens[:, None], ctx, replicated=True)
        B, H, HD = x.shape[0], cfg.n_heads, cfg.resolved_head_dim
        enc_len = torch.full((B,), caches.cross_k.shape[2], dtype=torch.int32,
                             device=x.device)
        for i in range(cfg.n_layers):
            blk = _take(params["blocks"], i)
            o, _ = attn.gqa_decode(blk["attn"], _apply_norm(blk["ln1"], x, cfg),
                                   _index(caches.self_caches, i), length, cfg, ctx=ctx, tp=tp)
            x = x + o
            w = blk["xattn"]
            q = attn.col_matmul(ctx, _apply_norm(blk["ln_x"], x, cfg), w["wq"], w.get("bq"), tp)
            o2, m2, l2 = ops.decode_attention(q.reshape(B, H, HD), caches.cross_k[i],
                                              caches.cross_v[i], enc_len, combine=False)
            o2 = attn._lse_combine(ctx, o2, m2, l2)
            x = x + attn.row_matmul(ctx, o2.to(x.dtype).reshape(B, 1, -1), w["wo"], tp)
            x = x + mlp_forward(blk["mlp"], _apply_norm(blk["ln2"], x, cfg), cfg,
                                ctx=ctx, tp=tp)
        return self._logits(params, x)[:, 0], caches


def build_model(cfg: ModelConfig) -> Model:
    """``EncDecModel`` for the encdec family, else ``Model``."""
    return EncDecModel(cfg) if cfg.family == "encdec" else Model(cfg)


def flatten_params(tree: dict, prefix: str = "") -> dict:
    """A nested param dict -> one flat dict keyed by the ``/``-joined paths
    (``blocks/attn/wq``); leaves are shared, not copied. Sorting the flat
    keys gives the nested tree's sorted-key leaf order for the LM trees,
    whose keys hold no character below ``/``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_params(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def unflatten_params(flat: dict) -> dict:
    """The inverse of ``flatten_params``."""
    out: dict = {}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = out
        for key in parents:
            node = node.setdefault(key, {})
        node[name] = leaf
    return out


@dataclasses.dataclass(frozen=True)
class FlatModel:
    """An LM as the FL core sees it: ``init`` and ``loss`` over one flat
    param dict (``flatten_params``), so the rounds, the strategies, their
    one-level tree helpers and the checkpoints take an LM state as they
    take a paper model's. ``autograd_remat``: its loss rematerializes
    under plain autograd, so ``core/rounds.local_train`` takes a lone
    client's gradient that way (see its module docstring)."""
    model: Model
    autograd_remat = True

    @property
    def cfg(self) -> ModelConfig:
        return self.model.cfg

    def init(self, generator: torch.Generator, dtype=torch.float32) -> dict:
        return flatten_params(self.model.init(generator, dtype))

    def loss(self, params: dict, batch: dict, *, ctx: AxisCtx = SINGLE, gather_fn=None):
        return self.model.loss(unflatten_params(params), batch, ctx=ctx, gather_fn=gather_fn)


def pad_caches(caches, extra: int):
    """Grow the attention caches in a cache tree by ``extra`` zero slots on
    the sequence dim: stacked KVCaches (L, B, S, KV, HD) and LatentCaches
    (L, B, S, *), an ``EncDecCaches``' self caches. Recurrent states and
    the cross-attention K/V pass through untouched."""
    if isinstance(caches, (attn.KVCache, attn.LatentCache)):
        return type(caches)(*[F.pad(t, [0, 0] * (t.dim() - 3) + [0, extra])
                              for t in caches])
    if isinstance(caches, EncDecCaches):
        return caches._replace(self_caches=pad_caches(caches.self_caches, extra))
    if isinstance(caches, dict):
        return {k: pad_caches(v, extra) for k, v in caches.items()}
    if isinstance(caches, list):
        return [pad_caches(v, extra) for v in caches]
    return caches
