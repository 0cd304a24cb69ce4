"""Decoder-only LMs: the training loss, prefill and greedy decode (port of
the dense and MoE families of ``repro/models/transformer.py``).

Params are a plain nested ``dict[str, Tensor]`` with the JAX package's
names and layouts, blocks stacked on a leading layer dim
(``blocks/attn/wq`` is ``(L, D, H*HD)``), so ``interop.params_from_numpy``
is a copy of each leaf. The JAX ``lax.scan`` over layers is a Python loop
over that dim. Single device: ``AxisCtx``, the ZeRO-3 gathers and the vocab
sharding of the JAX package drop out (identities with ``AxisCtx()``).

The training phase keeps every layer's activations for the backward: the
JAX package rematerializes each layer (``jax.checkpoint``), and
``torch.utils.checkpoint`` does not run under ``torch.func``'s transforms,
which the FL rounds differentiate with. ``FlatModel`` is the LM as the FL
core sees it: one flat param dict with ``/``-joined keys.

A block's attention is GQA or MLA (``cfg.attn_type``), its FFN the SwiGLU
MLP or, for the MoE family, ``moe.moe_ffn`` (plus a dense residual MLP
after ``ln3`` where ``dense_residual_d_ff`` is set, as in arctic-480b),
whose aux losses add to the training loss. Tied embeddings
(minicpm3-4b) use ``embed.T`` as the head and have no ``lm_head`` leaf.
Encoder-decoder, SSM and hybrid stacks come with ROADMAP A15.5 and A15.6.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import dense_init, embed_init, rms_norm


def mlp_param_shapes(cfg: ModelConfig, d_ff: int = 0) -> dict:
    """SwiGLU MLP of width ``d_ff`` (default ``cfg.d_ff``): gate ``w1``, up
    ``w3``, down ``w2``."""
    D, F_ = cfg.d_model, d_ff or cfg.d_ff
    return {"w1": (D, F_), "w3": (D, F_), "w2": (F_, D)}


def mlp_forward(w: dict, x, cfg: ModelConfig):
    """silu(x @ w1) * (x @ w3) @ w2."""
    return (F.silu(x @ w["w1"]) * (x @ w["w3"])) @ w["w2"]


def embed_lookup(embed, tokens):
    """Rows of the embedding for ``tokens`` (tied or not: one device holds
    the whole matrix, so the JAX package's two sharded lookups are this
    one). Through
    ``F.embedding``, whose gradient sums each row's tokens in one order on
    every run and on the CPU too, where indexing's (an accumulating
    ``index_put_``) is documented as nondeterministic."""
    return F.embedding(tokens, embed)


def softmax_xent_vshard(logits, labels):
    """Stable cross-entropy, the mean over the tokens. logits: (B, S, V)
    f32; labels: (B, S) ids. One device holds the whole vocab, so the JAX
    package's vocab-shard max and sums are the local ones (and its ``valid``
    mask, which ``Model.loss`` never passes, is left out). The max is a
    stabilizer only (the loss's gradient does not depend on it) and is held
    out of the gradient, as there."""
    m = logits.amax(dim=-1).detach()
    lse = m + torch.log(torch.exp(logits - m[..., None]).sum(dim=-1))
    tgt = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (lse - tgt).mean()


def dense_block_shapes(cfg: ModelConfig) -> dict:
    """One block: two RMSNorms, GQA or MLA attention, and the MLP or, for
    the MoE family, the router and experts (with a dense residual MLP and
    its norm ``ln3`` where the config has one)."""
    norm = {"w": (cfg.d_model,)}
    s = {"ln1": norm, "ln2": norm, "attn": attn.attn_param_shapes(cfg)}
    if cfg.moe is not None and cfg.family == "moe":
        s["moe"] = moe_mod.moe_param_shapes(cfg)
        if cfg.moe.dense_residual_d_ff:
            s["dense_mlp"] = mlp_param_shapes(cfg, cfg.moe.dense_residual_d_ff)
            s["ln3"] = norm
    else:
        s["mlp"] = mlp_param_shapes(cfg)
    return s


def _map_shapes(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_shapes(fn, v) for k, v in tree.items()}
    return fn(tree)


def param_shapes(cfg: ModelConfig) -> dict:
    """Full logical shapes, as the JAX package's ``param_shapes`` gives them
    for the dense and MoE families: a nested dict of tuples, blocks
    stacked; no ``lm_head`` when the embeddings are tied."""
    Vp, D, L = cfg.padded_vocab, cfg.d_model, cfg.n_layers
    p = {"embed": (Vp, D), "final_norm": {"w": (D,)},
         "blocks": _map_shapes(lambda sh: (L,) + sh, dense_block_shapes(cfg))}
    if not cfg.tie_embeddings:
        p["lm_head"] = (D, Vp)
    return p


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def init_params(generator: torch.Generator, cfg: ModelConfig,
                dtype=torch.float32) -> dict:
    """Random params on the generator's device, with the JAX package's
    initializers: norms 1, QKV biases 0, embed N(0, 0.02), matrices (the
    router and expert weights too) N(0, 1/fan_in), fan-in ``shape[-2]``.
    (``torch.Generator`` and ``jax.random`` draw different numbers; tests
    carry JAX's params across with ``interop`` instead.)"""
    out: dict = {}
    for path, shape in _leaves(param_shapes(cfg)):
        name = path[-2] if path[-1] == "w" else path[-1]
        if name.startswith("ln") or name.endswith("norm"):
            leaf = torch.ones(shape, dtype=dtype, device=generator.device)
        elif name in ("bq", "bk", "bv"):
            leaf = torch.zeros(shape, dtype=dtype, device=generator.device)
        elif name == "embed":
            leaf = embed_init(generator, shape, dtype)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[0]
            leaf = dense_init(generator, shape, in_dim=fan_in, dtype=dtype)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def _dense_block(cfg: ModelConfig, w: dict, x, *, phase: str, cache=None,
                 length=None):
    """One block -> (x, cache, aux): phase 'train' gives no cache, 'prefill'
    the KVCache or LatentCache of the rows, 'decode' the cache written in
    place; aux is the MoE layer's load-balance + z loss, else 0.0."""
    h = rms_norm(x, w["ln1"]["w"], cfg.norm_eps)
    mla = cfg.attn_type == "mla"
    if phase == "decode":
        decode = attn.mla_decode if mla else attn.gqa_decode
        o, new_cache = decode(w["attn"], h, cache, length, cfg)
    else:
        fwd = attn.mla_seqsharded if mla else attn.gqa_seqsharded
        if phase == "prefill":
            o, new_cache = fwd(w["attn"], h, cfg, return_cache=True)
        else:
            o, new_cache = fwd(w["attn"], h, cfg), None
    x = x + o
    h = rms_norm(x, w["ln2"]["w"], cfg.norm_eps)
    if "moe" not in w:
        return x + mlp_forward(w["mlp"], h, cfg), new_cache, 0.0
    mo, maux = moe_mod.moe_ffn(w["moe"], h, cfg)
    if "dense_mlp" in w:
        mo = mo + mlp_forward(w["dense_mlp"], rms_norm(x, w["ln3"]["w"], cfg.norm_eps), cfg)
    return x + mo, new_cache, maux.load_balance + maux.z_loss


def _take(tree, i):
    return {k: _take(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def stack_train(cfg: ModelConfig, blocks: dict, x, *, phase: str = "train"):
    """Forward through the stacked blocks, layer by layer. Returns (x, aux,
    caches): aux sums the MoE layers' aux losses (0.0 without MoE); caches
    are None for phase 'train' and for 'prefill' the layers' KVCache
    (L, B, S, KV, HD) or LatentCache (L, B, S, *) stacked. Training keeps
    every layer's activations (see the module docstring)."""
    if phase not in ("train", "prefill"):
        raise ValueError(f"stack_train runs phase 'train' or 'prefill', not {phase!r}")
    aux, caches = 0.0, []
    for i in range(cfg.n_layers):
        x, cache, a = _dense_block(cfg, _take(blocks, i), x, phase=phase)
        aux = aux + a
        if cache is not None:
            caches.append(cache)
    if not caches:
        return x, aux, None
    return x, aux, type(caches[0])(*(torch.stack(t) for t in zip(*caches)))


def stack_decode(cfg: ModelConfig, blocks: dict, x, caches, length):
    """One decode token through the stacked blocks; each layer writes its
    slot of ``caches`` (a stacked KVCache or LatentCache) in place. Returns
    (x, caches)."""
    for i in range(cfg.n_layers):
        layer_cache = type(caches)(*(t[i] for t in caches))
        x, _, _ = _dense_block(cfg, _take(blocks, i), x, phase="decode",
                               cache=layer_cache, length=length)
    return x, caches


@dataclasses.dataclass(frozen=True)
class Model:
    """A decoder-only LM over a param dict: the training loss, prefill and
    greedy decode."""
    cfg: ModelConfig

    def init(self, generator: torch.Generator, dtype=torch.float32) -> dict:
        return init_params(generator, self.cfg, dtype)

    def _logits(self, params: dict, x, last: bool = False):
        """The final norm over every row, then the head (``embed.T`` when
        tied) over every row or only the last position -> f32 logits."""
        x = rms_norm(x, params["final_norm"]["w"], self.cfg.norm_eps)
        if last:
            x = x[:, -1:]
        head = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        return (x @ head.to(x.dtype)).to(torch.float32)

    def loss(self, params: dict, batch: dict):
        """batch["tokens"], batch["labels"]: (B, S) ids -> the scalar
        ``loss + aux`` (the JAX package's first output; aux sums the MoE
        layers' aux losses, 0 without MoE): next-token cross-entropy over
        f32 logits."""
        x = embed_lookup(params["embed"], batch["tokens"])
        x, aux, _ = stack_train(self.cfg, params["blocks"], x, phase="train")
        return softmax_xent_vshard(self._logits(params, x), batch["labels"]) + aux

    def prefill(self, params: dict, batch: dict):
        """batch["tokens"]: (B, S) -> (caches, last-position logits (B, Vp)
        f32, None)."""
        x = embed_lookup(params["embed"], batch["tokens"])
        x, _, caches = stack_train(self.cfg, params["blocks"], x, phase="prefill")
        return caches, self._logits(params, x, last=True)[:, 0], None

    def decode_step(self, params: dict, tokens, caches, length):
        """tokens: (B,) previous token ids; length: (B,) int32 context
        length. Returns (logits (B, Vp) f32, caches written in place)."""
        x = embed_lookup(params["embed"], tokens[:, None])
        x, caches = stack_decode(self.cfg, params["blocks"], x, caches, length)
        return self._logits(params, x)[:, 0], caches

    def greedy_token(self, logits):
        """(B, Vp) -> (B,) the first index of each row's maximum, as
        ``jnp.argmax`` takes it (``torch.argmax`` documents the same rule)."""
        return torch.argmax(logits, dim=-1)


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
    take a paper model's."""
    model: Model

    @property
    def cfg(self) -> ModelConfig:
        return self.model.cfg

    def init(self, generator: torch.Generator, dtype=torch.float32) -> dict:
        return flatten_params(self.model.init(generator, dtype))

    def loss(self, params: dict, batch: dict):
        return self.model.loss(unflatten_params(params), batch)


def pad_caches(caches, extra: int):
    """Grow stacked caches (a KVCache (L, B, S, KV, HD) or a LatentCache
    (L, B, S, *)) by ``extra`` zero slots on the sequence dim."""
    return type(caches)(*[F.pad(t, [0, 0] * (t.dim() - 3) + [0, extra]) for t in caches])
