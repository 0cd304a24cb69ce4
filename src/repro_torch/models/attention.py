"""GQA and MLA attention for train, prefill and decode (port of
``repro/models/attention.py``).

GQA runs on one device (``ctx=SINGLE``, the default: every collective the
identity) or on a rank of the temporal placement's mesh
(``sharding/axes.AxisCtx`` with a ``model`` axis), as the JAX functions do:

- train and prefill (``gqa_seqsharded``): the rank holds ``S_loc`` rows of
  the sequence at offset ``index(model) * S_loc``; its K and V are
  all-gathered along the sequence and B3 runs its rows over all of them
  (``Sq = S_loc``, ``Sk = S``, ``q_offset`` the offset);
- decode (``gqa_decode``): the cache is sequence-sharded over ``model``;
  the new row is written into the shard that owns its position, B4 runs
  ``combine=False`` over the shard, and the shards' ``(o, m, l)`` are
  log-sum-exp combined over ``model``. With ``tp`` the projections are
  column/row tensor-parallel (``col_matmul``, ``row_matmul``).

MLA (minicpm3-4b) runs the same way with its latent cache: in training
and prefill (``mla_seqsharded``) the rank's latent rows and rope keys are
all-gathered along the sequence and B3 runs at ``q_offset`` the rank's
offset, in either of its two forms; at decode (``mla_decode``) the new
latent row goes to the owning shard, latent attention runs over the shard
and the shards' ``(o_lat, m, l)`` are log-sum-exp combined over ``model``
(the MLA weights replicated under ``tp``, ``sharding/specs``).

GQA carries QKV bias (qwen2.5-32b, qwen1.5-32b) and qk-norm (chameleon-34b,
qwen3-moe-30b-a3b).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, rms_norm
from repro_torch.sharding.axes import SINGLE, AxisCtx


class KVCache(NamedTuple):
    """KV cache. k/v: (B, S, KV, D), or (L, B, S, KV, D) stacked over layers."""
    k: torch.Tensor
    v: torch.Tensor


class LatentCache(NamedTuple):
    """MLA cache: the normalised kv latent and the shared rope key.
    ckv: (B, S, R), krope: (B, S, rope), or (L, B, S, *) stacked."""
    ckv: torch.Tensor
    krope: torch.Tensor


def gqa_param_shapes(cfg: ModelConfig) -> dict:
    """Projection shapes of one GQA layer, in the JAX layout ``(in, out)``,
    with the QKV biases and the qk-norm weights where the config has them."""
    D, H, KV, HD = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    shapes = {
        "wq": (D, H * HD),
        "wk": (D, KV * HD),
        "wv": (D, KV * HD),
        "wo": (H * HD, D),
    }
    if cfg.qkv_bias:
        shapes |= {"bq": (H * HD,), "bk": (KV * HD,), "bv": (KV * HD,)}
    if cfg.qk_norm:
        shapes |= {"q_norm": (HD,), "k_norm": (HD,)}
    return shapes


def mla_param_shapes(cfg: ModelConfig) -> dict:
    """Projection shapes of one MLA layer in the JAX layout ``(in, out)``:
    the query down/up projections with a norm between, the kv down
    projection to the latent and the rope key, the latent's norm, its up
    projection to per-head nope keys and values, and the output."""
    m, D, H = cfg.mla, cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wdq": (D, m.q_lora_rank),
        "q_norm": (m.q_lora_rank,),
        "wuq": (m.q_lora_rank, H * qk),
        "wdkv": (D, m.kv_lora_rank + m.qk_rope_head_dim),
        "kv_norm": (m.kv_lora_rank,),
        "wukv": (m.kv_lora_rank, H * (m.qk_nope_head_dim + m.v_head_dim)),
        "wo": (H * m.v_head_dim, D),
    }


def attn_param_shapes(cfg: ModelConfig) -> dict:
    return mla_param_shapes(cfg) if cfg.attn_type == "mla" else gqa_param_shapes(cfg)


def col_matmul(ctx: AxisCtx, h, w_loc, b_loc=None, tp: bool = False):
    """Column-parallel ``h @ W (+ b)``: with ``tp`` on a model axis the
    rank holds a column block of W (and b), and the output is all-gathered
    to full width; otherwise the plain product."""
    y = h @ w_loc
    if b_loc is not None:
        y = y + b_loc
    if tp and ctx.model is not None:
        y = ctx.all_gather(y, ctx.model, axis=y.dim() - 1)
    return y


def row_matmul(ctx: AxisCtx, h, w_loc, tp: bool = False):
    """Row-parallel ``h @ W`` with ``h`` full width: with ``tp`` on a model
    axis the rank holds a row block of W, multiplies its slice of ``h``'s
    columns and the partial products are summed over ``model``."""
    if tp and ctx.model is not None:
        n = w_loc.shape[0]
        h_loc = h.narrow(h.dim() - 1, ctx.index(ctx.model) * n, n)
        return ctx.psum(h_loc @ w_loc, ctx.model)
    return h @ w_loc


def _qkv(w, cfg: ModelConfig, h):
    """h (B, S, D) -> q (B,S,H,HD), k and v (B,S,KV,HD): the projections,
    their biases added before the heads are split, then qk-norm (an RMSNorm
    over each head's HD) on q and k."""
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    B, S = h.shape[0], h.shape[1]
    q, k, v = h @ w["wq"], h @ w["wk"], h @ w["wv"]
    if cfg.qkv_bias:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q = q.reshape(B, S, H, HD)
    k = k.reshape(B, S, KV, HD)
    v = v.reshape(B, S, KV, HD)
    if cfg.qk_norm:
        q = rms_norm(q, w["q_norm"], cfg.norm_eps)
        k = rms_norm(k, w["k_norm"], cfg.norm_eps)
    return q, k, v


def gqa_seqsharded(w: dict, h, cfg: ModelConfig, *, ctx: AxisCtx = SINGLE,
                   causal: bool = True, return_cache: bool = False):
    """Train or prefill attention, causal or, for an encoder, full; rope
    either way, as in the JAX package. h: (B, S_loc, D), this rank's rows
    of the sequence (all of it off the mesh), at offset ``index(model) *
    S_loc``; K and V all-gathered along the sequence over ``model``.
    Returns (B, S_loc, D) [+ the KVCache of these rows]."""
    S_loc = h.shape[1]
    q, k, v = _qkv(w, cfg, h)
    off = ctx.index(ctx.model) * S_loc
    pos = off + torch.arange(S_loc, device=h.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    kg = ctx.all_gather(k, ctx.model, axis=1)
    vg = ctx.all_gather(v, ctx.model, axis=1)
    o = ops.flash_attention(q, kg, vg, off, causal)
    out = o.reshape(h.shape[0], S_loc, -1) @ w["wo"]
    return (out, KVCache(k, v)) if return_cache else out


def gqa_decode(w: dict, h, cache: KVCache, length, cfg: ModelConfig, *,
               ctx: AxisCtx = SINGLE, tp: bool = False):
    """One-token decode. h: (B, 1, D), the same on every model rank;
    cache.k/v: (B, S_loc, KV, HD), this rank's shard of the cache, global
    positions ``[index(model) * S_loc, ...)`` (the whole cache off the
    mesh); length: (B,) int32 context length (the new token goes to
    position ``length``). Returns (out (B, 1, D), cache). The one-token
    projections take the biases and qk-norm as ``_qkv`` gives them, before
    the rotary embedding; with ``tp`` they are column/row-parallel.

    The new K/V row is written IN PLACE into the shard that owns position
    ``length``, and the same cache is returned. The JAX package adds a
    one-hot row, ``cache + onehot * k_new``, which rewrites the whole
    cache; the values are the same, because slot ``length`` is zero
    (``pad_caches`` grows the cache with zeros and each slot is written
    once) and every other slot gets +0. As there, a position past the
    cache's end writes nothing. B4 runs ``combine=False`` over the shard's
    ``clip(length + 1 - start, 0, S_loc)`` keys (0 in a shard past the
    token: m = -1e30, l = 0, o = 0), then the shards' ``(o, m, l)`` are
    log-sum-exp combined over ``model``."""
    B = h.shape[0]
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = col_matmul(ctx, h, w["wq"], w.get("bq"), tp).reshape(B, 1, H, HD)
    k_new = col_matmul(ctx, h, w["wk"], w.get("bk"), tp).reshape(B, 1, KV, HD)
    v_new = col_matmul(ctx, h, w["wv"], w.get("bv"), tp).reshape(B, 1, KV, HD)
    if cfg.qk_norm:
        q = rms_norm(q, w["q_norm"], cfg.norm_eps)
        k_new = rms_norm(k_new, w["k_norm"], cfg.norm_eps)
    pos = length[:, None]                                    # (B, 1)
    q = apply_rope(q, pos, cfg.rope_theta)
    k_new = apply_rope(k_new, pos, cfg.rope_theta)

    S_loc = cache.k.shape[1]
    start = ctx.index(ctx.model) * S_loc
    rows = torch.arange(B, device=h.device)
    slot = torch.clamp(length - start, 0, S_loc - 1).long()
    mine = ((length >= start) & (length < start + S_loc))[:, None, None]
    cache.k[rows, slot] = torch.where(mine, k_new[:, 0], cache.k[rows, slot])
    cache.v[rows, slot] = torch.where(mine, v_new[:, 0], cache.v[rows, slot])

    local_len = torch.clamp(length + 1 - start, 0, S_loc).to(torch.int32)
    o, m, l = ops.decode_attention(q[:, 0], cache.k, cache.v, local_len, combine=False)
    o = _lse_combine(ctx, o, m, l)
    out = row_matmul(ctx, o.to(h.dtype).reshape(B, 1, -1), w["wo"], tp)
    return out, cache


def _lse_combine(ctx: AxisCtx, o, m, l):
    """Normalise unnormalised f32 attention ``(o (B, H, Dv), m (B, H),
    l (B, H))``: on a model axis the shards' triples all-gathered and
    log-sum-exp combined first (a shard with no key: m = -1e30, l = 0,
    o = 0, weight 0)."""
    if ctx.model is not None:
        B, H, Dv = o.shape
        stats = torch.cat([o.reshape(B, -1), m, l], dim=-1)
        g = ctx.all_gather(stats[None], ctx.model, axis=0)          # (M, B, ...)
        o_all = g[..., :H * Dv].reshape(-1, B, H, Dv)
        m_all, l_all = g[..., H * Dv:H * Dv + H], g[..., H * Dv + H:]
        m_g = m_all.amax(dim=0)
        wgt = torch.exp(m_all - m_g[None])
        l = (l_all * wgt).sum(dim=0)
        o = (o_all * wgt[..., None]).sum(dim=0)
    return o / torch.clamp(l, min=1e-30)[..., None]


def _mla_q(w, cfg: ModelConfig, h, positions):
    """h (B, S, D) -> q_nope (B,S,H,nope), q_rope (B,S,H,rope): the query
    latent ``h @ wdq`` through its RMSNorm, up-projected, split, and the
    rope part rotated."""
    m, H = cfg.mla, cfg.n_heads
    B, S = h.shape[0], h.shape[1]
    nope = m.qk_nope_head_dim
    cq = rms_norm(h @ w["wdq"], w["q_norm"], cfg.norm_eps)
    q = (cq @ w["wuq"]).reshape(B, S, H, nope + m.qk_rope_head_dim)
    return q[..., :nope], apply_rope(q[..., nope:], positions, cfg.rope_theta)


def _mla_kv_latent(w, cfg: ModelConfig, h, positions):
    """h (B, S, D) -> ckv (B,S,R), krope (B,S,rope): the kv down projection,
    its first R columns through ``kv_norm`` (B2 over a strided view, which
    ``ops`` copies to dense rows), the last rope columns rotated (one key
    shared by every head)."""
    m = cfg.mla
    dkv = h @ w["wdkv"]
    ckv = rms_norm(dkv[..., :m.kv_lora_rank], w["kv_norm"], cfg.norm_eps)
    krope = apply_rope(dkv[:, :, None, m.kv_lora_rank:], positions,
                       cfg.rope_theta)[:, :, 0, :]
    return ckv, krope


def _mla_expand_kv(w, cfg: ModelConfig, ckv):
    """ckv (B, S, R) -> per-head k_nope (B,S,H,nope) and v (B,S,H,v)."""
    m, H = cfg.mla, cfg.n_heads
    B, S = ckv.shape[0], ckv.shape[1]
    kv = (ckv @ w["wukv"]).reshape(B, S, H, m.qk_nope_head_dim + m.v_head_dim)
    return kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]


def mla_seqsharded(w: dict, h, cfg: ModelConfig, *, return_cache: bool = False,
                   absorbed: bool = True, ctx: AxisCtx = SINGLE):
    """Causal MLA train or prefill attention. h: (B, S_loc, D), this
    rank's rows of the sequence (all of it off the mesh) at offset
    ``index(model) * S_loc``; the latent rows and rope keys all-gathered
    along the sequence over ``model``, B3 at ``q_offset`` the offset.
    Returns (B, S_loc, D) [+ the LatentCache of these rows].

    Two forms of one function (the JAX package's, chosen there by
    ``REPRO_MLA_ABSORBED``, here by ``absorbed``):
    - absorbed (the default): W^UK folded into the queries, B3 attends in
      the latent space as MQA, H query heads on one kv head of Dk = R +
      rope (288 at minicpm3-4b) and Dv = R (256); W^UV applied after;
    - expanded: per-head keys and values from the gathered latent, B3 as
      MHA at Dk = nope + rope (96) and Dv = v (64).
    Both scale the scores by 1/sqrt(nope + rope)."""
    m, H = cfg.mla, cfg.n_heads
    B, S_loc = h.shape[0], h.shape[1]
    off = ctx.index(ctx.model) * S_loc
    pos = off + torch.arange(S_loc, device=h.device)
    q_nope, q_rope = _mla_q(w, cfg, h, pos)
    ckv, krope = _mla_kv_latent(w, cfg, h, pos)
    ckv_g = ctx.all_gather(ckv, ctx.model, axis=1)
    krope_g = ctx.all_gather(krope, ctx.model, axis=1)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    R, nope = m.kv_lora_rank, m.qk_nope_head_dim
    if absorbed:
        wukv = w["wukv"].reshape(R, H, nope + m.v_head_dim)
        q_lat = torch.einsum("bshd,rhd->bshr", q_nope, wukv[..., :nope])
        q_cat = torch.cat([q_lat, q_rope], dim=-1)             # (B,S,H,R+rope)
        kv_cat = torch.cat([ckv_g, krope_g], dim=-1)[:, :, None, :]
        o_lat = ops.flash_attention(q_cat, kv_cat, ckv_g[:, :, None, :], off, True, scale)
        o = torch.einsum("bshr,rhv->bshv", o_lat, wukv[..., nope:])
    else:
        k_nope, v = _mla_expand_kv(w, cfg, ckv_g)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, krope_g[:, :, None, :].expand(
            *k_nope.shape[:3], m.qk_rope_head_dim)], dim=-1)
        o = ops.flash_attention(q, k, v, off, True, scale)
    out = o.reshape(B, S_loc, -1) @ w["wo"]
    return (out, LatentCache(ckv, krope)) if return_cache else out


def mla_decode(w: dict, h, cache: LatentCache, length, cfg: ModelConfig, *,
               ctx: AxisCtx = SINGLE, tp: bool = False):
    """One-token MLA decode in the absorbed form: attention runs in the
    latent space as einsums (no kernel, as in the JAX package), so a
    step's work scales with R + rope (288), not H * (Dk + Dv). h: (B, 1,
    D), the same on every model rank; cache.ckv (B, S_loc, R),
    cache.krope (B, S_loc, rope), this rank's shard of the cache, global
    positions ``[index(model) * S_loc, ...)`` (the whole cache off the
    mesh); length: (B,) int32 context length (the new token goes to
    position ``length``). Returns (out (B, 1, D), cache). The MLA weights
    are whole on every rank (``tp`` changes nothing here: the absorbed
    einsums do not shard by head, ``sharding/specs._TP_MLA_OVERRIDE``).

    The new latent row is written IN PLACE into the shard that owns
    position ``length``, and the same cache is returned. The JAX package
    adds a one-hot row, ``cache + onehot * row``, which rewrites the whole
    cache; the values are the same, because slot ``length`` is zero
    (``pad_caches`` grows the cache with zeros and each slot is written
    once) and every other slot gets +0. As there, a position past the
    cache's end writes nothing. Latent attention runs over the shard's
    ``clip(length + 1 - start, 0, S_loc)`` keys, and the shards' ``(o_lat,
    m, l)`` are log-sum-exp combined over ``model``."""
    m, H = cfg.mla, cfg.n_heads
    B = h.shape[0]
    R, nope = m.kv_lora_rank, m.qk_nope_head_dim
    pos = length[:, None]
    q_nope, q_rope = _mla_q(w, cfg, h, pos)                   # (B,1,H,*)
    ckv_new, krope_new = _mla_kv_latent(w, cfg, h, pos)       # (B,1,R), (B,1,rope)

    S_loc = cache.ckv.shape[1]
    start = ctx.index(ctx.model) * S_loc
    rows = torch.arange(B, device=h.device)
    slot = torch.clamp(length - start, 0, S_loc - 1).long()
    mine = ((length >= start) & (length < start + S_loc))[:, None]
    cache.ckv[rows, slot] = torch.where(mine, ckv_new[:, 0], cache.ckv[rows, slot])
    cache.krope[rows, slot] = torch.where(mine, krope_new[:, 0], cache.krope[rows, slot])

    # absorb W^UK into q: q_lat (B, H, R) = q_nope . Wuk_h^T
    wukv = w["wukv"].reshape(R, H, nope + m.v_head_dim)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], wukv[..., :nope])
    scale = 1.0 / math.sqrt(nope + m.qk_rope_head_dim)
    s = (torch.einsum("bhr,bsr->bhs", q_lat, cache.ckv)
         + torch.einsum("bhd,bsd->bhs", q_rope[:, 0], cache.krope)).to(torch.float32)
    s = s * scale
    local_len = torch.clamp(length + 1 - start, 0, S_loc)
    valid = torch.arange(S_loc, device=h.device)[None] < local_len[:, None]
    s = torch.where(valid[:, None], s, -1e30)
    m_ = s.amax(dim=-1)
    p = torch.exp(s - m_[..., None])
    l = p.sum(dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", p.to(cache.ckv.dtype), cache.ckv)
    o_lat = _lse_combine(ctx, o_lat.to(torch.float32), m_, l)
    o = torch.einsum("bhr,rhv->bhv", o_lat.to(h.dtype), wukv[..., nope:])
    return o.reshape(B, 1, -1) @ w["wo"], cache


def init_cache(cfg: ModelConfig, batch: int, s_loc: int, dtype=torch.bfloat16,
               device="cpu"):
    """An empty (zero) cache of ``s_loc`` slots: a LatentCache for MLA,
    else a KVCache."""
    if cfg.attn_type == "mla":
        m = cfg.mla
        return LatentCache(
            ckv=torch.zeros((batch, s_loc, m.kv_lora_rank), dtype=dtype, device=device),
            krope=torch.zeros((batch, s_loc, m.qk_rope_head_dim), dtype=dtype,
                              device=device))
    HD = cfg.resolved_head_dim
    shape = (batch, s_loc, cfg.n_kv_heads, HD)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))
