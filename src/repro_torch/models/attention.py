"""GQA attention for prefill and decode (port of the GQA half of
``repro/models/attention.py``).

Single device: the JAX functions' ``AxisCtx`` is dropped, and with it the
sequence-sharding offsets, all-gathers and the cross-shard LSE combine
(with ``AxisCtx()`` they are identities). QKV bias (qwen2.5-32b,
qwen1.5-32b) and qk-norm (chameleon-34b) are here; MLA comes with its
architecture (ROADMAP A15), and ``model_zoo.build`` refuses it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, rms_norm


class KVCache(NamedTuple):
    """KV cache. k/v: (B, S, KV, D), or (L, B, S, KV, D) stacked over layers."""
    k: torch.Tensor
    v: torch.Tensor


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


def gqa_seqsharded(w: dict, h, cfg: ModelConfig, *, return_cache: bool = False):
    """Causal train or prefill attention over the whole sequence (one device
    holds all of it). h: (B, S, D). Returns (B, S, D) [+ the KVCache of
    these rows]."""
    S = h.shape[1]
    q, k, v = _qkv(w, cfg, h)
    pos = torch.arange(S, device=h.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    o = ops.flash_attention(q, k, v, 0, True)
    out = o.reshape(h.shape[0], S, -1) @ w["wo"]
    return (out, KVCache(k, v)) if return_cache else out


def gqa_decode(w: dict, h, cache: KVCache, length, cfg: ModelConfig):
    """One-token decode. h: (B, 1, D); cache.k/v: (B, S, KV, HD); length:
    (B,) int32 context length (the new token goes to position ``length``).
    Returns (out (B, 1, D), cache). The one-token projections take the
    biases and qk-norm as ``_qkv`` gives them, before the rotary embedding.

    The new K/V row is written into the cache IN PLACE, and the same cache
    is returned. The JAX package adds a one-hot row, ``cache + onehot *
    k_new``, which rewrites the whole cache; the values are the same,
    because slot ``length`` is zero (``pad_caches`` grows the cache with
    zeros and each slot is written once) and every other slot gets +0. As
    there, a position past the cache's end writes nothing."""
    B = h.shape[0]
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k_new, v_new = _qkv(w, cfg, h)
    pos = length[:, None]                                    # (B, 1)
    q = apply_rope(q, pos, cfg.rope_theta)
    k_new = apply_rope(k_new, pos, cfg.rope_theta)

    S = cache.k.shape[1]
    rows = torch.arange(B, device=h.device)
    slot = torch.clamp(length, 0, S - 1).long()
    mine = (length < S)[:, None, None]
    cache.k[rows, slot] = torch.where(mine, k_new[:, 0], cache.k[rows, slot])
    cache.v[rows, slot] = torch.where(mine, v_new[:, 0], cache.v[rows, slot])

    local_len = torch.clamp(length + 1, 0, S).to(torch.int32)
    o, m, l = ops.decode_attention(q[:, 0], cache.k, cache.v, local_len, combine=False)
    o = o / torch.clamp(l, min=1e-30)[..., None]
    out = o.to(h.dtype).reshape(B, 1, -1) @ w["wo"]
    return out, cache


def init_cache(cfg: ModelConfig, batch: int, s_loc: int, dtype=torch.bfloat16,
               device="cpu") -> KVCache:
    """An empty (zero) cache of ``s_loc`` slots."""
    HD = cfg.resolved_head_dim
    shape = (batch, s_loc, cfg.n_kv_heads, HD)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))
