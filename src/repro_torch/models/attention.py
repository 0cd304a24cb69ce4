"""GQA attention for prefill and decode (port of the GQA half of
``repro/models/attention.py``).

Single device: the JAX functions' ``AxisCtx`` is dropped, and with it the
sequence-sharding offsets, all-gathers and the cross-shard LSE combine
(with ``AxisCtx()`` they are identities). QKV bias, qk-norm and MLA come
with their architectures (ROADMAP A15); ``model_zoo.build`` refuses
configs that need them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope


class KVCache(NamedTuple):
    """KV cache. k/v: (B, S, KV, D), or (L, B, S, KV, D) stacked over layers."""
    k: torch.Tensor
    v: torch.Tensor


def gqa_param_shapes(cfg: ModelConfig) -> dict:
    """Projection shapes of one GQA layer, in the JAX layout ``(in, out)``."""
    D, H, KV, HD = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "wq": (D, H * HD),
        "wk": (D, KV * HD),
        "wv": (D, KV * HD),
        "wo": (H * HD, D),
    }


def _qkv(w, cfg: ModelConfig, h):
    """h (B, S, D) -> q (B,S,H,HD), k and v (B,S,KV,HD)."""
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    B, S = h.shape[0], h.shape[1]
    q = (h @ w["wq"]).reshape(B, S, H, HD)
    k = (h @ w["wk"]).reshape(B, S, KV, HD)
    v = (h @ w["wv"]).reshape(B, S, KV, HD)
    return q, k, v


def gqa_seqsharded(w: dict, h, cfg: ModelConfig, *, return_cache: bool = False):
    """Causal prefill attention over the whole sequence (one device holds all
    of it). h: (B, S, D). Returns (B, S, D) [+ the KVCache of these rows]."""
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
    Returns (out (B, 1, D), cache).

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
