"""Plain PyTorch oracles for every kernel (port of ``repro/kernels/ref.py``).

Whole-matrix formulations with no blocking: the ground truth the blocked
plain versions and the CUDA kernels are held to.
"""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True, q_offset=0,
                        scale: float | None = None):
    """Plain softmax attention.

    q: (B, Sq, H, Dk); k: (B, Sk, KV, Dk); v: (B, Sk, KV, Dv) with H % KV == 0.
    Positions of q are ``q_offset + arange(Sq)`` for causal masking.
    Returns (B, Sq, H, Dv).
    """
    B, Sq, H, Dk = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(Dk)
    qg = q.reshape(B, Sq, KV, G, Dk)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(torch.float32) * scale
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        kpos = torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask[None, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    return o.reshape(B, Sq, H, v.shape[-1])


def decode_attention_ref(q, k, v, length, *, scale: float | None = None,
                         return_stats: bool = False):
    """Single-token attention over a (possibly partially filled) KV cache.

    q: (B, H, Dk); k: (B, S, KV, Dk); v: (B, S, KV, Dv); length: (B,) valid
    prefix lengths. Returns (B, H, Dv) (plus (m, l) row stats if requested,
    for a cross-shard log-sum-exp combine).
    """
    B, H, Dk = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(Dk)
    qg = q.reshape(B, KV, G, Dk)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k).to(torch.float32) * scale
    valid = torch.arange(k.shape[1], device=q.device)[None] < length[:, None]
    s = torch.where(valid[:, None, None], s, -1e30)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype), v)
    o = o.to(torch.float32) / torch.clamp(l, min=1e-30)[..., None]
    o = o.reshape(B, H, v.shape[-1])
    if return_stats:
        return o, m.reshape(B, H), l.reshape(B, H)
    return o


def rmsnorm_ref(x, w, eps: float = 1e-6):
    """RMSNorm over the last dim; f32 accumulation, output in x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32)).to(x.dtype)


def quant_aggregate_ref(qdeltas, scales, weights):
    """Dequantize int8 client deltas and reduce with client weights.

    qdeltas: (C, N) int8; scales: (C, N // block) f32 per-block scales;
    weights: (C,) f32 client weights. Returns (N,) f32:
    ``sum_c weights[c] * qdeltas[c] * scales[c, block(n)]``.
    """
    C, N = qdeltas.shape
    nblocks = scales.shape[1]
    d = qdeltas.to(torch.float32).reshape(C, nblocks, N // nblocks)
    d = d * scales[..., None]
    return torch.einsum("c,cnb->nb", weights, d).reshape(N)


def quantize_blockwise_ref(x, block: int = 256):
    """Symmetric int8 block quantization over the last dim.

    x: (..., N) -> (int8 (..., N), f32 scales (..., N/block)). Leading dims
    (a client dim) quantize independently. ``torch.round`` rounds half to
    even, as ``jnp.round`` does.
    """
    *lead, N = x.shape
    xb = x.reshape(*lead, N // block, block)
    amax = xb.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127)
    return q.to(torch.int8).reshape(*lead, N), scale.to(torch.float32)
