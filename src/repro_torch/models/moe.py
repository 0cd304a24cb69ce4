"""Mixture-of-experts FFN with capacity buckets, on one device (port of the
single-device half of ``repro/models/moe.py``).

Routing in f32 (softmax, top-k, gates renormalised), GShard's aux losses,
then capacity bucketing: each (token, choice) pair takes the next slot of
its expert's bucket, ``C = capacity(T, K, E, cf)`` slots an expert; pairs
past an expert's C are dropped. The buckets run the grouped SwiGLU as
batched matmuls over the expert dim, and each token sums its K results
weighted by its gates. The three layouts of the JAX package's params are
taken (``ep_mode`` "model", "grid" and "subgrid", whose expert FFN slices
are packed on the expert dim); on one device "model" and "grid" compute
the same, and "subgrid" reassembles (E, D, F) first.

The collectives that shard the experts over devices (the all-to-alls, the
ring of ``REPRO_QUANT_RING`` and the subgrid butterfly) come with the
sharded halves of the multi-device port, ROADMAP A16.3: expert weights
holding fewer experts than the config (a device's shard) raise a
``ValueError`` naming it.

Two choices differ from the JAX package's code, not its values:
- the bucket scatter writes dropped pairs into a swallow slot past each
  bucket's end (as there) with an out-of-place ``index_put``, whose
  gradient is a gather;
- the gather back takes a dropped pair's row from an appended zero row
  instead of another expert's slot (the JAX package multiplies that row by
  ``keep`` = 0). So every kept slot is read once, and the gather's
  gradient, an accumulating ``index_put``, never sums into a kept slot
  twice: it is bitwise repeatable on the card.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init


class MoEAux(NamedTuple):
    load_balance: torch.Tensor
    z_loss: torch.Tensor
    drop_fraction: torch.Tensor


def moe_param_shapes(cfg: ModelConfig) -> dict:
    """The router and the expert weights. "subgrid" packs (expert, f-slice)
    on the leading dim: ``(E * f_sub, D, F / f_sub)``; the others keep
    ``(E, D, F)``."""
    m = cfg.moe
    D, E, F_ = cfg.d_model, m.n_experts, m.expert_d_ff
    if m.ep_mode == "subgrid":
        fs = m.f_sub
        return {"router": (D, E), "w1": (E * fs, D, F_ // fs),
                "w3": (E * fs, D, F_ // fs), "w2": (E * fs, F_ // fs, D)}
    return {"router": (D, E), "w1": (E, D, F_), "w3": (E, D, F_), "w2": (E, F_, D)}


def init_moe_params(generator: torch.Generator, cfg: ModelConfig,
                    dtype=torch.float32) -> dict:
    """N(0, 1/fan_in) weights, fan-in ``shape[-2]`` for the 3-d expert
    weights (the JAX initializer's; ``torch.Generator`` draws other numbers,
    so tests carry JAX's params across with ``interop``)."""
    out = {}
    for name, shape in sorted(moe_param_shapes(cfg).items()):
        in_dim = shape[-2] if len(shape) == 3 else shape[0]
        out[name] = dense_init(generator, shape, in_dim=in_dim, dtype=dtype)
    return out


def capacity(n_tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    """Slots an expert: ceil(cf * T * K / E), at least 8, a multiple of 8."""
    c = int(math.ceil(cf * n_tokens * top_k / n_experts))
    return max(8, (c + 7) // 8 * 8)


def _check_local(w: dict, cfg: ModelConfig) -> None:
    m = cfg.moe
    want = m.n_experts * (m.f_sub if m.ep_mode == "subgrid" else 1)
    if w["w1"].shape[-3] != want:
        raise ValueError(
            f"moe_ffn got {w['w1'].shape[-3]} expert slices, the config has {want}: "
            "expert weights sharded over devices come with the sharded MoE FFN of the "
            "multi-device port, ROADMAP A16.3")


def _route(xf, router, cfg: ModelConfig):
    """f32 routing of (T, D) tokens -> (gates (T, K) renormalised, eids
    (T, K), aux losses)."""
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    logits = xf.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, eids = torch.topk(probs, K, dim=-1)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=0)
    # per-expert share of the T*K choices (a comparison, not bincount: vmap)
    hits = eids.reshape(-1)[:, None] == torch.arange(E, device=xf.device)
    ce = hits.sum(dim=0, dtype=torch.float32) / (xf.shape[0] * K)
    load_balance = E * torch.sum(me * ce) * m.load_balance_loss
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * m.router_z_loss
    return gates, eids, load_balance, z_loss, hits


def _dispatch(xf, eids, hits, C: int, E: int):
    """Capacity bucketing: -> (buckets (E, C, D), flat_e, pos, keep). Pair
    (t, k) takes slot ``pos``, its rank among the pairs that chose its
    expert in token order; pairs at pos >= C are dropped."""
    K = eids.shape[-1]
    flat_e = eids.reshape(-1)                                  # (T*K,)
    # the running count of each expert's pairs, scanned along rows of
    # (E, T*K): a scan down the columns of (T*K, E), as the JAX package
    # writes it, took 50 ms a layer at 131,072 pairs on the card
    seen = torch.cumsum(hits.t().to(torch.int32).contiguous(), dim=1)
    pos = torch.gather(seen, 0, flat_e[None])[0] - 1
    keep = pos < C
    slot = torch.where(keep, flat_e * (C + 1) + pos, flat_e * (C + 1) + C)
    buf = xf.new_zeros((E * (C + 1), xf.shape[-1]))
    buf = buf.index_put((slot,), xf.repeat_interleave(K, dim=0))
    return buf.reshape(E, C + 1, -1)[:, :C], flat_e, pos, keep


def _combine(out_buf, flat_e, pos, keep, gates, T: int):
    """(E, C, D) expert outputs -> (T, D): each token's K results weighted
    by its gates; a dropped pair reads an appended zero row."""
    E, C, D = out_buf.shape
    rows = torch.cat([out_buf.reshape(E * C, D), out_buf.new_zeros((1, D))])
    tok = rows[torch.where(keep, flat_e * C + pos, E * C)]      # (T*K, D)
    tok = tok * (keep * gates.reshape(-1)).to(tok.dtype)[:, None]
    return tok.reshape(T, -1, D).sum(dim=1)


def _experts(buckets, w1, w3, w2):
    """The grouped SwiGLU over (E, C, D) buckets."""
    g = torch.einsum("ecd,edf->ecf", buckets, w1)
    u = torch.einsum("ecd,edf->ecf", buckets, w3)
    return torch.einsum("ecf,efd->ecd", F.silu(g) * u, w2)


def _full(t, E: int, fs: int, transpose: bool = False):
    """Subgrid-packed expert weights -> (E, D, F), or (E, F, D) for w2."""
    if transpose:   # w2 (E*fs, F/fs, D) -> (E, F, D)
        return t.reshape(E, -1, t.shape[-1])
    D = t.shape[-2]
    return t.reshape(E, fs, D, -1).movedim(1, 2).reshape(E, D, -1)


def moe_ffn(w: dict, x, cfg: ModelConfig):
    """x: (B, T, D) -> (out (B, T, D), MoEAux). ``w``: the router and all
    of the config's expert weights, in any of the three layouts."""
    m = cfg.moe
    _check_local(w, cfg)
    B, T_, D = x.shape
    E = m.n_experts
    xf = x.reshape(B * T_, D)
    T = xf.shape[0]
    gates, eids, load_balance, z_loss, hits = _route(xf, w["router"], cfg)
    C = capacity(T, m.top_k, E, m.capacity_factor)
    buckets, flat_e, pos, keep = _dispatch(xf, eids, hits, C, E)
    drop_fraction = 1.0 - keep.to(torch.float32).mean()
    if m.ep_mode == "subgrid":
        fs = m.f_sub
        out_buf = _experts(buckets, _full(w["w1"], E, fs), _full(w["w3"], E, fs),
                           _full(w["w2"], E, fs, transpose=True))
    else:
        out_buf = _experts(buckets, w["w1"], w["w3"], w["w2"])
    out = _combine(out_buf, flat_e, pos, keep, gates, T).reshape(B, T_, D)
    return out, MoEAux(load_balance, z_loss, drop_fraction)


def moe_ffn_dense_ref(w_full: dict, x, cfg: ModelConfig):
    """Dense masked reference (no capacity drops): every token runs its
    top-k experts exactly, (E, D, F) weights. O(E) compute: tests only."""
    m = cfg.moe
    B, T, D = x.shape
    xf = x.reshape(B * T, D)
    logits = xf.to(torch.float32) @ w_full["router"].to(torch.float32)
    gates, eids = torch.topk(torch.softmax(logits, dim=-1), m.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    g = torch.einsum("td,edf->tef", xf, w_full["w1"])
    u = torch.einsum("td,edf->tef", xf, w_full["w3"])
    y = torch.einsum("tef,efd->ted", F.silu(g) * u, w_full["w2"])
    mask = torch.zeros((xf.shape[0], m.n_experts), dtype=torch.float32, device=x.device)
    mask = mask.scatter_add(1, eids, gates)
    out = torch.einsum("te,ted->td", mask, y.to(torch.float32))
    return out.reshape(B, T, D).to(x.dtype)
