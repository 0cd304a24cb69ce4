"""Mixture-of-experts FFN with capacity buckets (port of
``repro/models/moe.py``), on one device or on a rank of the temporal
placement's mesh.

Routing in f32 (softmax, top-k, gates renormalised), GShard's aux losses,
then capacity bucketing: each (token, choice) pair takes the next slot of
its expert's bucket, ``C = capacity(T, K, E, cf)`` slots an expert; pairs
past an expert's C are dropped. The buckets run the grouped SwiGLU as
batched matmuls over the expert dim, and each token sums its K results
weighted by its gates. The three layouts of the JAX package's params are
taken (``ep_mode`` "model", "grid" and "subgrid", whose expert FFN slices
are packed on the expert dim); on one device "model" and "grid" compute
the same, and "subgrid" reassembles (E, D, F) first.

On a mesh (``ctx`` with the axes) the experts are resident, never
gathered (``sharding/specs._moe_expert_spec``), and each rank routes and
buckets its own ``T_loc`` tokens, as the JAX package does: ``C`` comes
from the rank's token count, so pairs drop per rank, and the aux losses
are the rank's (``Model.loss`` averages them over the grid). Then:

- "model": the (E, C, D) buckets all-to-all over ``model`` to the ranks
  holding their E / M experts, which run ``(E/M, M*C, D)``; the reverse
  all-to-all brings each slot home;
- "grid": the same over ``data`` (E / R experts a data row), the expert
  FFN dim sharded over ``model``: in training and prefill each rank's
  buckets circulate M hops round the ``model`` ring by ``ppermute``, the
  accumulator travelling with them, each hop adding the holder's F slice;
  at decode (``tokens_replicated``: the same tokens on every model rank)
  the slices' partial outputs are summed by a ``psum`` instead.
  ``quant_ring`` (the JAX package's ``REPRO_QUANT_RING=1``) sends the
  ring's payloads as int8 with a scale a row: the visit quantized once,
  the accumulator requantized each hop;
- "subgrid": the data all-to-all, then an ``f_sub``-fold duplicating
  all-to-all over ``model`` to the ranks holding the expert's F slices
  (rank (r, m) holds slice ``m % f_sub`` of expert ``r * M/f_sub + m //
  f_sub``), the local slice's SwiGLU, an XOR butterfly of ``log2 f_sub``
  ``ppermute`` + add steps summing the slices, and the reverse
  all-to-alls taking every ``f_sub``-th row; at decode the rank's own
  slice written into zeros and a ``psum`` over ``model``. It needs ``E /
  data * f_sub == model`` (``check_mesh``).

Every collective is differentiable (``sharding/axes``): the gradients
come back through the all-to-alls, the ring and the butterfly by their
transposes.

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

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init
from repro_torch.sharding.axes import SINGLE, AxisCtx


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


def check_mesh(cfg: ModelConfig, sizes: dict) -> None:
    """Raise a ``ValueError`` where a mesh of axis ``sizes`` (name ->
    size) cannot hold the subgrid layout: it needs ``E / data * f_sub ==
    model`` (the JAX package asserts it, ``moe.py:236``)."""
    m = cfg.moe
    if m is None or m.ep_mode != "subgrid" or not sizes.get("model"):
        return
    R, M = sizes.get("data", 1), sizes["model"]
    if (m.n_experts // R) * m.f_sub != M:
        raise ValueError(
            f"{cfg.name}: subgrid EP needs E/data*f_sub == model "
            f"({m.n_experts}/{R}*{m.f_sub} != {M})")


def _local_slices(cfg: ModelConfig, ctx: AxisCtx) -> int:
    """Expert slices a rank holds on the leading dim of w1/w3/w2."""
    m = cfg.moe
    if m.ep_mode == "subgrid":
        return 1 if ctx.model is not None else m.n_experts * m.f_sub
    ep_axis = ctx.model if m.ep_mode == "model" else ctx.data
    return m.n_experts // ctx.size(ep_axis)


def _check_local(w: dict, cfg: ModelConfig, ctx: AxisCtx) -> None:
    want = _local_slices(cfg, ctx)
    if w["w1"].shape[-3] != want:
        raise ValueError(
            f"moe_ffn got {w['w1'].shape[-3]} expert slices, this rank holds {want}: "
            "expert weights sharded over devices take the mesh's ctx (moe_ffn(..., ctx=), "
            "the temporal placement on a mesh, ROADMAP A16.3a)")


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


def _swiglu(toks, w1, w3, w2):
    """One expert slice's SwiGLU over (N, D) rows."""
    return (F.silu(toks @ w1) * (toks @ w3)) @ w2


def _q8(t):
    """Symmetric int8 with one f32 scale a row (last dim): ``amax / 127``
    (as a multiply by the f32 reciprocal, as XLA computes the JAX
    package's), 1 for a zero row."""
    tf = t.to(torch.float32)
    amax = tf.abs().amax(dim=-1, keepdim=True)
    sc = torch.where(amax > 0, amax * (1.0 / 127.0), torch.ones_like(amax))
    return torch.clamp(torch.round(tf / sc), -127, 127).to(torch.int8), sc


def _dq(q, sc, dtype):
    return (q.to(torch.float32) * sc).to(dtype)


def _ring(ctx: AxisCtx, buckets, w, quant_ring: bool):
    """The grid ring over ``model``: M hops, each adding the holder's F
    slice of the experts to the travelling accumulator, then passing
    payload and accumulator on to rank ``i + 1``."""
    M = ctx.size(ctx.model)
    perm = [(i, (i + 1) % M) for i in range(M)]
    step = functools.partial(_experts, w1=w["w1"], w3=w["w3"], w2=w["w2"])
    if not quant_ring:
        visit, acc = buckets, None
        for _ in range(M):
            y = step(visit)
            acc = y if acc is None else acc + y
            visit = ctx.ppermute(visit, ctx.model, perm)
            acc = ctx.ppermute(acc, ctx.model, perm)
        return acc
    vq, vs = _q8(buckets)
    aq, asc = _q8(torch.zeros_like(buckets))
    for _ in range(M):
        acc = _dq(aq, asc, torch.float32) + step(_dq(vq, vs, buckets.dtype)).to(torch.float32)
        aq, asc = _q8(acc)
        vq, vs, aq, asc = (ctx.ppermute(t, ctx.model, perm) for t in (vq, vs, aq, asc))
    return _dq(aq, asc, buckets.dtype)


def _ep(ctx: AxisCtx, buckets, w, cfg: ModelConfig, tokens_replicated: bool,
        quant_ring: bool):
    """"model" and "grid" EP: (E, C, D) buckets -> (E, C, D) outputs."""
    m = cfg.moe
    E, C, D = buckets.shape
    ep_axis = ctx.model if m.ep_mode == "model" else ctx.data
    R = ctx.size(ep_axis)
    E_row = E // R
    if ep_axis is not None:
        b = ctx.all_to_all(buckets.reshape(R, E_row, C, D), ep_axis, 0, 0)
        buckets = b.movedim(0, 1).reshape(E_row, R * C, D)
    grid = m.ep_mode == "grid" and ctx.model is not None
    if grid and not tokens_replicated:
        part = _ring(ctx, buckets, w, quant_ring)
    else:
        part = _experts(buckets, w["w1"], w["w3"], w["w2"])
        if grid:                          # decode: tokens replicated over model
            part = ctx.psum(part, ctx.model)
    if ep_axis is None:
        return part
    p = ctx.all_to_all(part.reshape(E_row, R, C, D).movedim(1, 0), ep_axis, 0, 0)
    return p.reshape(E, C, D)


def _subgrid(ctx: AxisCtx, buckets, w, cfg: ModelConfig, tokens_replicated: bool):
    """Subgrid EP on a mesh: (E, C, D) buckets -> (E, C, D) outputs."""
    m = cfg.moe
    E, C, D = buckets.shape
    fs = m.f_sub
    R, M = ctx.size(ctx.data), ctx.size(ctx.model)
    E_row = E // R
    check_mesh(cfg, {"data": R, "model": M})
    w1, w3, w2 = w["w1"][0], w["w3"][0], w["w2"][0]
    b = ctx.all_to_all(buckets.reshape(R, E_row, C, D), ctx.data, 0, 0)
    buckets = b.movedim(0, 1).reshape(E_row, R * C, D)
    if tokens_replicated:
        # decode: the same buckets on every model rank; each runs its own
        # (expert, slice), and the psum sums the slices and fills the rows
        mine = ctx.index(ctx.model) // fs
        own = _swiglu(buckets[mine], w1, w3, w2)
        rows = [own if e == mine else torch.zeros_like(own) for e in range(E_row)]
        part = ctx.psum(torch.stack(rows), ctx.model)
    else:
        # each expert's bucket to its f_sub slice holders
        visit = ctx.all_to_all(buckets.repeat_interleave(fs, dim=0), ctx.model, 0, 0)
        partial = _swiglu(visit.reshape(M * R * C, D), w1, w3, w2)
        k = 1
        while k < fs:                    # the XOR butterfly within each group
            partial = partial + ctx.ppermute(partial, ctx.model,
                                             [(i, i ^ k) for i in range(M)])
            k *= 2
        back = ctx.all_to_all(partial.reshape(M, R * C, D), ctx.model, 0, 0)
        part = back[::fs]                 # a group's ranks hold the same sums
    p = ctx.all_to_all(part.reshape(E_row, R, C, D).movedim(1, 0), ctx.data, 0, 0)
    return p.reshape(E, C, D)


def moe_ffn(w: dict, x, cfg: ModelConfig, *, ctx: AxisCtx = SINGLE,
            tokens_replicated: bool = False, quant_ring: bool = False):
    """x: (B, T_loc, D), this rank's tokens -> (out (B, T_loc, D), MoEAux
    of these tokens). ``w``: the router whole and this rank's expert
    slices (all of them off the mesh), in the config's layout.
    ``tokens_replicated``: decode, where the tokens are the same on every
    model rank (the grid ring and the subgrid exchange become a ``psum``);
    ``quant_ring``: int8 ring payloads (grid EP on a model axis)."""
    m = cfg.moe
    _check_local(w, cfg, ctx)
    B, T_, D = x.shape
    E = m.n_experts
    xf = x.reshape(B * T_, D)
    T = xf.shape[0]
    gates, eids, load_balance, z_loss, hits = _route(xf, w["router"], cfg)
    C = capacity(T, m.top_k, E, m.capacity_factor)
    buckets, flat_e, pos, keep = _dispatch(xf, eids, hits, C, E)
    drop_fraction = 1.0 - keep.to(torch.float32).mean()
    if m.ep_mode == "subgrid" and ctx.model is not None:
        out_buf = _subgrid(ctx, buckets, w, cfg, tokens_replicated)
    elif m.ep_mode == "subgrid":
        fs = m.f_sub
        out_buf = _experts(buckets, _full(w["w1"], E, fs), _full(w["w3"], E, fs),
                           _full(w["w2"], E, fs, transpose=True))
    else:
        out_buf = _ep(ctx, buckets, w, cfg, tokens_replicated, quant_ring)
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
