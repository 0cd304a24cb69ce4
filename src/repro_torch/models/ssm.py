"""State-space and recurrent blocks: Mamba (the S6 selective scan) and
xLSTM's mLSTM and sLSTM (port of ``repro/models/ssm.py``).

Mamba scans in chunks of Q steps, the chunks threaded one after another
with a (B, d_inner, N) carry. Within a chunk the recurrence
``h_t = a_t h_{t-1} + b_t`` is the JAX package's associative scan with the
combine ``(a_l a_r, b_l a_r + b_r)``; torch has none, so it runs here as a
log-step (Hillis-Steele) doubling over Q: ceil(log2 Q) rounds of
elementwise products on shifted slices, which ``torch.func.vmap`` and
``grad_and_value`` (the FL rounds' transforms) take as they come. The
decay factors ``a_t = exp(dt_t A)`` are in (0, 1], so no partial product
overflows. The mLSTM runs chunkwise (masked attention within a chunk, the
decayed matrix memory across chunks); the sLSTM is sequential over time,
one step of small ops a token, as in the xLSTM paper.

No kernel: the JAX package computes all of this in jnp. On a mesh
(``ctx`` with a ``model`` axis) ``mamba_forward`` runs the JAX function's
two sharded branches: the sequence-sharded scan of a prefill (the conv's
boundary rows from the left neighbour, the local scan from zero, the
shards' ``(h_last, sum dt A)`` all-gathered and folded left into each
shard's true start state, and a correction scan with zero inputs that
adds ``C_t e^{cum} h0``), and the tensor-parallel decode (``tp``: the
rank's block of ``d_inner``, ``x_proj``'s and ``out_proj``'s products
summed over ``model``). The mLSTM and sLSTM take no ctx: xlstm-125m runs
whole sequences on every rank.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import checkpointed
from repro_torch.sharding.axes import SINGLE, AxisCtx

# ---------------------------------------------------------------------------
# Mamba (S6)
# ---------------------------------------------------------------------------


class MambaState(NamedTuple):
    """h: (B, d_inner, N) f32 scan state; conv: (B, d_conv - 1, d_inner)
    the last inputs of the causal conv, in the activations' dtype."""
    h: torch.Tensor
    conv: torch.Tensor


def mamba_dims(cfg: ModelConfig):
    """(d_inner, dt_rank, d_state, d_conv); dt_rank ``d_model // 16`` when
    the config leaves it 0."""
    s = cfg.ssm
    d_inner = int(s.expand * cfg.d_model)
    dt_rank = s.dt_rank or max(1, cfg.d_model // 16)
    return d_inner, dt_rank, s.d_state, s.d_conv


def mamba_param_shapes(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    d_inner, dt_rank, N, d_conv = mamba_dims(cfg)
    return {
        "in_proj_x": (D, d_inner),
        "in_proj_z": (D, d_inner),
        "conv_w": (d_conv, d_inner),
        "conv_b": (d_inner,),
        "x_proj": (d_inner, dt_rank + 2 * N),
        "dt_proj": (dt_rank, d_inner),
        "dt_bias": (d_inner,),
        "A_log": (d_inner, N),
        "D_skip": (d_inner,),
        "out_proj": (d_inner, D),
    }


def mamba_chunk_len(cfg: ModelConfig, B: int, S: int) -> int:
    """The scan's chunk: ``min(chunk, S, budget)`` stepped down until it
    divides S, the budget keeping the (B, Q, d_inner, N) f32 transient near
    128 MB (Q = 16 at jamba's d_inner 16,384 and N 16 for B = 8)."""
    d_inner, _, N, _ = mamba_dims(cfg)
    budget = max(1, (32 * 1024 * 1024) // max(1, B * d_inner * N))
    Q = min(cfg.ssm.chunk, S, budget)
    while S % Q:
        Q -= 1
    return Q


def _linear_scan(a, b):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` (from h = 0) along dim
    1 -> (prod a, h): log-step doubling, each round combining every step
    with the one ``d`` before it."""
    Q, d = a.shape[1], 1
    while d < Q:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return a, b


def _mamba_chunk(h0, xc, dtc, Bc, Cc, A):
    """One chunk of the selective scan. h0: (B, d, N); xc, dtc: (B, Q, d);
    Bc, Cc: (B, Q, N); A: (d, N). -> (h at the chunk's end, y (B, Q, d))."""
    a = torch.exp(dtc[..., None] * A[None, None])            # (B,Q,d,N) in (0,1]
    b = torch.einsum("bqd,bqn->bqdn", dtc * xc, Bc)
    aa, bb = _linear_scan(a, b)
    h_all = bb + aa * h0[:, None]
    y = torch.einsum("bqdn,bqn->bqd", h_all, Cc)
    return h_all[:, -1], y


def _check_local(w: dict, cfg: ModelConfig, ctx: AxisCtx, tp: bool) -> None:
    """The mixer's inner width: the config's, or under ``tp`` on a model
    axis the rank's block of it."""
    d_inner, got = mamba_dims(cfg)[0], w["in_proj_x"].shape[-1]
    sharded = tp and ctx.model is not None
    want = d_inner // ctx.size(ctx.model) if sharded else d_inner
    if got != want or (sharded and d_inner % ctx.size(ctx.model)):
        raise ValueError(
            f"mamba_forward got {got} inner channels, want {want} of the config's "
            f"{d_inner}: a rank's block of the channels runs only in the tensor-parallel "
            "decode on a mesh (ctx with a model axis and tp=True; ROADMAP A16.3b), and a "
            "model axis must divide them")


def _scan(h, xif, dt, Bmat, Cmat, A, Q: int):
    """The chunked scan from ``h`` -> (the final h, y (B, S, d))."""
    ys = []
    for lo in range(0, xif.shape[1], Q):
        h, y = checkpointed(_mamba_chunk, h, xif[:, lo:lo + Q], dt[:, lo:lo + Q],
                            Bmat[:, lo:lo + Q], Cmat[:, lo:lo + Q], A)
        ys.append(y)
    return h, torch.cat(ys, dim=1)


def _handoff(ctx: AxisCtx, h_last, dt, A):
    """The cross-shard state handoff: every shard's ``(h_last, sum_t dt_t
    A)`` all-gathered over ``model`` and folded left, ``h <- exp(sum dt A)
    h + h_last`` (the decay is in [0, 1], so an underflow to 0 leaves the
    fold finite) -> (this shard's true start state, the global final
    state)."""
    summ = torch.stack([h_last, dt.sum(dim=1)[..., None] * A[None]])       # (2, B, d, N)
    every = ctx.all_gather(summ[None], ctx.model, axis=0)                    # (M, 2, B, d, N)
    h_run, starts = torch.zeros_like(h_last), []
    for j in range(every.shape[0]):
        starts.append(h_run)
        h_run = torch.exp(every[j, 1]) * h_run + every[j, 0]
    return starts[ctx.index(ctx.model)], h_run


def mamba_forward(w: dict, x, cfg: ModelConfig, state: MambaState | None = None, *,
                  ctx: AxisCtx = SINGLE, tp: bool = False):
    """x: (B, S, D) -> (y (B, S, D), the final MambaState). The scan in f32.

    The causal depthwise conv is a sum of ``d_conv`` shifted products over
    the previous inputs (``state.conv``, zeros from a fresh start) and x;
    dt = softplus(x_proj's dt columns @ dt_proj + dt_bias), A = -exp(A_log),
    then ``y = C h + D_skip x``, gated by silu(z). Each chunk step is
    ``checkpointed``, as the JAX package remats it: under plain autograd the
    backward keeps each chunk's (B, d_inner, N) carry and not the doubling's
    (B, Q, d_inner, N) intermediates.

    On a mesh (``ctx.model`` set):
    - sequence-sharded (no ``state``, not ``tp``): x is the rank's rows at
      offset ``index(model) * S``; the conv's ``d_conv - 1`` boundary rows
      come from the left neighbour (zeros on rank 0), each shard scans from
      zero, ``_handoff`` gives it its true start state and a scan with zero
      inputs from that state adds its contribution. The returned ``h`` is
      the global final state (every rank's the same), ``conv`` the rank's
      own last rows (the last rank's are the sequence's);
    - ``tp`` (decode): the weights and the state hold the rank's block of
      ``d_inner``; ``x_proj``'s and ``out_proj``'s products are summed over
      ``model``."""
    _check_local(w, cfg, ctx, tp)
    B, S, D = x.shape
    _, dt_rank, N, d_conv = mamba_dims(cfg)
    Q = mamba_chunk_len(cfg, B, S)
    split = ctx.model is not None and not tp and state is None
    psum = tp and ctx.model is not None

    xi = x @ w["in_proj_x"]
    z = x @ w["in_proj_z"]
    d_loc = xi.shape[-1]
    if state is not None:
        prev = state.conv.to(xi.dtype)
    elif split:
        M = ctx.size(ctx.model)
        prev = ctx.ppermute(xi[:, -(d_conv - 1):], ctx.model, [(i, i + 1) for i in range(M - 1)])
    else:
        prev = xi.new_zeros((B, d_conv - 1, d_loc))
    xpad = torch.cat([prev, xi], dim=1)
    conv = sum(xpad[:, i:i + S] * w["conv_w"][i][None, None] for i in range(d_conv))
    xi = F.silu(conv + w["conv_b"])
    new_conv = xpad[:, -(d_conv - 1):]

    proj = (xi @ w["x_proj"]).to(torch.float32)
    if psum:
        proj = ctx.psum(proj, ctx.model)
    dt = F.softplus(proj[..., :dt_rank] @ w["dt_proj"].to(torch.float32)
                    + w["dt_bias"].to(torch.float32))        # (B, S, d)
    Bmat = proj[..., dt_rank:dt_rank + N]
    Cmat = proj[..., dt_rank + N:]
    A = -torch.exp(w["A_log"].to(torch.float32))

    xif = xi.to(torch.float32)
    h = (xif.new_zeros((B, d_loc, N)) if state is None
         else state.h.to(torch.float32))
    h, y = _scan(h, xif, dt, Bmat, Cmat, A, Q)
    if split:
        h0, h = _handoff(ctx, h, dt, A)
        y = y + _scan(h0, torch.zeros_like(xif), dt, Bmat, Cmat, A, Q)[1]
    y = y + xif * w["D_skip"].to(torch.float32)
    y = y.to(x.dtype) * F.silu(z)
    out = y @ w["out_proj"]
    if psum:
        out = ctx.psum(out, ctx.model)
    return out, MambaState(h.to(torch.float32), new_conv.to(x.dtype))


def mamba_decode(w: dict, x, cfg: ModelConfig, state: MambaState, *,
                 ctx: AxisCtx = SINGLE, tp: bool = False):
    """One token. x: (B, 1, D) -> (y, the next MambaState); under ``tp``
    on a model axis the state holds the rank's channels."""
    return mamba_forward(w, x, cfg, state=state, ctx=ctx, tp=tp)


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (chunkwise-parallel) and sLSTM (sequential)
# ---------------------------------------------------------------------------


class MLSTMState(NamedTuple):
    """C: (B, H, dv, dk) matrix memory; n: (B, H, dk) normaliser; m: (B, H)
    max-stabiliser; all f32."""
    C: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor


class SLSTMState(NamedTuple):
    """c, n, h, m: (B, d) f32."""
    c: torch.Tensor
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor


def xlstm_dims(cfg: ModelConfig):
    """(d_in, heads, head dim): the mLSTM's up-projected width and its
    split over the config's heads (1536, 4, 384 at xlstm-125m)."""
    d_in = int(cfg.ssm.proj_factor * cfg.d_model)
    H = cfg.n_heads
    return d_in, H, d_in // H


def mlstm_param_shapes(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    d_in, H, _ = xlstm_dims(cfg)
    return {
        "up_proj": (D, 2 * d_in),
        "wq": (d_in, d_in),
        "wk": (d_in, d_in),
        "wv": (d_in, d_in),
        "wif": (d_in, 2 * H),        # input and forget gate pre-activations
        "o_norm": (d_in,),
        "down_proj": (d_in, D),
    }


def slstm_param_shapes(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    F_ = int(cfg.ssm.proj_factor * D)
    return {
        "wx": (D, 4 * D),            # i, f, z, o from the input
        "rh": (D, 4 * D),            # recurrent
        "b": (4 * D,),
        "ff1": (D, F_),
        "ff2": (F_, D),
    }


def _mlstm_chunk(C, n, mprev, qc, kc, vc, lic, lfc):
    """One chunk: (B, Q, H, *) inputs -> (C, n, m at the chunk's end, y
    (B, Q, H, dh)). The order of the stabiliser's max, the ``|den|`` and
    the ``max(den, exp(-m))`` is the JAX package's."""
    Q = qc.shape[1]
    lf_cum = torch.cumsum(lfc, dim=1)                         # (B,Q,H)
    a = lf_cum[:, :, None] - lf_cum[:, None, :] + lic[:, None, :]
    qpos = torch.arange(Q, device=qc.device)
    causal = qpos[:, None] >= qpos[None, :]
    a = torch.where(causal[None, :, :, None], a, -1e30)       # (B,Q,Q,H)
    inter_m = mprev[:, None] + lf_cum                         # (B,Q,H)
    intra_m = a.amax(dim=2)
    m_t = torch.maximum(inter_m, intra_m)
    wgt = torch.exp(a - m_t[:, :, None])
    qf, kf, vf = qc.to(torch.float32), kc.to(torch.float32), vc.to(torch.float32)
    s = torch.einsum("bqhd,bshd->bqsh", qf, kf)
    sw = s * wgt
    intra_num = torch.einsum("bqsh,bshd->bqhd", sw, vf)
    intra_den = sw.sum(dim=2)
    decay = torch.exp(inter_m - m_t)
    inter_num = torch.einsum("bqhd,bhed->bqhe", qf, C)
    inter_den = torch.einsum("bqhd,bhd->bqh", qf, n)
    num = intra_num + inter_num * decay[..., None]
    den = torch.abs(intra_den + inter_den * decay)
    y = num / torch.maximum(den, torch.exp(-m_t))[..., None]
    m_end = m_t[:, -1]
    wk = torch.exp(lf_cum[:, -1:, :] - lf_cum + lic - m_end[:, None])
    carry = torch.exp(mprev + lf_cum[:, -1] - m_end)
    C_new = C * carry[..., None, None] + torch.einsum("bsh,bshd,bshe->bhde", wk, vf, kf)
    n_new = n * carry[..., None] + torch.einsum("bsh,bshd->bhd", wk, kf)
    return C_new, n_new, m_end, y


def mlstm_forward(w: dict, x, cfg: ModelConfig, state: MLSTMState | None = None):
    """Chunkwise-parallel mLSTM. x: (B, S, D) -> (y, MLSTMState).

    Exponential-gated linear attention with a matrix memory (xLSTM eq.
    19-27): within a chunk masked attention, across chunks the decayed
    memory; a fresh state starts from C = 0, n = 0, m = -1e30."""
    B, S, D = x.shape
    d_in, H, dh = xlstm_dims(cfg)
    Q = min(cfg.ssm.chunk, S)
    while S % Q:
        Q -= 1
    u, z = torch.chunk(x @ w["up_proj"], 2, dim=-1)           # (B,S,d_in)
    q = (u @ w["wq"]).reshape(B, S, H, dh) / math.sqrt(dh)
    k = (u @ w["wk"]).reshape(B, S, H, dh) / math.sqrt(dh)
    v = (u @ w["wv"]).reshape(B, S, H, dh)
    gates = (u @ w["wif"]).to(torch.float32)                  # (B,S,2H)
    logi = gates[..., :H]
    logf = F.logsigmoid(gates[..., H:])
    if state is None:
        C = x.new_zeros((B, H, dh, dh), dtype=torch.float32)
        n = x.new_zeros((B, H, dh), dtype=torch.float32)
        m = x.new_full((B, H), -1e30, dtype=torch.float32)
    else:
        C, n, m = state
    ys = []
    for lo in range(0, S, Q):
        sl = slice(lo, lo + Q)
        C, n, m, y = _mlstm_chunk(C, n, m, q[:, sl], k[:, sl], v[:, sl], logi[:, sl],
                                  logf[:, sl])
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(B, S, d_in).to(x.dtype)
    y = y * w["o_norm"]
    y = y * F.silu(z)
    return y @ w["down_proj"], MLSTMState(C, n, m)


def slstm_forward(w: dict, x, cfg: ModelConfig, state: SLSTMState | None = None):
    """Sequential sLSTM with exponential gating, then its GELU FFN (tanh
    form, ``jax.nn.gelu``'s default). x: (B, S, D) -> (y, SLSTMState)."""
    B, S, D = x.shape
    if state is None:
        z0 = x.new_zeros((B, D), dtype=torch.float32)
        state = SLSTMState(z0, z0, z0, x.new_full((B, D), -1e30, dtype=torch.float32))
    c, n, h, m = state
    wx = (x @ w["wx"]).to(torch.float32)                      # (B,S,4D)
    rh, bias = w["rh"].to(torch.float32), w["b"].to(torch.float32)
    hs = []
    for t in range(S):
        pre = wx[:, t] + h @ rh + bias
        i_, f_, z_, o_ = torch.chunk(pre, 4, dim=-1)
        logf = F.logsigmoid(f_)
        m_new = torch.maximum(logf + m, i_)
        i_g = torch.exp(i_ - m_new)
        f_g = torch.exp(logf + m - m_new)
        c = f_g * c + i_g * torch.tanh(z_)
        n = f_g * n + i_g
        h = torch.sigmoid(o_) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    hseq = torch.stack(hs, dim=1).to(x.dtype)                 # (B,S,D)
    y = F.gelu(hseq @ w["ff1"], approximate="tanh") @ w["ff2"]
    return y, SLSTMState(c, n, h, m)
