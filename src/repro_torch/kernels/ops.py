"""Public kernel API (port of ``repro/kernels/ops.py``): the quantized
aggregation, RMSNorm, flash attention and decode attention.

Dispatch is by device only: CUDA tensors launch the hand-written kernel,
CPU tensors take its plain version (``kernels/{quant_aggregate,rmsnorm,
flash_attention,decode_attention}``). There is no environment switch. ``calls`` counts real calls (the port has no trace),
so a run of R int8 rounds counts R.

``quant_aggregate`` goes through the custom op ``repro_torch::quant_aggregate``,
whose vmap rule turns a campaign's vmapped call (``torch.func.vmap`` over
the lanes) into ONE ``(S, C, N)`` launch of the kernel.

``rmsnorm`` and ``flash_attention`` are differentiable: each is a
``torch.autograd.Function`` whose forward launches the kernel (or, on the
CPU, takes its plain version), whose backward is the gradient (the JAX
package has no backward kernel): B2's in torch ops (``rmsnorm.backward``),
B3's a hand-written kernel where ``flash_attention.bwd_plan`` routes it
(bf16 at head dims 64 and 128), else torch ops (``plain_bwd``; f32, MLA's
dims, every CPU call). Each backward runs under a layer span,
``rmsnorm.bwd`` and ``attn.bwd``, with its shape after the vmap fold. The
vmap rule folds the vmapped dim into the kernel's rows or batch, so they
run under the FL rounds' ``vmap(grad_and_value(...))``. (A
``torch.library.custom_op``'s autograd rule is refused under
``torch.func`` transforms: it does not override ``setup_context``.)
Under ``torch.utils.checkpoint`` (an LM client's rematerialized step)
their forward runs again in the backward's recompute:
``setup_context`` keeps only the saved tensors and Python scalars, so the
second forward is the first at the same shapes, gives its bits, and its
launch is counted as the first's is.

Counters are scoped: ``quant_agg_scope()`` pushes a fresh frame, increments
land on every active frame, and ``quant_agg_stats()`` snapshots the innermost
one, so two runs in one process never bleed counts into each other.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import quant_aggregate as _qa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.telemetry.recorder import layer_span

# The fused path is the kernel's plain version: one accumulation pass in
# client order with no (C, N) f32 intermediate.
_quant_agg_fused = _qa.plain


def _quant_agg_frame() -> dict:
    # batched_fallbacks: the JAX package's count of vmapped calls that left
    # the kernel; the port's vmap rule launches it, so this stays 0
    return {"calls": 0, "batched_fallbacks": 0, "last_impl": None}


_QUANT_AGG_FRAMES = [_quant_agg_frame()]


def quant_agg_stats() -> dict:
    """Snapshot of the innermost active scope's dispatch counters (the
    process-wide frame when no ``quant_agg_scope`` is open)."""
    return dict(_QUANT_AGG_FRAMES[-1])


def reset_quant_agg_stats() -> None:
    """Zero the innermost active scope's counters."""
    _QUANT_AGG_FRAMES[-1].update(_quant_agg_frame())


@contextlib.contextmanager
def quant_agg_scope():
    """A fresh counter frame for one run. Yields the live frame dict;
    increments inside the scope also reach every enclosing frame."""
    frame = _quant_agg_frame()
    _QUANT_AGG_FRAMES.append(frame)
    try:
        yield frame
    finally:
        _QUANT_AGG_FRAMES.remove(frame)


def _quant_agg_dequant_first(qdeltas, scales, weights):
    """Reference path: materialize the whole (C, N) f32 dequant, then run
    the same client-ordered weighted accumulation over it. Per-client
    arithmetic is (q * scale) * weight in the same order, so the result is
    bit for bit the fused path's; only the memory traffic differs."""
    C, N = qdeltas.shape
    nblocks = scales.shape[-1]
    d = qdeltas.to(torch.float32).reshape(C, nblocks, N // nblocks)
    d = d * scales[..., None]
    out = torch.zeros((nblocks, N // nblocks), dtype=torch.float32,
                      device=qdeltas.device)
    for c in range(C):
        out = out + d[c] * weights[c]
    return out.reshape(N)


def _lead(t, d, n):
    """The vmapped dim of ``t`` moved to the front, or an unmapped ``t``
    broadcast to the batch size ``n``."""
    return t.movedim(d, 0) if d is not None else t.expand(n, *t.shape)


@torch.library.custom_op("repro_torch::quant_aggregate", mutates_args=())
def _quant_agg_op(qdeltas: torch.Tensor, scales: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    return _qa.quant_aggregate(qdeltas, scales, weights)


@_quant_agg_op.register_fake
def _(qdeltas, scales, weights):
    if qdeltas.device.type == "meta":       # a dry run: the wrapper's meta branch records
        return _qa.quant_aggregate(qdeltas, scales, weights)
    return qdeltas.new_empty(qdeltas.shape[:-2] + qdeltas.shape[-1:],
                             dtype=torch.float32)


def _quant_agg_vmap(info, in_dims, qdeltas, scales, weights):
    """vmap rule: the mapped dim leads, an unmapped input is broadcast to
    it, and lanes already there fold in, so the whole batch is one (S, C, N)
    launch (lane s bitwise its (C, N) launch)."""
    q, s, w = (_lead(t, d, info.batch_size).contiguous()
               for t, d in zip((qdeltas, scales, weights), in_dims))
    outer = q.shape[:-2]
    out = _quant_agg_op(q.reshape(-1, *q.shape[-2:]), s.reshape(-1, *s.shape[-2:]),
                        w.reshape(-1, w.shape[-1]))
    return out.reshape(*outer, out.shape[-1]), 0


_quant_agg_op.register_vmap(_quant_agg_vmap)


def quant_aggregate(qdeltas, scales, weights):
    """-> (N,) f32: ``sum_c weights[c] * dequant(qdeltas[c])``: the kernel
    for CUDA tensors, its plain version for CPU tensors; under a vmap over
    lanes, one launch for all of them."""
    impl = "cuda" if qdeltas.is_cuda else "plain"
    for frame in _QUANT_AGG_FRAMES:
        frame["calls"] += 1
        frame["last_impl"] = impl
    return _quant_agg_op(qdeltas, scales, weights)


def quantize_blockwise(x, block: int = 256):
    """Symmetric int8 block quantization (see ``ref.quantize_blockwise_ref``)."""
    return _ref.quantize_blockwise_ref(x, block=block)


def _dense(t):
    """``t`` contiguous and, on the card, 16-byte aligned (the kernels load
    16-byte vectors; a view into a larger tensor may start anywhere). A meta
    tensor's data pointer is its byte offset, so a dry run copies where the
    card would."""
    t = t.contiguous()
    if t.device.type in ("cuda", "meta") and t.data_ptr() % 16:
        t = t.clone()
    return t


class _RMSNorm(torch.autograd.Function):
    """B2 under autograd and ``torch.func``."""

    @staticmethod
    def forward(x, w, eps):
        return _rms.rmsnorm(_dense(x), _dense(w), eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, eps = inputs
        ctx.save_for_backward(x, w)
        ctx.eps = eps

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with layer_span("rmsnorm.bwd", x.device) as sp:
            if sp is not None:
                D = x.shape[-1]
                sp.attrs["shape"] = (x.numel() // D, D, x.element_size(), w.element_size())
            dx, dw = _rms.backward(x, w, g, ctx.eps)
        return dx, dw, None

    @staticmethod
    def vmap(info, in_dims, x, w, eps):
        """The vmapped dim folds into the rows: one launch. A vmapped ``w``
        (a client's own weights, after its first local step) launches once
        per index."""
        n = info.batch_size
        x = _lead(x, in_dims[0], n)
        if in_dims[1] is None:
            out = _RMSNorm.apply(x.reshape(-1, x.shape[-1]), w, eps)
            return out.reshape(x.shape), 0
        w = w.movedim(in_dims[1], 0)
        return torch.stack([_RMSNorm.apply(x[i], w[i], eps) for i in range(n)]), 0


def rmsnorm(x, w, eps: float = 1e-6):
    """RMSNorm over the last dim in f32, output in x's dtype;
    differentiable, and batched under ``torch.func.vmap``."""
    return _RMSNorm.apply(x, w, eps)


class _FlashAttention(torch.autograd.Function):
    """B3 under autograd and ``torch.func``: (out, lse), lse not
    differentiated."""

    @staticmethod
    def forward(q, k, v, q_offset, causal, scale):
        return _fa.flash_attention_fwd(_dense(q), _dense(k), _dense(v), q_offset,
                                       causal, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, q_offset, causal, scale = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (q_offset, causal, scale)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        with layer_span("attn.bwd", q.device) as sp:
            if sp is not None:
                (B, Sq, H, Dk), (_, Sk, KV, Dv) = q.shape, v.shape
                q_offset, causal, _ = ctx.args
                sp.attrs["shape"] = (B, Sq, Sk, H, KV, Dk, Dv, causal, q_offset,
                                     q.element_size())
            dq, dk, dv = _FlashAttentionBwd.apply(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, q_offset, causal, scale):
        """The vmapped dim folds into B: one launch."""
        n = info.batch_size

        def fold(t, d):
            t = _lead(t, d, n)
            return t.reshape(n * t.shape[1], *t.shape[2:])
        out, lse = _FlashAttention.apply(fold(q, in_dims[0]), fold(k, in_dims[1]),
                                         fold(v, in_dims[2]), q_offset, causal, scale)
        return ((out.reshape(n, -1, *out.shape[1:]), lse.reshape(n, -1, *lse.shape[1:])),
                (0, 0))


class _FlashAttentionBwd(torch.autograd.Function):
    """B3's backward as a function of its own: under ``vmap(grad(...))``
    autograd calls ``_FlashAttention.backward`` on batched tensors, and
    this vmap rule folds the vmapped dim into B (one launch), as the
    forward's does. It has no backward of its own: B3 is differentiated
    once."""

    @staticmethod
    def forward(q, k, v, out, lse, dout, q_offset, causal, scale):
        return _fa.flash_attention_bwd(*map(_dense, (q, k, v, out, lse, dout)), q_offset,
                                       causal, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, q, k, v, out, lse, dout, q_offset, causal, scale):
        n = info.batch_size

        def fold(t, d):
            t = _lead(t, d, n)
            return t.reshape(n * t.shape[1], *t.shape[2:])
        grads = _FlashAttentionBwd.apply(*map(fold, (q, k, v, out, lse, dout), in_dims[:6]),
                                         q_offset, causal, scale)
        return tuple(g.reshape(n, -1, *g.shape[1:]) for g in grads), (0, 0, 0)


def flash_attention(q, k, v, q_offset: int = 0, causal: bool = True,
                    scale: float | None = None):
    """Flash attention. q (B,Sq,H,Dk), k (B,Sk,KV,Dk), v (B,Sk,KV,Dv) ->
    (B,Sq,H,Dv) in q's dtype. ``q_offset`` is the global position of q row
    0 (a Python int). Differentiable in q, k and v, and batched under
    ``torch.func.vmap``."""
    out, _ = _FlashAttention.apply(q, k, v, int(q_offset), bool(causal), scale)
    return out


def decode_attention(q, k, v, length, *, scale: float | None = None,
                     combine: bool = True):
    """One-token attention over a KV cache. ``combine=True`` -> (B,H,Dv) in
    q's dtype; ``combine=False`` -> the unnormalised f32 (o, m, l)."""
    o, m, l = _da.decode_attention_fwd(q, k, v, length, scale)
    if combine:
        return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return o, m, l
