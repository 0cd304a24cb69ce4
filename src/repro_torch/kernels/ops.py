"""Public kernel API (port of ``repro/kernels/ops.py``): the quantized
aggregation, RMSNorm, flash attention (forward) and decode attention.

Dispatch is by device only: CUDA tensors launch the hand-written kernel,
CPU tensors take its plain version (``kernels/{quant_aggregate,rmsnorm,
flash_attention,decode_attention}``). There is no environment switch. ``calls`` counts real calls (the port has no trace),
so a run of R int8 rounds counts R.

``quant_aggregate`` goes through the custom op ``repro_torch::quant_aggregate``,
whose vmap rule turns a campaign's vmapped call (``torch.func.vmap`` over
the lanes) into ONE ``(S, C, N)`` launch of the kernel.

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


@torch.library.custom_op("repro_torch::quant_aggregate", mutates_args=())
def _quant_agg_op(qdeltas: torch.Tensor, scales: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    return _qa.quant_aggregate(qdeltas, scales, weights)


@_quant_agg_op.register_fake
def _(qdeltas, scales, weights):
    return qdeltas.new_empty(qdeltas.shape[:-2] + qdeltas.shape[-1:],
                             dtype=torch.float32)


def _quant_agg_vmap(info, in_dims, qdeltas, scales, weights):
    """vmap rule: the mapped dim leads, an unmapped input is broadcast to
    it, and lanes already there fold in, so the whole batch is one (S, C, N)
    launch (lane s bitwise its (C, N) launch)."""
    def lead(t, d):
        t = t.movedim(d, 0) if d is not None else t.expand(info.batch_size, *t.shape)
        return t.contiguous()
    q, s, w = (lead(t, d) for t, d in zip((qdeltas, scales, weights), in_dims))
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


def rmsnorm(x, w, eps: float = 1e-6):
    """RMSNorm over the last dim in f32, output in x's dtype."""
    return _rms.rmsnorm(x, w, eps)


def flash_attention(q, k, v, q_offset: int = 0, causal: bool = True,
                    scale: float | None = None):
    """Flash attention, forward only. q (B,Sq,H,Dk), k (B,Sk,KV,Dk),
    v (B,Sk,KV,Dv) -> (B,Sq,H,Dv) in q's dtype. ``q_offset`` is the global
    position of q row 0. (The autograd backward comes with the training
    slice, ROADMAP A15.)"""
    out, _ = _fa.flash_attention_fwd(q, k, v, q_offset, causal, scale)
    return out


def decode_attention(q, k, v, length, *, scale: float | None = None,
                     combine: bool = True):
    """One-token attention over a KV cache. ``combine=True`` -> (B,H,Dv) in
    q's dtype; ``combine=False`` -> the unnormalised f32 (o, m, l)."""
    o, m, l = _da.decode_attention_fwd(q, k, v, length, scale)
    if combine:
        return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return o, m, l
