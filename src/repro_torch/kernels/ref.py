"""Plain PyTorch oracles for the quantized aggregation (port of the quant
half of ``repro/kernels/ref.py``)."""
from __future__ import annotations

import torch


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
