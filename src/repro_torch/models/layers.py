"""Shared layers: RMSNorm, LayerNorm, rotary embeddings, initializers (port
of ``repro/models/layers.py``), and ``checkpointed``, the port's
``jax.checkpoint``."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.kernels import ops


def func_transform_active() -> bool:
    """Whether a ``torch.func`` transform (``vmap``, ``grad``) is active
    around the caller. ``torch.utils.checkpoint`` and ``torch.autograd.grad``
    are refused under one, and torch 2.13 has no public query for it: this
    is the one place in the port that reads functorch's private state."""
    return torch._C._functorch.maybe_current_level() is not None


def checkpointed(fn, *args):
    """``fn(*args)``, rematerialized as ``jax.checkpoint`` does: under plain
    autograd (grad enabled, no ``torch.func`` transform) through the
    non-reentrant ``torch.utils.checkpoint``, so the backward keeps
    ``args`` and recomputes what ``fn`` saved; else a plain call (the
    transforms refuse the checkpoint and keep every activation)."""
    if not torch.is_grad_enabled() or func_transform_active():
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def rms_norm(x, w, eps: float = 1e-6):
    """RMSNorm over the last dim (the hand-written kernel on the card)."""
    return ops.rmsnorm(x, w, eps=eps)


def layer_norm(x, w, b, eps: float = 1e-5):
    """LayerNorm over the last dim with a bias (whisper's): f32 mean and
    variance, ``rsqrt(var + eps)``, cast back to x's dtype. jnp in the JAX
    package, so torch ops here (no kernel is owed)."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w + b).to(x.dtype)


def rope_freqs(head_dim: int, theta: float):
    """Inverse frequencies of the rotary embedding, in float64 numpy (as the
    JAX package computes them before casting to f32)."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (B, S, H, D) with D even; positions: (S,) or (B, S). Angles and
    rotation in f32, cast back to x's dtype."""
    D = x.shape[-1]
    freqs = torch.tensor(rope_freqs(D, theta), dtype=torch.float32, device=x.device)
    if positions.dim() == 1:
        ang = positions[:, None].to(torch.float32) * freqs[None, :]   # (S, D/2)
        ang = ang[None, :, None, :]
    else:
        ang = positions[..., None].to(torch.float32) * freqs
        ang = ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def dense_init(generator: torch.Generator, shape, in_dim: int,
               dtype=torch.float32, scale: float = 1.0):
    """Normal(0, scale / sqrt(in_dim)) weights drawn from ``generator``
    (on the generator's device)."""
    std = scale / math.sqrt(in_dim)
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return w.mul_(std).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype=torch.float32):
    """Normal(0, 0.02) embeddings drawn from ``generator``."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return w.mul_(0.02).to(dtype)
