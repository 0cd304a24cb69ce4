"""Initializers (port of ``repro/models/layers.dense_init``)."""
from __future__ import annotations

import math

import torch


def dense_init(generator: torch.Generator, shape, in_dim: int,
               dtype=torch.float32, scale: float = 1.0):
    """Normal(0, scale / sqrt(in_dim)) weights drawn from ``generator``
    (on the generator's device)."""
    std = scale / math.sqrt(in_dim)
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * std).to(dtype)
