"""The int8 send and its server-side mean, in plain PyTorch.

A send is each leaf of a client's update, raveled and zero-padded to whole
blocks of 256 values, quantized block by block: the scale is the block's
largest magnitude over 127 (1 for an all-zero block), each value divided
by it and rounded half to even into [-127, 127]. The server dequantizes
every send and takes the mean weighted by the clients' weights.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 256


def roundtrip(x: torch.Tensor, lead: int = 0) -> torch.Tensor:
    """One leaf (f32) through quantize and dequantize: what the server
    reads of it, in its shape. ``lead`` leading dims (clients) are sent
    each on its own."""
    flat = x.reshape(*x.shape[:lead], -1)
    n = flat.shape[-1]
    pad = (-n) % BLOCK
    blocks = (F.pad(flat, (0, pad)) if pad else flat).reshape(*x.shape[:lead], -1, BLOCK)
    amax = blocks.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(blocks / scale), -127, 127)
    return (q * scale).reshape(*x.shape[:lead], -1)[..., :n].reshape(x.shape)
