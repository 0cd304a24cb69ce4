"""Param dict <-> (N,) flat packing for the quant_aggregate kernel layout
(port of ``repro/core/packing.py``).

Each leaf is raveled in the JAX layout the params keep (HWIO conv kernels,
``(in, out)`` dense weights) and zero-padded to a whole number of
quantization blocks; the padded leaves are concatenated in sorted-key order,
which is ``jax.tree.leaves`` order for a dict. Both rules are what make the
int8 stream match the JAX package's value for value.

Per-leaf padding keeps every quantization block inside one leaf. Every
function takes optional leading dims (a client dim): a ``(C, ...)`` leaf
packs to ``(C, N)``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref as kref

QBLOCK = 256   # quantization block


class PackedDelta(NamedTuple):
    """A block-quantized flat delta: what crosses the simulated network.

    ``q``: (..., N) int8 quantized values (N a multiple of the block size);
    ``scale``: (..., N // qblock) f32 per-block dequant scales.
    """
    q: torch.Tensor
    scale: torch.Tensor


def _padded_size(n: int, qblock: int) -> int:
    return n + (-n) % qblock


def _leaves(tree: dict):
    return [tree[k] for k in sorted(tree)]


def packed_size(template: dict, qblock: int = QBLOCK) -> tuple[int, int]:
    """(N, n_blocks) of the packed representation of ``template``."""
    n = sum(_padded_size(leaf.numel(), qblock) for leaf in _leaves(template))
    return n, n // qblock


def leaf_spans(template: dict, qblock: int = QBLOCK) -> dict:
    """key -> (start, stop) of its zero-padded slice of the packed layout."""
    out, off = {}, 0
    for k in sorted(template):
        stop = off + _padded_size(template[k].numel(), qblock)
        out[k] = (off, stop)
        off = stop
    return out


def packed_nbytes(template: dict, qblock: int = QBLOCK) -> int:
    """Wire bytes of one packed delta: 1 byte per int8 value + 4 bytes per
    f32 block scale."""
    n, n_blocks = packed_size(template, qblock)
    return n + 4 * n_blocks


def pack_tree(tree: dict, qblock: int = QBLOCK, lead: int = 0):
    """Flatten to (*lead_dims, N) f32, zero-padding each leaf to whole
    blocks. ``lead`` is the number of leading (client) dims to keep."""
    pieces = []
    for leaf in _leaves(tree):
        flat = leaf.reshape(*leaf.shape[:lead], -1).to(torch.float32)
        pad = (-flat.shape[-1]) % qblock
        pieces.append(F.pad(flat, (0, pad)) if pad else flat)
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=-1)


QUANT_CHUNK = 1 << 24   # values a chunk of ``quantize_tree`` takes to f32 at once


def quantize_tree(tree: dict, qblock: int = QBLOCK, lead: int = 0,
                  out: PackedDelta | None = None) -> PackedDelta:
    """Block-quantize a delta dict into the kernel's packed layout: bitwise
    ``quantize_blockwise_ref(pack_tree(tree))``, without its (..., N) f32
    copy. Every block lies inside one leaf (per-leaf padding), so each leaf
    is quantized on its own, in chunks of whole blocks of at most
    ``QUANT_CHUNK`` values, straight into its slice of the (..., N) int8
    row and the (..., N / qblock) scale row: the f32 copies and the
    quantizer's temporaries never exceed a chunk's (an LM's delta runs to
    billions of values). ``out``: the rows to write (views of a larger
    matrix, say); else new ones."""
    leaves = _leaves(tree)
    lead_shape = leaves[0].shape[:lead]
    if out is None:
        n, n_blocks = packed_size({k: v[(0,) * lead] for k, v in tree.items()}, qblock)
        # new_empty of a leaf: under a campaign's vmap the rows carry its lanes
        out = PackedDelta(leaves[0].new_empty((*lead_shape, n), dtype=torch.int8),
                          leaves[0].new_empty((*lead_shape, n_blocks), dtype=torch.float32))
    q, scale = out
    off = 0
    step = max(qblock, QUANT_CHUNK // qblock * qblock)
    for leaf in leaves:
        flat = leaf.reshape(*lead_shape, -1)
        size = flat.shape[-1]
        for lo in range(0, size, step):
            x = flat[..., lo:lo + step].to(torch.float32)
            pad = (-x.shape[-1]) % qblock
            qc, sc = kref.quantize_blockwise_ref(F.pad(x, (0, pad)) if pad else x,
                                                 block=qblock)
            a = off + lo
            q[..., a:a + qc.shape[-1]] = qc
            scale[..., a // qblock:(a + qc.shape[-1]) // qblock] = sc
            del x, qc, sc
        off += _padded_size(size, qblock)
    return PackedDelta(q=q, scale=scale)


def dequant_flat(pd: PackedDelta):
    """(..., N) f32 dequantized values (int8 -> f32, then one multiply per
    block)."""
    n, nblocks = pd.q.shape[-1], pd.scale.shape[-1]
    deq = pd.q.to(torch.float32).reshape(*pd.q.shape[:-1], nblocks, n // nblocks)
    return (deq * pd.scale[..., None]).reshape(pd.q.shape)


def unpack_tree(flat, template: dict, qblock: int = QBLOCK,
                lead: int = 0) -> dict:
    """Invert ``pack_tree``: slice (..., N) back into f32 leaves shaped like
    ``template``'s leaves past their first ``lead`` dims (padding dropped),
    keeping ``flat``'s leading dims."""
    out, off = {}, 0
    for k in sorted(template):
        shape = template[k].shape[lead:]
        n = shape.numel()
        out[k] = flat[..., off:off + n].reshape(*flat.shape[:-1], *shape)
        off += _padded_size(n, qblock)
    return out
