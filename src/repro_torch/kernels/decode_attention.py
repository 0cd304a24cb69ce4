"""Decode attention: one query token over a KV cache (port of
``repro/kernels/decode_attention.py``).

``decode_attention_fwd`` launches the hand-written Hopper kernel
``csrc/decode_attention.cu`` for CUDA tensors and takes ``plain``, a port of
the JAX package's blockwise decode (``ops._decode_blockwise``), for CPU
tensors. The kernel splits the cache into chunks of ``CHUNK`` keys, one CTA
each, and log-sum-exp combines the chunks' partial results in the same
call; ``plain_split`` is that split-and-combine in PyTorch. All return the
unnormalised ``(o (B,H,Dv), m (B,H), l (B,H))``, all f32, with
``softmax output = o / l``, so shards of a cache can be log-sum-exp
combined; a row with ``length == 0`` gives m = -1e30, l = 0, o = 0. All
take any cache length S (the JAX path needs S to be a whole number of
512-key blocks).

They differ in rounding only: the kernel keeps scores and probabilities in
f32, the plain version rounds the products of bf16 inputs to bf16, as the
JAX path does. Tolerances: 2e-5 in f32, 2e-2 in bf16.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.launch import op_cost

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_SMEM_BYTES = 227 * 1024    # dynamic shared memory one block may use on Hopper
MAX_GROUP = 32                 # query heads per kv head the kernel takes
CHUNK = 256                    # keys per CTA: 9 splits, 576 CTAs at the serve shape


def plain(q, k, v, length, scale=None, block_k: int = 512):
    """Blockwise online-softmax decode in PyTorch -> (o, m, l).

    The JAX package's ``_decode_blockwise``, with a short last block where S
    is ragged, and with the blocks at or past a row's ``length`` left out of
    that row's update, as the kernels (Pallas and CUDA) skip them. That
    changes nothing for length >= 1 (such a block rescales by exp(0) = 1 and
    adds 0) and gives the kernels' m = -1e30, l = 0 for length 0."""
    B, H, Dk = q.shape
    _, S, KVH, Dv = v.shape
    G = H // KVH
    scale = float(scale if scale is not None else 1.0 / math.sqrt(Dk))
    block_k = max(1, min(block_k, S))
    dev = q.device
    qg = q.reshape(B, KVH, G, Dk)
    o = torch.zeros((B, KVH, G, Dv), dtype=torch.float32, device=dev)
    m = torch.full((B, KVH, G), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KVH, G), dtype=torch.float32, device=dev)
    for ks in range(0, S, block_k):
        kb = k[:, ks:ks + block_k]
        vb = v[:, ks:ks + block_k]
        s = torch.einsum("bkgd,btkd->bkgt", qg, kb).to(torch.float32) * scale
        kpos = ks + torch.arange(kb.shape[1], device=dev)
        s = torch.where(kpos[None, None, None] < length[:, None, None, None], s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(dim=-1)
        o_new = o * alpha[..., None] + torch.einsum(
            "bkgt,btkd->bkgd", p.to(vb.dtype), vb).to(torch.float32)
        live = (length > ks)[:, None, None]
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        o = torch.where(live[..., None], o_new, o)
    return o.reshape(B, H, Dv), m.reshape(B, H), l.reshape(B, H)


def combine(parts):
    """Log-sum-exp combine of partial ``(o, m, l)`` over disjoint key ranges
    -> ``(o, m, l)``. A part that saw no key (m = -1e30, l = 0, o = 0) is
    weighed by exp(-1e30 - m) = 0; if every part is empty the result is
    m = -1e30, l = 0, o = 0."""
    m = torch.stack([pm for _, pm, _ in parts]).amax(dim=0)
    l = sum(pl * torch.exp(pm - m) for _, pm, pl in parts)
    o = sum(po * torch.exp(pm - m)[..., None] for po, pm, _ in parts)
    return o, m, l


def plain_split(q, k, v, length, chunk: int = CHUNK, scale=None, block_k: int = 64):
    """The kernel's split-and-combine in PyTorch -> (o, m, l): ``plain`` over
    each chunk of ``chunk`` keys (with ``length`` clipped to the chunk, so a
    chunk at or past ``length`` sees no key) in blocks of ``block_k``, then
    ``combine``."""
    S = k.shape[1]
    parts = []
    for start in range(0, S, chunk):
        stop = min(start + chunk, S)
        local = torch.clamp(length - start, 0, stop - start).to(torch.int32)
        parts.append(plain(q, k[:, start:stop], v[:, start:stop], local, scale, block_k))
    if not parts:
        return plain(q, k, v, length, scale, block_k)
    return combine(parts)


def _check(q, k, v, length):
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4 or length.dim() != 1:
        raise ValueError(f"decode_attention wants q (B,H,Dk), k (B,S,KV,Dk), "
                         f"v (B,S,KV,Dv), length (B,); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, {tuple(length.shape)}")
    B, H, Dk = q.shape
    _, S, KV, Dv = v.shape
    if k.shape != (B, S, KV, Dk) or v.shape[0] != B or length.shape[0] != B \
            or KV == 0 or H % KV:
        raise ValueError(f"decode_attention shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"length {tuple(length.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPE_CODES:
        raise TypeError(f"decode_attention takes one of f32/bf16 for q, k, v; got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if length.dtype != torch.int32:
        raise TypeError(f"decode_attention wants int32 lengths, got {length.dtype}")
    if len({q.device, k.device, v.device, length.device}) != 1:
        raise ValueError("decode_attention inputs on several devices")


def cost(B: int, S: int, H: int, KV: int, Dk: int, Dv: int, esize: int,
         keys: int | None = None) -> tuple:
    """(operations, bytes) of one call over ``keys`` cached keys in all
    (the rows' lengths summed, each clipped to S; None: every row's whole
    cache of S, what a dry run counts, whose lengths are data): 2 (Dk + Dv)
    operations a key and query head; the K/V rows read once in elements of
    ``esize`` bytes, q read, and the f32 (o, m, l) and the int32 lengths."""
    keys = B * S if keys is None else keys
    nbytes = keys * KV * (Dk + Dv) * esize + B * H * Dk * esize + (B * H * (Dv + 2) + B) * 4
    return 2 * keys * H * (Dk + Dv), nbytes


def decode_attention_fwd(q, k, v, length, scale=None):
    """q (B,H,Dk), k (B,S,KV,Dk), v (B,S,KV,Dv), length (B,) int32 ->
    unnormalised (o, m, l), all f32.

    CPU tensors take ``plain``; CUDA tensors launch the kernel on the current
    stream (no synchronisation) or raise. Each call on the card (the split
    kernel and its combine) adds one to ``decode_attention_fwd.launches``
    and to its shape's, ``(B, S, H, KV, Dk, Dv)``, in
    ``decode_attention_fwd.launches_by_shape``. Meta tensors (a dry run,
    ``launch/dryrun.py``) pass the same checks and get the outputs and the
    split's scratch the kernel would allocate, and no launch. On either, a
    call records ``cost`` over the whole cache in an open
    ``launch/op_cost.cost_scope``."""
    _check(q, k, v, length)
    dev = q.device
    if dev.type == "cpu":
        return plain(q, k, v, length, scale)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"decode_attention runs on cpu or cuda (or meta, for a dry run), "
                         f"not {dev}")
    B, H, Dk = q.shape
    _, S, KV, Dv = v.shape
    if Dk > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"the decode-attention kernel takes head dims up to {MAX_HEAD_DIM}, got "
            f"Dk={Dk}, Dv={Dv}; MLA's decode attends in its latent space with "
            "einsums and needs no larger ones, and a larger-dim B4 (the absorbed "
            "MLA decode on the kernel) is a speed item in ROADMAP B")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and length.is_contiguous()):
        raise ValueError("decode_attention wants contiguous inputs")
    if H // KV > MAX_GROUP:
        raise ValueError(f"decode_attention takes GQA groups up to {MAX_GROUP}, got {H // KV}")
    if dev.type == "cuda":
        lib = _lib()
        smem = lib.decode_attention_smem_bytes(H // KV, Dk, Dv, DTYPE_CODES[q.dtype])
        if smem > MAX_SMEM_BYTES:
            raise ValueError(f"decode_attention: a GQA group of {H // KV} needs {smem} B of "
                             f"shared memory, more than {MAX_SMEM_BYTES}")
    scale = float(scale if scale is not None else 1.0 / math.sqrt(Dk))
    o = torch.empty((B, H, Dv), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    l = torch.empty((B, H), dtype=torch.float32, device=dev)
    n_split = -(-S // CHUNK)
    part = torch.empty((B * H * n_split * (Dv + 2),), dtype=torch.float32, device=dev)
    key = (B, S, H, KV, Dk, Dv)
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.decode_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(), part.data_ptr(),
                o.data_ptr(), m.data_ptr(), l.data_ptr(), B, S, H, KV, Dk, Dv, CHUNK, n_split,
                scale, DTYPE_CODES[q.dtype], stream)
        if rc != 0:
            raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {rc}")
        decode_attention_fwd.launches += 1
        decode_attention_fwd.launches_by_shape[key] = \
            decode_attention_fwd.launches_by_shape.get(key, 0) + 1
    if op_cost.active():
        op_cost.record_kernel("decode_attention", key, *cost(*key, q.element_size()))
    return o, m, l


decode_attention_fwd.launches = 0
decode_attention_fwd.launches_by_shape = {}


def _lib():
    from repro_torch.kernels import build
    lib = build.load("decode_attention")
    fn = lib.decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sm = lib.decode_attention_smem_bytes
    sm.argtypes = [ctypes.c_int] * 4
    sm.restype = ctypes.c_int64
    return lib
