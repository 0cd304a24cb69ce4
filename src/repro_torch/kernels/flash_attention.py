"""Flash-attention forward (port of ``repro/kernels/flash_attention.py``).

``flash_attention_fwd`` takes ``plain``, a port of the JAX package's
blockwise forward (``ops._blockwise_fwd``), for CPU tensors, and for CUDA
tensors launches one of two hand-written Hopper kernels, both on the
tensor cores, as ``launch_plan`` names it from dtype and head dims alone:

- ``csrc/flash_attention_wgmma.cu`` (``"wgmma"``): bf16 whose head dims
  are multiples of 8 (a TMA tensor map's row stride is a multiple of 16
  bytes) and fit one of ``WGMMA_TILES``: Dk up to 288, Dv up to 256, so
  every (Dk, Dv) of the port's configs (128/128, 64/64, MLA's 288/256 and
  96/64, the reduced 16/16 and 24/16). Both products by ``wgmma``, K/V
  tiles through a TMA ring.
- ``csrc/flash_attention.cu`` (``"tf32x3"``): f32, and bf16 at the other
  head dims up to 288 (20, 288/288), on ``mma.sync`` in TF32 with three
  passes (each f32 operand split into hi + lo TF32 parts; lo*lo dropped),
  which holds f32 to its 2e-5 tolerance where one TF32 pass does not;
  bf16 is exact in TF32, so it takes one pass for Q K^T and two for P V.
  Tiles through a ``cp.async`` ring (``TF32X3_TILES``).

The plan names the tile (an index into the kernel's list, the first that
holds the dims) and its shared bytes; the C entry point launches that tile
and refuses a call whose tile does not hold the dims or whose shared bytes
are not its own. The CPU tests hold the lists to the ones in the sources.
What neither kernel takes (a head dim above 288), the plan refuses.

All return ``(out (B,Sq,H,Dv) in q's dtype, lse (B,H,Sq) f32)`` for causal
or full GQA attention with a runtime ``q_offset``. They differ in rounding
only: the tf32x3 kernel keeps scores and probabilities in f32 (the Pallas
kernel's arithmetic), its products within 2^-22 of f32's; the wgmma kernel
keeps scores in f32 and rounds P to bf16 before P V; the plain version,
like ``_blockwise_fwd``, rounds the products of bf16 inputs to bf16 and P
to bf16. Tolerances: 2e-5 in f32, 2e-2 in bf16 (``tests/test_kernels.py``).

``flash_attention_bwd`` is the gradient. ``plain_bwd``, a port of the JAX
package's flash backward (``ops._blockwise_bwd``, jnp under
``jax.custom_vjp``: there is no Pallas backward kernel) in torch ops, takes
CPU tensors and the CUDA calls that ``bwd_plan`` leaves to it (f32, and
head dims other than 64 and 128: MLA's); bf16 with Dk, Dv in ``BWD_DIMS``
launches the hand-written ``csrc/flash_attention_bwd.cu`` (``"wgmma"``):
scores, probabilities and their gradients kept in registers, dK/dV and dQ
each by its own kernel so that no sum needs a float atomic and every run
gives the same bits. ``ops.flash_attention`` puts forward and backward
together for autograd and ``torch.func``, handing the backward the
forward's own ``lse``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.launch import op_cost

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
CUDA_ERROR_INVALID_VALUE = 1    # cudaErrorInvalidValue: what the entry points refuse with
SOURCES = {"wgmma": "flash_attention_wgmma", "tf32x3": "flash_attention"}
MAX_SMEM = 232_448              # dynamic shared memory a block may use on Hopper
MAX_HEAD_DIM = 288              # MLA's absorbed Dk
# csrc/flash_attention_wgmma.cu's FA_WGMMA_TILES: (k-steps of 16 columns in
# Q K^T, 64-column panels of V), in the order launch_plan tries them
WGMMA_TILES = ((1, 1), (2, 1), (4, 1), (4, 2), (6, 1), (8, 1), (8, 2), (18, 4))
# csrc/flash_attention.cu's FA_TF32X3_TILES: (Dk, Dv the tile holds,
# m-tiles of 16 rows a warp, keys a block), in the order launch_plan tries them
TF32X3_TILES = ((32, 32, 2, 64), (64, 64, 2, 64), (128, 64, 2, 32), (128, 128, 2, 32),
                (288, 128, 2, 16), (288, 256, 1, 32), (288, 288, 1, 32))
BWD_SOURCE = "flash_attention_bwd"
# csrc/flash_attention_bwd.cu's FA_BWD_DIMS: the (Dk, Dv) its kernels are
# built for, the ones its entry point launches
BWD_DIMS = ((64, 64), (64, 128), (128, 64), (128, 128))
BWD_PAD = 128                   # the kernel's per-row workspaces: Sq rounded up to this


class Plan(NamedTuple):
    """How a CUDA call runs: ``kernel`` ("wgmma" or "tf32x3", a key of
    ``SOURCES``), ``tile`` its index in that kernel's tile list (what the C
    entry point launches), ``rows`` q rows a CTA, ``keys`` keys a stage,
    ``stages`` K (and V) buffers, ``tile_dims`` the (Dk, Dv) columns its
    tiles hold (zeros past the head dims: whole 64-column panels on wgmma),
    ``fill`` how tiles reach shared memory ("tma" or "cp.async"),
    ``smem_bytes`` the dynamic shared memory of a CTA (the entry point
    refuses any other)."""
    kernel: str
    tile: int
    rows: int
    keys: int
    stages: int
    tile_dims: tuple
    fill: str
    smem_bytes: int


def _wgmma_smem(ks: int, dvp: int, keys: int) -> int:
    """``smem_bytes`` of csrc/flash_attention_wgmma.cu: 1024 for alignment,
    Q (128 rows), two K and two V stages in whole panels, 5 mbarriers."""
    kp = (ks + 3) // 4
    return 1024 + 2 * (128 * 64 * kp + 2 * keys * 64 * kp + 2 * keys * 64 * dvp) + 64


def _tf32x3_smem(dk: int, dv: int, mt: int, keys: int, esize: int) -> int:
    """``smem_bytes`` of csrc/flash_attention.cu: Q (64 * mt rows), one K and
    one V buffer, rows padded so that fragment loads hit distinct banks."""
    def ld_qk(d):
        unit, w = 128 // esize, -(-d // 16) * 16
        return w + (16 - w) % unit

    def ld_v(d):
        unit, w = 64 // esize, -(-d // 8) * 8
        return w + (16 // esize - w) % unit
    return esize * ((64 * mt + keys) * ld_qk(dk) + keys * ld_v(dv))


@functools.lru_cache(maxsize=256)
def launch_plan(dtype: torch.dtype, Dk: int, Dv: int, kernel: str | None = None) -> Plan:
    """The kernel and geometry a CUDA call with these inputs takes, from
    dtype and head dims alone. bf16 with Dk, Dv multiples of 8 that a wgmma
    tile holds: "wgmma" on the first of ``WGMMA_TILES`` that holds them
    (128 keys a stage where the tiles fit in shared memory, else 64). Else,
    head dims up to 288 in f32 or bf16: "tf32x3" on the first of
    ``TF32X3_TILES`` that holds them. ``kernel`` asks for that kernel's plan
    (the tf32x3 kernel also takes bf16 at the wgmma kernel's dims). What no
    kernel takes raises ``NotImplementedError``."""
    if dtype not in DTYPE_CODES:
        raise NotImplementedError(f"flash_attention: no kernel takes {dtype}")
    if kernel in (None, "wgmma") and dtype == torch.bfloat16 and Dk > 0 and Dv > 0 and \
            Dk % 8 == 0 and Dv % 8 == 0:
        for i, (ks, dvp) in enumerate(WGMMA_TILES):
            if Dk <= 16 * ks and Dv <= 64 * dvp:
                keys = 128 if _wgmma_smem(ks, dvp, 128) <= MAX_SMEM else 64
                return Plan("wgmma", i, 128, keys, 2, (64 * ((ks + 3) // 4), 64 * dvp), "tma",
                            _wgmma_smem(ks, dvp, keys))
    if kernel in (None, "tf32x3") and 0 < Dk <= MAX_HEAD_DIM and 0 < Dv <= MAX_HEAD_DIM:
        esize = torch.empty((), dtype=dtype).element_size()
        for i, (dk, dv, mt, keys) in enumerate(TF32X3_TILES):
            if Dk <= dk and Dv <= dv:
                return Plan("tf32x3", i, 64 * mt, keys, 1, (dk, dv), "cp.async",
                            _tf32x3_smem(dk, dv, mt, keys, esize))
    raise NotImplementedError(
        f"flash_attention: no kernel takes {dtype} head dims Dk={Dk}, Dv={Dv}"
        f"{f' as {kernel!r} asks' if kernel else ''}: the tf32x3 kernel takes each up to "
        f"{MAX_HEAD_DIM}, the wgmma kernel bf16 multiples of 8 within {WGMMA_TILES} "
        f"(k-steps of 16, panels of 64)")


def bwd_plan(dtype: torch.dtype, Dk: int, Dv: int) -> str:
    """The route of a CUDA backward, from dtype and head dims alone: bf16
    with (Dk, Dv) in ``BWD_DIMS`` takes the kernel, "wgmma"
    (``BWD_SOURCE``); everything else (f32, MLA's 288/256 and 96/64, the
    reduced configs' dims) "plain" (``plain_bwd``)."""
    return "wgmma" if dtype == torch.bfloat16 and (Dk, Dv) in BWD_DIMS else "plain"


def plain(q, k, v, q_offset: int = 0, causal: bool = True, scale=None,
          block_q: int = 512, block_k: int = 512):
    """Blockwise online-softmax attention in PyTorch -> (out, lse).

    The JAX package's ``_blockwise_fwd`` with two changes that leave its
    values as they are: ragged Sq and Sk are taken as a short last block
    (the reference needs whole blocks), and under a causal mask the kv
    blocks past a q block's diagonal are skipped (there every score is
    -1e30, so they rescale by exp(0) = 1 and add 0)."""
    B, Sq, H, Dk = q.shape
    _, Sk, KVH, Dv = v.shape
    G = H // KVH
    scale = float(scale if scale is not None else 1.0 / math.sqrt(Dk))
    block_q = min(block_q, Sq)
    block_k = min(block_k, Sk)
    dev = q.device
    outs, lses = [], []
    for q_lo in range(0, Sq, block_q):
        qblk = q[:, q_lo:q_lo + block_q]
        bq = qblk.shape[1]
        qg = qblk.reshape(B, bq, KVH, G, Dk)
        q_start = q_offset + q_lo
        qpos = q_start + torch.arange(bq, device=dev)
        o = torch.zeros((B, KVH, G, bq, Dv), dtype=torch.float32, device=dev)
        m = torch.full((B, KVH, G, bq), -1e30, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KVH, G, bq), dtype=torch.float32, device=dev)
        for ks in range(0, Sk, block_k):
            if causal and ks > q_start + bq - 1:
                break
            kb = k[:, ks:ks + block_k]
            vb = v[:, ks:ks + block_k]
            s = torch.einsum("bqkgd,btkd->bkgqt", qg, kb).to(torch.float32) * scale
            if causal:
                kpos = ks + torch.arange(kb.shape[1], device=dev)
                s = torch.where((qpos[:, None] >= kpos[None, :])[None, None, None],
                                s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bkgqt,btkd->bkgqd", p.to(vb.dtype), vb)
            o = o * alpha[..., None] + pv.to(torch.float32)
            m = m_new
        o = o / torch.clamp(l, min=1e-30)[..., None]
        lse = m + torch.log(torch.clamp(l, min=1e-30))
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, bq, H, Dv).to(q.dtype))
        lses.append(lse.reshape(B, H, bq))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def plain_bwd(q, k, v, out, lse, dout, q_offset: int = 0, causal: bool = True,
              scale=None, block_k: int = 512):
    """Flash backward from the forward's ``out`` and ``lse`` (B,H,Sq) ->
    (dq, dk, dv) in q's, k's and v's dtypes.

    The JAX package's ``_blockwise_bwd`` in its loop order: kv blocks
    outer, each taking every q row at once, p recomputed from ``lse``,
    ``delta = rowsum(dout * out)``, dq summed in f32 over the blocks and
    dk, dv written once per block; scores and products in the inputs'
    dtype, p and ds in f32 and rounded to the inputs' dtype before their
    products. Two changes that leave its values as they are: a ragged Sk
    ends in a short block, and under a causal mask a kv block skips the q
    rows before its first key (every score there is -1e30, so p and ds are
    0 and their products add 0)."""
    B, Sq, H, Dk = q.shape
    _, Sk, KVH, Dv = v.shape
    G = H // KVH
    scale = float(scale if scale is not None else 1.0 / math.sqrt(Dk))
    block_k = min(block_k, Sk)
    dev = q.device
    dout = dout.contiguous()
    delta = (dout.to(torch.float32) * out.to(torch.float32)).sum(dim=-1)   # (B, Sq, H)
    delg = delta.permute(0, 2, 1).reshape(B, KVH, G, Sq)
    lseg = lse.reshape(B, KVH, G, Sq)
    qg = q.reshape(B, Sq, KVH, G, Dk)
    dog = dout.reshape(B, Sq, KVH, G, Dv)
    dq = None
    dks, dvs = [], []
    for ks in range(0, Sk, block_k):
        kb, vb = k[:, ks:ks + block_k], v[:, ks:ks + block_k]
        bk = kb.shape[1]
        q_lo = min(max(0, ks - int(q_offset)), Sq) if causal else 0
        if q_lo == Sq:      # no q row reaches this block's keys
            dks.append(torch.zeros_like(kb))
            dvs.append(torch.zeros_like(vb))
            continue
        qr, dor = qg[:, q_lo:], dog[:, q_lo:]
        s = torch.einsum("bqkgd,btkd->bkgqt", qr, kb).to(torch.float32) * scale
        if causal:
            qpos = int(q_offset) + q_lo + torch.arange(Sq - q_lo, device=dev)
            kpos = ks + torch.arange(bk, device=dev)
            s = torch.where((qpos[:, None] >= kpos[None, :])[None, None, None], s, -1e30)
        p = torch.exp(s - lseg[..., q_lo:, None])
        dp = torch.einsum("bqkgd,btkd->bkgqt", dor, vb).to(torch.float32)
        ds = p * (dp - delg[..., q_lo:, None]) * scale
        dqb = torch.einsum("bkgqt,btkd->bqkgd", ds.to(kb.dtype), kb).to(torch.float32)
        if dq is None:          # the first block: q_lo is 0
            dq = dqb
        elif q_lo:
            dq = torch.cat([dq[:, :q_lo], dq[:, q_lo:] + dqb], dim=1)
        else:
            dq = dq + dqb
        dks.append(torch.einsum("bkgqt,bqkgd->btkd", ds.to(qr.dtype), qr))
        dvs.append(torch.einsum("bkgqt,bqkgd->btkd", p.to(dor.dtype), dor))
    dq = dq.reshape(B, Sq, H, Dk).to(q.dtype)
    return dq, torch.cat(dks, dim=1).to(k.dtype), torch.cat(dvs, dim=1).to(v.dtype)


def _check(q, k, v, q_offset):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention wants q (B,Sq,H,Dk), k (B,Sk,KV,Dk), "
                         f"v (B,Sk,KV,Dv); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, Dk = q.shape
    _, Sk, KV, Dv = v.shape
    if k.shape != (B, Sk, KV, Dk) or v.shape[0] != B or KV == 0 or H % KV:
        raise ValueError(f"flash_attention shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_attention takes one of f32/bf16 for q, k, v; got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention inputs on several devices")
    if int(q_offset) < 0:
        raise ValueError(f"flash_attention wants q_offset >= 0, got {q_offset}")


def _pairs(Sq: int, Sk: int, q_offset: int, causal: bool) -> tuple:
    """(query, key) pairs the mask lets through (under a causal mask, q row
    i at ``q_offset + i`` sees keys 0 .. q_offset + i) and the keys any row
    reaches."""
    if not causal:
        return Sq * Sk, Sk
    full = min(max(Sk - q_offset, 0), Sq)        # rows whose keys end inside Sk
    return full * q_offset + full * (full + 1) // 2 + (Sq - full) * Sk, min(Sk, q_offset + Sq)


def cost(B: int, Sq: int, Sk: int, H: int, KV: int, Dk: int, Dv: int, q_offset: int,
         causal: bool, esize: int) -> tuple:
    """(operations, bytes) of one forward: 2 (Dk + Dv) operations for each
    (query, key) pair the mask lets through, for every batch row and head;
    q, out, the K/V rows the mask reaches read or written once in elements
    of ``esize`` bytes, and the f32 lse."""
    pairs, keys = _pairs(Sq, Sk, q_offset, causal)
    nbytes = (B * Sq * H * (Dk + Dv) + B * keys * KV * (Dk + Dv)) * esize + B * H * Sq * 4
    return 2 * B * H * pairs * (Dk + Dv), nbytes


def bwd_cost(B: int, Sq: int, Sk: int, H: int, KV: int, Dk: int, Dv: int, q_offset: int,
             causal: bool, esize: int) -> tuple:
    """(operations, bytes) of one backward: the five products a pair the
    gradient needs (the scores again, dP, dV, dQ, dK: 2 (3 Dk + 2 Dv)
    operations; the kernel recomputes two of them, 7 in all, so that no sum
    needs an atomic); q, dq, out, dout and the K/V rows the mask reaches
    with dk and dv moved once, and the f32 lse read once."""
    pairs, keys = _pairs(Sq, Sk, q_offset, causal)
    nbytes = (2 * B * Sq * H * (Dk + Dv) + 2 * B * keys * KV * (Dk + Dv)) * esize \
        + B * H * Sq * 4
    return 2 * B * H * pairs * (3 * Dk + 2 * Dv), nbytes


def flash_attention_fwd(q, k, v, q_offset: int = 0, causal: bool = True,
                        scale=None):
    """q (B,Sq,H,Dk), k (B,Sk,KV,Dk), v (B,Sk,KV,Dv) -> (out, lse).

    ``q_offset`` is the global position of q row 0 (a Python int). CPU
    tensors take ``plain``; CUDA tensors launch the kernel that
    ``launch_plan`` names on the current stream (no synchronisation) or
    raise. Each launch adds one to ``flash_attention_fwd.launches``, to its
    kernel's entry in ``flash_attention_fwd.launches_by_kernel`` and to its
    shape's, ``(B, Sq, Sk, H, KV, Dk, Dv, causal)``, in
    ``flash_attention_fwd.launches_by_shape``. Meta tensors (a dry run,
    ``launch/dryrun.py``) pass the same checks and get the outputs the
    kernel would write, and no launch. On either, a launch records ``cost``
    in an open ``launch/op_cost.cost_scope``."""
    _check(q, k, v, q_offset)
    dev = q.device
    if dev.type == "cpu":
        return plain(q, k, v, int(q_offset), causal, scale)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cpu or cuda (or meta, for a dry run), "
                         f"not {dev}")
    kernel = launch_plan(q.dtype, q.shape[-1], v.shape[-1]).kernel
    out, lse = _launch(kernel, q, k, v, q_offset, causal, scale)
    key = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3], v.shape[3],
           bool(causal))
    if dev.type == "cuda":
        flash_attention_fwd.launches += 1
        flash_attention_fwd.launches_by_kernel[kernel] += 1
        flash_attention_fwd.launches_by_shape[key] = \
            flash_attention_fwd.launches_by_shape.get(key, 0) + 1
    if op_cost.active():
        op_cost.record_kernel("flash_attention", key,
                              *cost(*key[:-1], int(q_offset), causal, q.element_size()))
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_by_kernel = {k: 0 for k in SOURCES}
flash_attention_fwd.launches_by_shape = {}


def _launch(kernel, q, k, v, q_offset, causal, scale):
    """Launch ``kernel`` ("wgmma" or "tf32x3") on checked CUDA tensors with
    its ``launch_plan``; counts nothing (the public wrapper does). The
    tf32x3 kernel also takes bf16 at the wgmma kernel's dims, for timing
    the two side by side. Meta tensors pass the same checks and get the
    outputs, unlaunched (a meta tensor's data pointer is its byte offset,
    so the alignment checks hold as on the card)."""
    dev = q.device
    B, Sq, H, Dk = q.shape
    _, Sk, KV, Dv = v.shape
    if B >= 65536 or H >= 65536:
        raise ValueError(f"flash_attention takes B, H < 65536, got {B}, {H}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention wants contiguous q, k, v")
    try:
        plan = launch_plan(q.dtype, Dk, Dv, kernel)
    except NotImplementedError:
        if kernel != "wgmma":
            raise
        raise ValueError(f"the wgmma kernel takes bf16 with head dims that are multiples of "
                         f"8 within {WGMMA_TILES} (k-steps of 16, panels of 64), got "
                         f"{q.dtype}, Dk={Dk}, Dv={Dv}") from None
    if plan.fill == "tma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"the {kernel} flash-attention kernel loads these tiles by TMA and "
                         f"wants 16-byte aligned q, k, v")
    scale = float(scale if scale is not None else 1.0 / math.sqrt(Dk))
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        return out, lse
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry(SOURCES[kernel])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, Sq, Sk, H, KV, Dk, Dv, int(q_offset), int(bool(causal)), scale,
            DTYPE_CODES[q.dtype], plan.tile, plan.smem_bytes, stream)
    if rc == CUDA_ERROR_INVALID_VALUE:
        raise RuntimeError(
            f"the {kernel} flash-attention kernel refused {plan} for {q.dtype} Dk={Dk}, "
            f"Dv={Dv}: launch_plan's tile list or shared bytes differ from the source's")
    if rc != 0:
        raise RuntimeError(f"flash_attention {kernel} kernel launch failed: CUDA error {rc}")
    return out, lse


def _entry(name):
    """The C entry point ``<name>_launch`` of ``csrc/<name>.cu`` (both
    sources share its signature)."""
    from repro_torch.kernels import build
    fn = getattr(build.load(name), f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
        ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd(q, k, v, out, lse, dout, q_offset: int = 0, causal: bool = True,
                        scale=None):
    """Gradients (dq, dk, dv), in q's, k's and v's dtypes, of the attention
    whose forward gave ``out`` and ``lse`` (B,H,Sq), against ``dout``.

    CPU tensors take ``plain_bwd``; CUDA tensors take the route ``bwd_plan``
    names: the kernel, launched on the current stream (no synchronisation)
    or raising, or ``plain_bwd``. Each CUDA call adds one to
    ``flash_attention_bwd.launches``, to its route's entry in
    ``launches_by_kernel`` and to its shape's, ``(B, Sq, Sk, H, KV, Dk, Dv,
    causal)``, in ``launches_by_shape``. Meta tensors (a dry run) pass the
    same checks and get the outputs, counted nowhere; on either, the kernel
    route records ``bwd_cost`` in an open ``launch/op_cost.cost_scope``
    (``plain_bwd``'s torch ops count themselves)."""
    _check(q, k, v, q_offset)
    dev = q.device
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention runs on cpu or cuda (or meta, for a dry run), "
                         f"not {dev}")
    kernel = "plain" if dev.type == "cpu" else bwd_plan(q.dtype, q.shape[-1], v.shape[-1])
    if kernel == "plain":
        grads = plain_bwd(q, k, v, out, lse, dout, int(q_offset), causal, scale)
    else:
        grads = _launch_bwd(q, k, v, out, lse, dout, q_offset, causal, scale)
    key = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3], v.shape[3],
           bool(causal))
    if dev.type == "cuda":
        flash_attention_bwd.launches += 1
        flash_attention_bwd.launches_by_kernel[kernel] += 1
        flash_attention_bwd.launches_by_shape[key] = \
            flash_attention_bwd.launches_by_shape.get(key, 0) + 1
    if kernel == "wgmma" and op_cost.active():
        op_cost.record_kernel("flash_attention_bwd", key,
                              *bwd_cost(*key[:-1], int(q_offset), causal, q.element_size()))
    return grads


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_kernel = {"wgmma": 0, "plain": 0}
flash_attention_bwd.launches_by_shape = {}


def _launch_bwd(q, k, v, out, lse, dout, q_offset, causal, scale):
    """Launch the backward kernel on checked CUDA tensors that ``bwd_plan``
    gives it; counts nothing (the public wrapper does). Meta tensors get
    the outputs, unlaunched."""
    dev = q.device
    B, Sq, H, Dk = q.shape
    _, Sk, KV, Dv = v.shape
    if out.shape != (B, Sq, H, Dv) or dout.shape != out.shape or \
            out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"flash_attention backward wants out and dout {(B, Sq, H, Dv)} in "
                         f"{q.dtype}; got {tuple(out.shape)} {out.dtype}, "
                         f"{tuple(dout.shape)} {dout.dtype}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention backward wants the forward's f32 lse "
                         f"{(B, H, Sq)}; got {tuple(lse.shape)} {lse.dtype}")
    tensors = (q, k, v, out, dout, lse)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention backward wants contiguous q, k, v, out, dout, lse")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the flash-attention backward kernel loads its tiles by TMA and "
                         "wants 16-byte aligned q, k, v, out, dout, lse")
    scale = float(scale if scale is not None else 1.0 / math.sqrt(Dk))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dev.type == "meta":
        return dq, dk, dv
    if 0 in (B, Sq, Sk, H):        # nothing to sum over: zero gradients
        return dq.zero_(), dk.zero_(), dv.zero_()
    ws = torch.empty((2, B, H, -(-Sq // BWD_PAD) * BWD_PAD), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _bwd_entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ws[0].data_ptr(),
            ws[1].data_ptr(), B, Sq, Sk, H, KV, Dk, Dv, int(q_offset), int(bool(causal)),
            scale, stream)
    if rc == CUDA_ERROR_INVALID_VALUE:
        raise RuntimeError(f"the flash-attention backward kernel refused Dk={Dk}, Dv={Dv}: "
                           f"BWD_DIMS differs from the source's FA_BWD_DIMS")
    if rc != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: CUDA error {rc}")
    return dq, dk, dv


def _bwd_entry():
    """The C entry point ``flash_attention_bwd_launch`` of ``csrc/<BWD_SOURCE>.cu``."""
    from repro_torch.kernels import build
    fn = build.load(BWD_SOURCE).flash_attention_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
