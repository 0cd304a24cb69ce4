"""Fused int8 dequantize + weighted client reduction (port of
``repro/kernels/quant_aggregate.py``).

``quant_aggregate`` launches the hand-written Hopper kernel
``csrc/quant_aggregate.cu`` for CUDA tensors and takes ``plain``, the same
arithmetic in PyTorch, for CPU tensors. Both compute, per output n and in
client order, ``acc = acc + (float(q[c, n]) * scale[c, n // qblock]) * w[c]``
from ``acc = 0``, so they agree bit for bit.

The kernel is bound by memory traffic: it reads each int8 byte once and
writes only the (N,) f32 result (see the note in the CUDA source).
"""
from __future__ import annotations

import ctypes

import torch

VEC = 16                      # outputs per kernel thread (one int8 vector load)
MAX_CLIENTS = 48 * 1024 // 4  # w fills at most 48 KB of shared memory


def plain(qdeltas, scales, weights):
    """The kernel's plain PyTorch version: client-ordered accumulation of
    ``(q * scale) * w`` over (nblocks, qblock) views; no (C, N) f32 buffer."""
    C, N = qdeltas.shape
    nblocks = scales.shape[-1]
    out = torch.zeros((nblocks, N // nblocks), dtype=torch.float32,
                      device=qdeltas.device)
    for c in range(C):
        deq = qdeltas[c].to(torch.float32).reshape(nblocks, -1) \
            * scales[c, :, None]
        out = out + deq * weights[c]
    return out.reshape(N)


def _check(qdeltas, scales, weights):
    if qdeltas.dim() != 2 or scales.dim() != 2 or weights.dim() != 1:
        raise ValueError(
            f"quant_aggregate wants q (C, N), scale (C, N/qblock), w (C,); got "
            f"{tuple(qdeltas.shape)}, {tuple(scales.shape)}, {tuple(weights.shape)}")
    if (qdeltas.dtype, scales.dtype, weights.dtype) != \
            (torch.int8, torch.float32, torch.float32):
        raise TypeError(f"quant_aggregate wants int8/f32/f32, got "
                        f"{qdeltas.dtype}/{scales.dtype}/{weights.dtype}")
    C, N = qdeltas.shape
    if scales.shape[0] != C or weights.shape[0] != C or scales.shape[1] == 0:
        raise ValueError(f"client dims disagree: q {tuple(qdeltas.shape)}, "
                         f"scale {tuple(scales.shape)}, w {tuple(weights.shape)}")
    if N % scales.shape[1]:
        raise ValueError(f"N={N} is not a whole number of scale blocks "
                         f"({scales.shape[1]})")
    qblock = N // scales.shape[1]
    if qblock % VEC:
        raise ValueError(f"qblock={qblock} must be a multiple of {VEC}")
    return C, N, qblock


def quant_aggregate(qdeltas, scales, weights):
    """-> (N,) f32: ``sum_c weights[c] * dequant(qdeltas[c])``.

    CPU tensors take ``plain``; CUDA tensors launch the kernel on the current
    stream (no synchronisation) or raise. Each launch adds one to
    ``quant_aggregate.launches``."""
    C, N, qblock = _check(qdeltas, scales, weights)
    devices = {t.device for t in (qdeltas, scales, weights)}
    if len(devices) != 1:
        raise ValueError(f"quant_aggregate inputs on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return plain(qdeltas, scales, weights)
    if dev.type != "cuda":
        raise ValueError(f"quant_aggregate runs on cpu or cuda, not {dev}")
    if not (qdeltas.is_contiguous() and scales.is_contiguous()
            and weights.is_contiguous()):
        raise ValueError("quant_aggregate wants contiguous inputs")
    if qdeltas.data_ptr() % 16:
        raise ValueError("quant_aggregate wants q aligned to 16 bytes")
    if C > MAX_CLIENTS:
        raise ValueError(f"quant_aggregate takes at most {MAX_CLIENTS} "
                         f"clients, got {C}")
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().quant_aggregate_launch(
            qdeltas.data_ptr(), scales.data_ptr(), weights.data_ptr(),
            out.data_ptr(), C, N, qblock, stream)
    if rc != 0:
        raise RuntimeError(f"quant_aggregate kernel launch failed: CUDA error {rc}")
    quant_aggregate.launches += 1
    return out


quant_aggregate.launches = 0


def _lib():
    from repro_torch.kernels import build
    lib = build.load("quant_aggregate")
    fn = lib.quant_aggregate_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int64,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
