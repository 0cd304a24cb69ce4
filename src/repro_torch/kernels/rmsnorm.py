"""Fused RMSNorm (port of ``repro/kernels/rmsnorm.py``).

``rmsnorm`` launches the hand-written Hopper kernel ``csrc/rmsnorm.cu`` for
CUDA tensors and takes ``plain``, the same arithmetic in PyTorch, for CPU
tensors. Both compute ``x * rsqrt(mean(x^2) + eps) * w`` over the last dim
with f32 accumulation and return x's dtype; they sum the squares in another
order, so they agree to f32 rounding (1e-5), not bit for bit.

The kernel is bound by memory traffic: one read and one write of x (see the
note in the CUDA source).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import rmsnorm_ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# The kernel's plain version is the oracle itself, as the JAX package's jnp
# path is ``ref.rmsnorm_ref``.
plain = rmsnorm_ref


def _check(x, w):
    if w.dim() != 1 or x.dim() < 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"rmsnorm wants x (..., D) and w (D,); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in DTYPE_CODES or w.dtype not in DTYPE_CODES:
        raise TypeError(f"rmsnorm takes f32 or bf16, got {x.dtype}/{w.dtype}")
    if x.device != w.device:
        raise ValueError(f"rmsnorm inputs on several devices: {x.device}, {w.device}")


def rmsnorm(x, w, eps: float = 1e-6):
    """x: (..., D); w: (D,) -> x's shape and dtype.

    CPU tensors take ``plain``; CUDA tensors launch the kernel on the current
    stream (no synchronisation) or raise. Each launch adds one to
    ``rmsnorm.launches``."""
    _check(x, w)
    dev = x.device
    if dev.type == "cpu":
        return plain(x, w, eps)
    if dev.type != "cuda":
        raise ValueError(f"rmsnorm runs on cpu or cuda, not {dev}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm wants contiguous inputs")
    D = x.shape[-1]
    R = x.numel() // D if D else 0
    if R >= 2**31:
        raise ValueError(f"rmsnorm takes fewer than 2^31 rows, got {R}")
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().rmsnorm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), R, D,
                                   float(eps), DTYPE_CODES[x.dtype],
                                   DTYPE_CODES[w.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {rc}")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0


def _lib():
    from repro_torch.kernels import build
    lib = build.load("rmsnorm")
    fn = lib.rmsnorm_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
