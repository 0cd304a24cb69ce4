"""The float32 numerics the references run in."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32(on: bool):
    """cuBLAS and cuDNN allowed TF32 (``on``) or held to float32; the flags
    restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
