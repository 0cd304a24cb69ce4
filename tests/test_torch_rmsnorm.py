"""The port's RMSNorm (``repro_torch/kernels/rmsnorm``) against the JAX
package's, on the same numpy inputs.

On the CPU the port's wrapper takes the kernel's plain version; the CUDA
kernel against that plain version is in ``test_torch_gpu.py``, on the card.

Tolerances (``tests/test_kernels.py``): 1e-5 in f32; 2e-2 in bf16, where
both sides round the f32 result to bf16 and may land one bf16 step apart.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref as jref
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rms

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(shape[-1]).astype(np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [(64, 128), (3, 40, 256), (130, 512)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_matches_pallas_interpret(shape, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, w = _inputs(shape)
    want = pallas_rmsnorm(jnp.asarray(x).astype(jdt), jnp.asarray(w),
                          block_rows=32, interpret=True)
    before = rms.rmsnorm.launches
    got = ops.rmsnorm(torch.from_numpy(x).to(tdt), torch.from_numpy(w))
    assert rms.rmsnorm.launches == before          # CPU tensors never launch
    assert got.dtype == tdt and tuple(got.shape) == shape
    _close(got, want, tol)


@pytest.mark.parametrize("shape", [(5, 7168), (2, 3, 100), (33, 48), (1, 64)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("w_dtype", ["f32", "bf16"])
def test_rmsnorm_matches_jnp_ref_at_path_and_ragged_shapes(shape, dtype, w_dtype):
    """The serve path's widths (D = 7168, and 64 reduced) and ragged D, with
    f32 or bf16 weights (the bf16 model's norms are bf16)."""
    jdt, tdt, tol = DTYPES[dtype]
    jw, tw, _ = DTYPES[w_dtype]
    x, w = _inputs(shape, seed=1)
    want = jref.rmsnorm_ref(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jw))
    got = rms.plain(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tw))
    _close(got, want, tol)
    _close(ref.rmsnorm_ref(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tw)),
           want, tol)


def test_rmsnorm_eps_is_passed_through():
    x, w = _inputs((4, 32), seed=2)
    x *= 1e-3
    for eps in (1e-6, 1e-2):
        want = jref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(w), eps)
        _close(ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), eps), want, 1e-5)


@pytest.mark.parametrize("x,w,exc", [
    (torch.zeros(4, 8), torch.zeros(7), ValueError),
    (torch.zeros(4, 8), torch.zeros(1, 8), ValueError),
    (torch.zeros(4, 8, dtype=torch.float16), torch.zeros(8), TypeError),
    (torch.zeros(4, 8, device="meta"), torch.zeros(8, device="meta"), ValueError),
])
def test_rmsnorm_rejects_what_the_kernel_does_not_take(x, w, exc):
    with pytest.raises(exc):
        rms.rmsnorm(x, w)
