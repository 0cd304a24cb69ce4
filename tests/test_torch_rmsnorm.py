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


@pytest.fixture(autouse=True)
def one_thread():
    """Every test here on one torch intra-op thread: the suite runs in
    several processes that share the cores, and with a thread per core in
    each, torch's many small CPU ops crawl (six of the port's test files took
    426 s under six processes against 75 s on one thread each)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    before = (rms.rmsnorm.launches, dict(rms.rmsnorm.launches_by_shape))
    got = ops.rmsnorm(torch.from_numpy(x).to(tdt), torch.from_numpy(w))
    # CPU tensors never launch
    assert (rms.rmsnorm.launches, rms.rmsnorm.launches_by_shape) == before
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
    # meta is a dry run's device: its branch refuses what the card's does
    (torch.zeros(8, 4, device="meta").t(), torch.zeros(8, device="meta"), ValueError),
])
def test_rmsnorm_rejects_what_the_kernel_does_not_take(x, w, exc):
    with pytest.raises(exc):
        rms.rmsnorm(x, w)


# -- the kernel's launch geometry (kernels/rmsnorm.launch_plan) -------------
# Pure Python: the CUDA kernel takes this plan as it is, so a plan that
# covers every element of the row exactly once is a kernel that reads and
# writes every element exactly once.

def _covered(plan, D):
    """How often the kernel's index arithmetic touches each element of a
    row: CTA r of the cluster holds [r * per_cta, min(D, (r + 1) * per_cta)),
    its thread t the vectors t + i * threads (i < vpt) of vec elements."""
    seen = np.zeros(D + plan.vec * plan.threads * plan.vpt, dtype=np.int64)
    for c0, c1 in rms.cta_slices(plan, D):
        for i in range(plan.vpt):
            e = c0 + (np.arange(plan.threads) + i * plan.threads) * plan.vec
            for j in range(plan.vec):
                np.add.at(seen, (e + j)[e < c1], 1)
    return seen


@pytest.mark.parametrize("sm_count", [132, 114, 78])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_launch_plan_takes_a_wide_cta_below_the_sm_count_and_a_narrow_one_from_it(
        sm_count, tdt):
    for R in (1, 8, sm_count - 1):
        plan = rms.launch_plan(R, 7168, tdt, sm_count)
        assert plan.layout == "wide_row" and plan.K == 1
        assert plan.threads <= rms.WIDE_ROW_THREADS
    for R in (sm_count, sm_count + 1, 16_384):
        plan = rms.launch_plan(R, 7168, tdt, sm_count)
        assert plan.layout == "row" and plan.K == 1
    # yi-34b's serve shapes on an H100: 448 threads per decode row, 128 per prefill row
    if sm_count == 132 and tdt == torch.bfloat16:
        assert rms.launch_plan(8, 7168, tdt, 132) == rms.Plan(1, 448, 2, 8, 7168, "wide_row")
        assert rms.launch_plan(16_384, 7168, tdt, 132) == rms.Plan(1, 128, 8, 8, 7168, "row")


@pytest.mark.parametrize("R", [8, 16_384])
@pytest.mark.parametrize("D,tdt,aligned,K", [
    (32_768, torch.bfloat16, True, 2),      # 4,096 vectors: two CTAs of 2,048
    (16_384, torch.float32, True, 2),
    (8_193, torch.float32, True, 2),        # scalar: 8,192 per CTA at most
    (16 * 8192, torch.float32, False, 16)])
def test_launch_plan_splits_a_row_too_long_for_one_cta_over_a_cluster(R, D, tdt, aligned, K):
    plan = rms.launch_plan(R, D, tdt, 132, aligned)
    assert plan.layout == "cluster" and plan.K == K
    seen = _covered(plan, D)
    assert (seen[:D] == 1).all() and (seen[D:] == 0).all()


@pytest.mark.parametrize("D", [7168, 7169, 4096, 128, 1])
@pytest.mark.parametrize("R", [8, 131, 132, 16_384])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
def test_launch_plan_covers_the_row_exactly_once(D, R, tdt, aligned):
    plan = rms.launch_plan(R, D, tdt, 132, aligned)
    seen = _covered(plan, D)
    assert (seen[:D] == 1).all() and (seen[D:] == 0).all()
    assert plan.vec == (rms.vector_width(D, tdt) if aligned else 1)
    assert plan.threads % 32 == 0 and plan.threads <= rms.thread_bound(plan.vec, plan.vpt)
    assert plan.vpt in rms.VPTS and plan.per_cta % plan.vec == 0
    assert all(c1 > c0 for c0, c1 in rms.cta_slices(plan, D))   # no idle CTA


@pytest.mark.parametrize("K", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("D", [7168, 7169, 4096])
def test_forced_cluster_sizes_cover_the_row_exactly_once(K, D):
    plan = rms.launch_plan(8, D, torch.bfloat16, 132, K=K)
    assert plan.K == K
    seen = _covered(plan, D)
    assert (seen[:D] == 1).all() and (seen[D:] == 0).all()


def test_launch_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        rms.launch_plan(8, 7168, torch.bfloat16, 132, K=32)     # past the cluster limit
    with pytest.raises(ValueError):
        rms.launch_plan(8, 64, torch.bfloat16, 132, K=16)       # idle CTAs
    with pytest.raises(ValueError):
        rms.launch_plan(8, 16 * 8192 + 1, torch.float32, 132, aligned=False)  # no 16 CTAs hold it
    # the longest rows a cluster of 16 holds: 2,048 vectors per CTA, or 8,192 scalars
    assert rms.launch_plan(8, 16 * 2048 * 8, torch.bfloat16, 132).K == 16
    with pytest.raises(ValueError):
        rms.launch_plan(8, 16 * 2048 * 8 + 8, torch.bfloat16, 132)


@pytest.mark.parametrize("shape", [(8, 7168), (3, 4096), (5, 7169)])
@pytest.mark.parametrize("K", [2, 8, 16])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_cluster_matches_plain(shape, K, dtype):
    """The cluster's summation order (per-CTA partials, added in rank order)
    against the whole-row sum, on the CPU."""
    _, tdt, tol = DTYPES[dtype]
    x, w = _inputs(shape, seed=K)
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w)
    got = rms.plain_cluster(xt, wt, 1e-6, K)
    assert got.dtype == tdt and got.shape == xt.shape
    _close(got, rms.plain(xt, wt).to(torch.float32).numpy(), tol)


@pytest.mark.parametrize("shape", [(8, 7168), (16, 4096)])
@pytest.mark.parametrize("K", [8, 16])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_cluster_matches_pallas_interpret(shape, K, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, w = _inputs(shape, seed=3)
    want = pallas_rmsnorm(jnp.asarray(x).astype(jdt), jnp.asarray(w), block_rows=8,
                          interpret=True)
    _close(rms.plain_cluster(torch.from_numpy(x).to(tdt), torch.from_numpy(w), 1e-6, K),
           want, tol)


# -- the backward: ops.rmsnorm under autograd and torch.func -----------------
# Against jax.grad of the JAX package's oracle, ref.rmsnorm_ref (its CPU
# path differentiates it; there is no backward kernel), at the reduced
# model's width D = 64 and at the qk-norm rows' head dim D = 128. f32;
# atol = rtol = 1e-5 (the analytic formula against autodiff of the forward).


@pytest.mark.parametrize("shape", [(6, 64), (2, 3, 5, 128)])
def test_rmsnorm_backward_matches_jax_grad_of_the_ref(shape):
    import jax
    x, w = _inputs(shape, seed=3)
    g = np.random.RandomState(4).randn(*shape).astype(np.float32)
    want = jax.grad(lambda x, w: (jref.rmsnorm_ref(x, w) * g).sum(), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    before = rms.rmsnorm.launches
    (ops.rmsnorm(tx, tw) * torch.from_numpy(g)).sum().backward()
    assert rms.rmsnorm.launches == before           # CPU tensors never launch
    _close(tx.grad, want[0], 1e-5)
    _close(tw.grad, want[1], 1e-5)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("w_batched", [False, True])
def test_rmsnorm_backward_under_vmap_matches_the_loop(n, w_batched):
    """``vmap(grad(...))`` over a leading dim of 1 and 2, with the weight
    shared (the rule folds the dim into rows) or per index (one launch per
    index): each index gets its own gradients."""
    from torch.func import grad, vmap
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(n, 4, 3, 128).astype(np.float32))
    w = torch.from_numpy(rng.randn(*((n, 128) if w_batched else (128,))).astype(np.float32))
    g = torch.from_numpy(rng.randn(n, 4, 3, 128).astype(np.float32))

    def f(x, w, g):
        return (ops.rmsnorm(x, w) * g).sum()
    got = vmap(grad(f, argnums=(0, 1)), in_dims=(0, 0 if w_batched else None, 0))(x, w, g)
    for i in range(n):
        want = grad(f, argnums=(0, 1))(x[i], w[i] if w_batched else w, g[i])
        torch.testing.assert_close(got[0][i], want[0], atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(got[1][i], want[1], atol=1e-6, rtol=1e-6)
