"""The port's flash-attention forward (``repro_torch/kernels/flash_attention``)
against the JAX package's, on the same numpy inputs.

On the CPU the port's wrapper takes the kernel's plain version (a port of
``ops._blockwise_fwd``); the CUDA kernel against it is in
``test_torch_gpu.py``, on the card.

Tolerances (``tests/test_kernels.py``): 2e-5 in f32; 2e-2 in bf16, where
the Pallas kernel keeps scores and probabilities in f32 and the plain
version rounds the bf16 products to bf16, as ``_blockwise_fwd`` does.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_fwd as pallas_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref


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


DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
KERNEL_SHAPES = [
    (2, 128, 128, 4, 4, 64, 64),      # MHA
    (1, 256, 256, 8, 2, 64, 64),      # GQA
    (2, 128, 256, 4, 1, 32, 32),      # MQA, Sq != Sk
    (1, 128, 128, 4, 2, 96, 64),      # MLA dims (Dk != Dv)
]


def _inputs(B, Sq, Sk, H, KV, Dk, Dv, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, H, Dk).astype(np.float32),
            rng.randn(B, Sk, KV, Dk).astype(np.float32),
            rng.randn(B, Sk, KV, Dv).astype(np.float32))


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,Dk,Dv", KERNEL_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_pallas_interpret(B, Sq, Sk, H, KV, Dk, Dv, dtype, causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, Sq, Sk, H, KV, Dk, Dv), dtype)
    offset = Sk - Sq
    want = pallas_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                        q_offset=offset, interpret=True)
    before = (fa.flash_attention_fwd.launches, dict(fa.flash_attention_fwd.launches_by_shape))
    got = ops.flash_attention(tq, tk, tv, offset, causal)
    # CPU tensors never launch
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_fwd.launches_by_shape) == before
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, Sq, H, Dv)
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("B,Sq,Sk,H,KV,Dk,Dv", KERNEL_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block", [64, 512])
def test_flash_out_and_lse_match_blockwise_fwd(B, Sq, Sk, H, KV, Dk, Dv, causal, block):
    """(out, lse) against the JAX package's ``_blockwise_fwd`` (blocks of 64),
    with the port's plain version in blocks of 64 and of 512 (one block)."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, Sq, Sk, H, KV, Dk, Dv, seed=1), "f32")
    offset = Sk - Sq
    scale = 1.0 / np.sqrt(Dk)
    want_o, want_lse = jops._blockwise_fwd(jq, jk, jv, causal, offset, scale, 64, 64)
    got_o, got_lse = fa.plain(tq, tk, tv, offset, causal, None, block, block)
    assert tuple(got_lse.shape) == (B, H, Sq) and got_lse.dtype == torch.float32
    _close(got_o, want_o, 2e-5)
    _close(got_lse, want_lse, 2e-5)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal", [
    (1, 100, 100, 4, 2, 32, True),     # Sq, Sk not a whole number of blocks
    (2, 70, 200, 4, 1, 64, True),      # q_offset 130, ragged both
    (2, 70, 200, 4, 1, 64, False),
    (1, 33, 33, 7, 1, 16, True),       # G = 7, not a power of two
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_ragged_matches_ref(B, Sq, Sk, H, KV, D, causal, dtype):
    """Ragged lengths (the JAX kernels need whole blocks): the port's plain
    version in blocks of 32 against the JAX package's unblocked oracle."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, Sq, Sk, H, KV, D, D, seed=2), dtype)
    offset = Sk - Sq
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, q_offset=offset)
    got, lse = fa.plain(tq, tk, tv, offset, causal, None, 32, 32)
    tol = DTYPES[dtype][2]
    _close(got, want, tol)
    _close(ref.flash_attention_ref(tq, tk, tv, causal=causal, q_offset=offset), want, tol)
    assert torch.isfinite(lse).all()


@pytest.mark.parametrize("Dk,Dv,scale", [(24, 16, 16 ** -0.5), (288, 256, 96 ** -0.5)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_at_mla_head_dims_matches_ref(Dk, Dv, scale, dtype, causal):
    """MLA's absorbed head dims, reduced minicpm3-4b's (24, 16) and the full
    (288, 256), as MQA (5 query heads on one kv head) with MLA's scale
    1/sqrt(nope + rope), ragged Sq and Sk and q_offset 60: the port's plain
    version in blocks of 32 against the JAX package's unblocked oracle."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(2, 40, 100, 5, 1, Dk, Dv, seed=3), dtype)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, q_offset=60, scale=scale)
    got, lse = fa.plain(tq, tk, tv, 60, causal, scale, 32, 32)
    assert tuple(got.shape) == (2, 40, 5, Dv) and tuple(lse.shape) == (2, 5, 40)
    _close(got, want, DTYPES[dtype][2])
    _close(ops.flash_attention(tq, tk, tv, 60, causal, scale), want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype,Dk,Dv,kernel", [
    (torch.bfloat16, 128, 128, "wgmma"),     # yi-34b, the serve path
    (torch.bfloat16, 64, 64, "wgmma"),
    (torch.bfloat16, 128, 64, "wgmma"),      # Dk != Dv
    (torch.bfloat16, 64, 128, "wgmma"),
    (torch.bfloat16, 96, 64, "wgmma"),       # MLA expanded: two Q/K panels
    (torch.bfloat16, 32, 32, "wgmma"),
    (torch.bfloat16, 20, 20, "tf32x3"),      # not a multiple of 8: no tensor map
    (torch.bfloat16, 16, 16, "wgmma"),       # reduced yi-34b
    (torch.bfloat16, 288, 256, "wgmma"),     # MLA absorbed (minicpm3-4b)
    (torch.bfloat16, 256, 288, "tf32x3"),    # Dv above the wgmma tiles' 256
    (torch.bfloat16, 288, 288, "tf32x3"),
    (torch.bfloat16, 24, 16, "wgmma"),       # reduced minicpm3-4b absorbed
    (torch.float32, 288, 256, "tf32x3"),
    (torch.float32, 128, 128, "tf32x3"),     # f32 on the tensor cores in three passes
    (torch.float32, 64, 64, "tf32x3"),
])
def test_flash_dispatch_by_dtype_and_head_dims(dtype, Dk, Dv, kernel):
    """Which kernel a CUDA call launches depends on dtype and head dims only."""
    assert fa.launch_plan(dtype, Dk, Dv).kernel == kernel


def _config_head_dims():
    """(Dk, Dv) of every attention the configs give, full and reduced: the
    port's for the archs it runs, the JAX package's for the rest (whisper,
    xlstm, jamba); MLA in both its forms."""
    from repro.configs import base as jbase
    from repro.configs.reduce import reduced_config as jreduced
    from repro_torch.configs.base import get_config
    from repro_torch.configs.reduce import reduced_config
    dims = set()
    for arch in jbase.ARCHS:
        try:
            full = get_config(arch)
            cfgs = (full, reduced_config(full))
        except NotImplementedError:
            full = jbase.get_config(arch)
            cfgs = (full, jreduced(full))
        for c in cfgs:
            if c.attn_type == "mla":
                m = c.mla
                dims.add((m.kv_lora_rank + m.qk_rope_head_dim, m.kv_lora_rank))
                dims.add((m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim))
            else:
                dims.add((c.resolved_head_dim, c.resolved_head_dim))
    return sorted(dims)


CONFIG_HEAD_DIMS = _config_head_dims()
# the head dims of test_torch_gpu.py's kernel tests
GPU_TEST_HEAD_DIMS = [(64, 64), (32, 32), (96, 64), (128, 128), (16, 16), (20, 20),
                      (288, 256), (128, 64), (64, 128), (24, 16), (192, 192), (288, 288)]


def _wgmma_holds(Dk, Dv):
    return any(Dk <= 16 * ks and Dv <= 64 * dvp for ks, dvp in fa.WGMMA_TILES)


@pytest.mark.parametrize("Dk,Dv", sorted(set(CONFIG_HEAD_DIMS + GPU_TEST_HEAD_DIMS)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_plan_puts_every_config_on_the_tensor_cores(dtype, Dk, Dv):
    plan = fa.launch_plan(dtype, Dk, Dv)
    assert plan.kernel in ("wgmma", "tf32x3") and plan.kernel in fa.SOURCES
    assert 0 < plan.smem_bytes <= 232_448
    assert plan.tile_dims[0] >= Dk and plan.tile_dims[1] >= Dv
    to_wgmma = dtype == torch.bfloat16 and Dk % 8 == 0 and Dv % 8 == 0 and _wgmma_holds(Dk, Dv)
    assert (plan.kernel == "wgmma") == to_wgmma
    assert plan.fill == ("tma" if to_wgmma else "cp.async")
    # the tile the C entry point is told to launch: the first of its
    # kernel's list that holds the dims
    if to_wgmma:
        holds = [Dk <= 16 * ks and Dv <= 64 * dvp for ks, dvp in fa.WGMMA_TILES]
    else:
        holds = [Dk <= dk and Dv <= dv for dk, dv, _, _ in fa.TF32X3_TILES]
    assert plan.tile == holds.index(True)


def test_every_config_head_dim_takes_wgmma_in_bf16():
    """The wgmma tiles hold every (Dk, Dv) of the configs: 128/128, 64/64,
    MLA's 288/256 and 96/64, the reduced 16/16, 24/16 and MLA's 16/8."""
    assert {(128, 128), (64, 64), (288, 256), (96, 64), (16, 16), (24, 16)} <= \
        set(CONFIG_HEAD_DIMS)
    for Dk, Dv in CONFIG_HEAD_DIMS:
        assert fa.launch_plan(torch.bfloat16, Dk, Dv).kernel == "wgmma", (Dk, Dv)


@pytest.mark.parametrize("dtype,Dk,Dv", [
    (torch.float32, 320, 320), (torch.float32, 289, 64), (torch.bfloat16, 64, 296),
    (torch.float32, 0, 16), (torch.bfloat16, 16, 0), (torch.float16, 64, 64)])
def test_launch_plan_refuses_what_no_kernel_takes(dtype, Dk, Dv):
    with pytest.raises(NotImplementedError, match="no kernel takes"):
        fa.launch_plan(dtype, Dk, Dv)


@pytest.mark.parametrize("Dk,Dv", [(128, 128), (96, 64), (288, 256), (16, 16), (24, 16)])
def test_launch_plan_for_the_tf32x3_kernel_at_the_wgmma_dims(Dk, Dv):
    """Asked for the tf32x3 kernel, bf16 at the wgmma kernel's dims gets the
    tf32x3 kernel's own tile (chip_smoke.py times the two side by side), the
    same one f32 takes, with bf16's shared bytes."""
    plan = fa.launch_plan(torch.bfloat16, Dk, Dv, "tf32x3")
    f32 = fa.launch_plan(torch.float32, Dk, Dv)
    assert plan.kernel == f32.kernel == "tf32x3" and plan.tile == f32.tile
    assert plan.fill == "cp.async" and plan.smem_bytes < f32.smem_bytes <= 232_448
    assert fa.launch_plan(torch.bfloat16, Dk, Dv).kernel == "wgmma"
    with pytest.raises(NotImplementedError, match="no kernel takes"):
        fa.launch_plan(torch.float32, Dk, Dv, "wgmma")


def test_tile_tables_are_the_sources_own():
    """The plan's tile lists are the ones the C entry points try, in order."""
    import pathlib
    import re
    csrc = pathlib.Path(fa.__file__).resolve().parents[1] / "csrc"

    def table(name, macro):
        text = (csrc / f"{name}.cu").read_text()
        body = re.search(rf"#define {macro}\(X\)((?:[^\n]*\\\n)*[^\n]*)", text).group(1)
        return tuple(tuple(int(x) for x in m.split(",")) for m in
                     re.findall(r"X\(([\d, ]+)\)", body))
    assert table("flash_attention_wgmma", "FA_WGMMA_TILES") == fa.WGMMA_TILES
    assert table("flash_attention", "FA_TF32X3_TILES") == fa.TF32X3_TILES
    assert fa.SOURCES == {"wgmma": "flash_attention_wgmma", "tf32x3": "flash_attention"}
    assert set(fa.flash_attention_fwd.launches_by_kernel) == set(fa.SOURCES)


# -- the precision argument for the tf32x3 kernel, on the CPU ----------------
# Each f32 operand is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi)
# (round to nearest, ties away, to TF32's 10 mantissa bits, by bit masking)
# and each product taken as lo*hi + hi*lo + hi*hi, summed in f32: what the
# tensor cores compute (TF32 products are exact in f32). One pass is hi*hi.

def _rna_tf32(x):
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_matmul(a, b, passes):
    ah, bh = _rna_tf32(a), _rna_tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _rna_tf32(a - ah), _rna_tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _tf32_attention(q, k, v, q_offset, causal, scale, passes):
    """Attention with both products in TF32 (``passes`` 1 or 3), softmax in
    f32 -> (out, lse)."""
    B, Sq, H, Dk = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qh = q.permute(0, 2, 1, 3)
    kh = k.permute(0, 2, 3, 1).repeat_interleave(G, dim=1)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    s = _tf32_matmul(qh, kh, passes) * scale
    if causal:
        ok = q_offset + torch.arange(Sq)[:, None] >= torch.arange(Sk)[None]
        s = torch.where(ok, s, torch.tensor(-1e30))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return (_tf32_matmul(p, vh, passes) / l).permute(0, 2, 1, 3), (m + torch.log(l))[..., 0]


TF32_SHAPES = [  # B, Sq, Sk, H, KV, Dk, Dv, scale (None: 1/sqrt(Dk))
    *[(*shape, None) for shape in KERNEL_SHAPES],
    (2, 40, 100, 5, 1, 288, 256, 96 ** -0.5),    # MLA absorbed: raw scores ~17
    (1, 64, 64, 40, 1, 288, 256, 96 ** -0.5),    # 40 heads on one kv head
    (2, 100, 100, 8, 8, 96, 64, 96 ** -0.5),     # MLA expanded
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,Dk,Dv,scale", TF32_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_three_tf32_passes_hold_f32_to_its_tolerance(B, Sq, Sk, H, KV, Dk, Dv, scale, causal):
    q, k, v = (torch.from_numpy(a) for a in _inputs(B, Sq, Sk, H, KV, Dk, Dv, seed=8))
    scale = scale or Dk ** -0.5
    want, want_lse = fa.plain(q, k, v, Sk - Sq, causal, scale)
    got, lse = _tf32_attention(q, k, v, Sk - Sq, causal, scale, passes=3)
    _close(got, want, 2e-5)
    _close(lse, want_lse, 2e-5)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,Dk,Dv,scale", TF32_SHAPES[-3:])
def test_one_tf32_pass_misses_f32(B, Sq, Sk, H, KV, Dk, Dv, scale):
    """Why three passes: one TF32 pass misses the f32 tolerance by ~50x at
    MLA's shapes (and at every f32 test shape)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(B, Sq, Sk, H, KV, Dk, Dv, seed=8))
    want, _ = fa.plain(q, k, v, Sk - Sq, True, scale)
    got, _ = _tf32_attention(q, k, v, Sk - Sq, True, scale, passes=1)
    assert (q.reshape(-1, Dk)[:1] @ k.reshape(-1, Dk).T).abs().max() > 10   # raw scores
    with pytest.raises(AssertionError):
        _close(got, want, 2e-5)
    assert (got - want).abs().max() > 20 * 2e-5


def test_flash_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match="disagree"):
        fa.flash_attention_fwd(q, k, k)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention_fwd(q, q, q, -1)
    # meta is a dry run's device: its branch refuses what the card's does
    m = torch.zeros(1, 4, 8, 16, device="meta").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(m, m, m)


# -- the backward: ops.flash_attention under autograd and torch.func ---------
# Against jax.grad of the JAX package's differentiable flash attention (its
# jnp path: _blockwise_fwd under the custom_vjp whose backward is
# _blockwise_bwd), at tests/test_kernels.py:68's shape and around it.
# Tolerance that of test_kernels.py's backward test: atol = rtol = 1e-4 (f32).

BWD_SHAPES = [  # B, Sq, Sk, H, KV, Dk, Dv
    (1, 64, 64, 4, 2, 32, 32),        # tests/test_kernels.py:68
    (2, 64, 128, 4, 1, 32, 32),       # q_offset 64
    (1, 64, 64, 4, 2, 48, 32),        # Dk != Dv
    (1, 100, 100, 6, 2, 16, 16),      # ragged S (one block on both sides)
]


def _jax_grads(arrays, dout, offset, causal):
    jq, jk, jv = (jnp.asarray(a) for a in arrays)

    def f(q, k, v):
        return (jops.flash_attention(q, k, v, offset, causal) * jnp.asarray(dout)).sum()
    return jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,Dk,Dv", BWD_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_matches_the_jax_custom_vjp(B, Sq, Sk, H, KV, Dk, Dv, causal):
    arrays = _inputs(B, Sq, Sk, H, KV, Dk, Dv, seed=3)
    dout = np.random.RandomState(4).randn(B, Sq, H, Dv).astype(np.float32)
    offset = Sk - Sq
    want = _jax_grads(arrays, dout, offset, causal)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
    before = fa.flash_attention_fwd.launches
    out = ops.flash_attention(q, k, v, offset, causal)
    (out * torch.from_numpy(dout)).sum().backward()
    assert fa.flash_attention_fwd.launches == before    # CPU tensors never launch
    for got, w in zip((q.grad, k.grad, v.grad), want):
        _close(got, w, 1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_in_short_kv_blocks_matches(causal):
    """``plain_bwd`` over several kv blocks with a short last one (and, under
    the causal mask, blocks that skip their first q rows) against the JAX
    backward in one block."""
    B, Sq, Sk, H, KV, D = 1, 70, 100, 4, 2, 16
    arrays = _inputs(B, Sq, Sk, H, KV, D, D, seed=5)
    dout = np.random.RandomState(6).randn(B, Sq, H, D).astype(np.float32)
    want = _jax_grads(arrays, dout, Sk - Sq, causal)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    out, lse = fa.plain(q, k, v, Sk - Sq, causal)
    got = fa.plain_bwd(q, k, v, out, lse, torch.from_numpy(dout), Sk - Sq, causal,
                       block_k=32)
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


@pytest.mark.parametrize("n", [1, 2])
def test_flash_backward_under_vmap_matches_the_loop(n):
    """``vmap(grad(...))`` over a leading dim of 1 and 2 (the rule folds it
    into B) gives each index its own gradients."""
    from torch.func import grad, vmap
    B, S, H, KV, D = 2, 48, 4, 2, 16
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rng.randn(n, B, S, h, D).astype(np.float32))
               for h in (H, KV, KV))
    dout = torch.from_numpy(rng.randn(n, B, S, H, D).astype(np.float32))

    def f(q, k, v, d):
        return (ops.flash_attention(q, k, v, 0, True) * d).sum()
    got = vmap(grad(f, argnums=(0, 1, 2)))(q, k, v, dout)
    for i in range(n):
        want = grad(f, argnums=(0, 1, 2))(q[i], k[i], v[i], dout[i])
        for g, w in zip(got, want):
            torch.testing.assert_close(g[i], w, atol=1e-6, rtol=1e-6)


# -- the backward's route: the kernel for bf16 at head dims 64 and 128 -------

@pytest.mark.parametrize("dtype,Dk,Dv,kernel", [
    (torch.bfloat16, 128, 128, "wgmma"),     # yi-34b, qwen2.5, chameleon, qwen3-moe, jamba
    (torch.bfloat16, 64, 64, "wgmma"),       # whisper-base
    (torch.bfloat16, 128, 64, "wgmma"),
    (torch.bfloat16, 64, 128, "wgmma"),
    (torch.float32, 128, 128, "plain"),      # the tf32x3 configs
    (torch.float32, 64, 64, "plain"),
    (torch.bfloat16, 288, 256, "plain"),     # MLA absorbed
    (torch.bfloat16, 96, 64, "plain"),       # MLA expanded
    (torch.bfloat16, 16, 16, "plain"),       # the reduced configs
    (torch.bfloat16, 24, 16, "plain"),
])
def test_bwd_plan_routes_by_dtype_and_head_dims(dtype, Dk, Dv, kernel):
    assert fa.bwd_plan(dtype, Dk, Dv) == kernel
    assert (kernel == "wgmma") == ((Dk, Dv) in fa.BWD_DIMS and dtype == torch.bfloat16)


def test_bwd_dims_are_the_sources_own():
    """``BWD_DIMS`` is the list the C entry point launches, and
    ``BWD_PAD`` the padding of the workspaces the kernels read."""
    import pathlib
    import re
    text = (pathlib.Path(fa.__file__).resolve().parents[1] / "csrc" /
            f"{fa.BWD_SOURCE}.cu").read_text()
    body = re.search(r"#define FA_BWD_DIMS\(X\)([^\n]*)", text).group(1)
    assert tuple(tuple(int(x) for x in m.split(",")) for m in
                 re.findall(r"X\(([\d, ]+)\)", body)) == fa.BWD_DIMS
    assert int(re.search(r"constexpr int kPad = (\d+);", text).group(1)) == fa.BWD_PAD
    assert set(fa.flash_attention_bwd.launches_by_kernel) == {"wgmma", "plain"}


def _bwd_args(B, Sq, Sk, H, KV, Dk, Dv, dtype, device):
    q, k, v = (torch.zeros(s, dtype=dtype, device=device) for s in
               ((B, Sq, H, Dk), (B, Sk, KV, Dk), (B, Sk, KV, Dv)))
    out = torch.zeros((B, Sq, H, Dv), dtype=dtype, device=device)
    lse = torch.zeros((B, H, Sq), dtype=torch.float32, device=device)
    return q, k, v, out, lse, out.clone()


@pytest.mark.parametrize("Dk,Dv,dtype", [(128, 128, torch.bfloat16), (64, 128, torch.bfloat16),
                                         (288, 256, torch.bfloat16), (64, 64, torch.float32)])
def test_backward_on_meta_gives_the_shapes_and_counts_no_launch(Dk, Dv, dtype):
    """A dry run's backward: the gradients' shapes and dtypes, no launch
    counted; the kernel's route records ``bwd_cost``, the plain route its
    torch ops."""
    from repro_torch.launch import op_cost
    B, Sq, Sk, H, KV = 2, 40, 100, 8, 2
    args = _bwd_args(B, Sq, Sk, H, KV, Dk, Dv, dtype, "meta")
    before = (fa.flash_attention_bwd.launches, dict(fa.flash_attention_bwd.launches_by_kernel))
    with op_cost.cost_scope() as c:
        dq, dk, dv = fa.flash_attention_bwd(*args, Sk - Sq, True)
    for g, t in zip((dq, dk, dv), args[:3]):
        assert g.device.type == "meta" and g.shape == t.shape and g.dtype == t.dtype
    assert (fa.flash_attention_bwd.launches,
            fa.flash_attention_bwd.launches_by_kernel) == before
    if fa.bwd_plan(dtype, Dk, Dv) == "wgmma":
        e = c.by_kernel["flash_attention_bwd"]
        assert e["launches"] == 1 and (e["flops"], e["bytes"]) == fa.bwd_cost(
            B, Sq, Sk, H, KV, Dk, Dv, Sk - Sq, True, 2)
    else:
        assert "flash_attention_bwd" not in c.by_kernel and c.flops > 0


def test_backward_through_autograd_on_meta_counts_no_launch():
    """``ops.flash_attention`` differentiated on the meta device (a dry
    run's train step) at yi-34b's head dims: shapes, and nothing counted."""
    q, k, v = (torch.zeros(s, dtype=torch.bfloat16, device="meta", requires_grad=True)
               for s in ((1, 64, 8, 128), (1, 64, 2, 128), (1, 64, 2, 128)))
    before = fa.flash_attention_bwd.launches
    grads = torch.autograd.grad(ops.flash_attention(q, k, v).float().sum(), (q, k, v))
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert fa.flash_attention_bwd.launches == before


def test_backward_kernel_refuses_what_it_does_not_take():
    args = _bwd_args(1, 16, 16, 4, 2, 128, 128, torch.bfloat16, "meta")
    with pytest.raises(ValueError, match="lse"):
        fa._launch_bwd(*args[:4], args[4][..., :8], args[5], 0, True, None)
    with pytest.raises(ValueError, match="contiguous"):
        fa._launch_bwd(*args[:5], args[5].transpose(1, 2).contiguous().transpose(1, 2),
                       0, True, None)
    with pytest.raises(ValueError, match="out and dout"):
        fa._launch_bwd(*args[:3], args[3].float(), *args[4:], 0, True, None)


def test_cpu_backward_takes_plain_and_counts_nothing():
    """CPU tensors never reach the kernel, whatever their head dims."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(1, 32, 32, 4, 2, 128, 128, seed=11))
    out, lse = fa.plain(q, k, v)
    dout = torch.from_numpy(np.random.RandomState(12).randn(1, 32, 4, 128)).to(torch.bfloat16)
    before = (fa.flash_attention_bwd.launches, dict(fa.flash_attention_bwd.launches_by_kernel))
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout)
    want = fa.plain_bwd(q, k, v, out, lse, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (fa.flash_attention_bwd.launches,
            fa.flash_attention_bwd.launches_by_kernel) == before
