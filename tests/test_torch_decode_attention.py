"""The port's decode attention (``repro_torch/kernels/decode_attention``)
against the JAX package's, on the same numpy inputs.

On the CPU the port's wrapper takes the kernel's plain version (a port of
``ops._decode_blockwise``); the CUDA kernel against it is in
``test_torch_gpu.py``, on the card.

Tolerances (``tests/test_kernels.py``): 2e-5 in f32; 2e-2 in bf16, where
the Pallas kernel keeps scores in f32 and the plain version rounds the bf16
products to bf16, as ``_decode_blockwise`` does.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_fwd as pallas_decode
from repro_torch.kernels import decode_attention as da
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


def _inputs(B, S, H, KV, Dk, Dv, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, Dk).astype(np.float32),
            rng.randn(B, S, KV, Dk).astype(np.float32),
            rng.randn(B, S, KV, Dv).astype(np.float32))


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,KV,D", [(2, 256, 8, 2, 64), (1, 512, 4, 4, 128),
                                        (3, 128, 8, 1, 32)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_matches_pallas_interpret(B, S, H, KV, D, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, S, H, KV, D, D), dtype)
    length = np.random.RandomState(3).randint(1, S + 1, (B,)).astype(np.int32)
    o, m, l = pallas_decode(jq, jk, jv, jnp.asarray(length), block_k=64, interpret=True)
    want = np.asarray(o) / np.maximum(np.asarray(l)[..., None], 1e-30)
    before = (da.decode_attention_fwd.launches, dict(da.decode_attention_fwd.launches_by_shape))
    go, gm, gl = ops.decode_attention(tq, tk, tv, torch.from_numpy(length), combine=False)
    # CPU tensors never launch
    assert (da.decode_attention_fwd.launches, da.decode_attention_fwd.launches_by_shape) == before
    assert all(t.dtype == torch.float32 for t in (go, gm, gl))
    tol = DTYPES[dtype][2]
    _close(go / torch.clamp(gl, min=1e-30)[..., None], want, tol)
    combined = ops.decode_attention(tq, tk, tv, torch.from_numpy(length))
    assert combined.dtype == tq.dtype
    _close(combined, want, tol)
    if dtype == "f32":
        _close(gm, m, 2e-5)
        _close(gl, l, 2e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_length_zero_row_keeps_the_kernel_conventions(dtype):
    """m = -1e30, l = 0, o = 0 for a row with length 0 (the Pallas kernel's
    values), next to a partial and a full row."""
    B, S, H, KV, D = 3, 128, 8, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, S, H, KV, D, D, seed=4), dtype)
    length = np.array([0, 37, S], np.int32)
    o, m, l = pallas_decode(jq, jk, jv, jnp.asarray(length), block_k=64, interpret=True)
    go, gm, gl = ops.decode_attention(tq, tk, tv, torch.from_numpy(length), combine=False)
    assert (gm[0] == -1e30).all() and (gl[0] == 0).all() and (go[0] == 0).all()
    np.testing.assert_array_equal(gm[0].numpy(), np.asarray(m)[0])
    np.testing.assert_array_equal(gl[0].numpy(), np.asarray(l)[0])
    want = np.asarray(o)[1:] / np.asarray(l)[1:, :, None]
    _close((go / torch.clamp(gl, min=1e-30)[..., None])[1:], want, DTYPES[dtype][2])


@pytest.mark.parametrize("S,block", [(200, 64), (600, 512), (2112 // 4, 512), (77, 512)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_ragged_cache_matches_ref(S, block, dtype):
    """Any S: the last block is short (the JAX path needs S % block == 0).
    The plain version against the JAX package's unblocked oracle."""
    B, H, KV, D = 2, 14, 2, 16                  # G = 7, as yi-34b
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, S, H, KV, D, D, seed=5), dtype)
    length = np.array([S, max(1, S - 45)], np.int32)
    want, wm, wl = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(length),
                                             return_stats=True)
    o, m, l = da.plain(tq, tk, tv, torch.from_numpy(length), None, block)
    tol = DTYPES[dtype][2]
    _close(o / l[..., None], want, tol)
    _close(ref.decode_attention_ref(tq, tk, tv, torch.from_numpy(length)), want, tol)
    if dtype == "f32":
        _close(m, wm, 2e-5)
        _close(l, wl, 2e-5)
        rm = ref.decode_attention_ref(tq, tk, tv, torch.from_numpy(length),
                                      return_stats=True)
        _close(rm[1], wm, 2e-5)
        _close(rm[2], wl, 2e-5)


def test_decode_lse_combine_across_shards():
    """Chunk-parallel decode (``tests/test_kernels.py``): combining per-shard
    (o, m, l) == full attention, including shards a row never reaches."""
    B, S, H, KV, D = 2, 256, 8, 2, 64
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, S, H, KV, D, D, seed=6), "f32")
    length = np.array([200, 256], np.int32)
    nsh, n = 4, S // 4
    chunks = []
    for i in range(nsh):
        clen = torch.from_numpy(np.clip(length - i * n, 0, n).astype(np.int32))
        chunks.append(ops.decode_attention(tq, tk[:, i * n:(i + 1) * n].contiguous(),
                                           tv[:, i * n:(i + 1) * n].contiguous(), clen,
                                           combine=False))
    m_glob = torch.stack([m for _, m, _ in chunks]).amax(0)
    l_glob = sum(l * torch.exp(m - m_glob) for _, m, l in chunks)
    o_glob = sum(o * torch.exp(m - m_glob)[..., None] for o, m, _ in chunks)
    got = o_glob / torch.clamp(l_glob, min=1e-30)[..., None]
    want = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(length))
    _close(got, want, 2e-5)


def test_decode_rejects_what_the_kernel_does_not_take():
    q, k = torch.zeros(2, 8, 16), torch.zeros(2, 32, 2, 16)
    with pytest.raises(TypeError, match="int32"):
        da.decode_attention_fwd(q, k, k, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="disagree"):
        da.decode_attention_fwd(q, k, k, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="disagree"):
        da.decode_attention_fwd(q, torch.zeros(2, 32, 3, 16), torch.zeros(2, 32, 3, 16),
                                torch.zeros(2, dtype=torch.int32))
    # meta is a dry run's device: its branch refuses what the card's does
    mq, mk = q.to("meta"), k.to("meta").transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention_fwd(mq, mk, mk, torch.zeros(2, dtype=torch.int32,
                                                        device="meta"))


@pytest.mark.parametrize("chunk,S", [(64, 256), (da.CHUNK, 2 * da.CHUNK)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_split_and_combine_matches_plain_and_pallas(chunk, S, dtype):
    """The kernel's split over chunks of keys and its log-sum-exp combine
    (``plain_split``) against one pass (``plain``) and the Pallas kernel,
    at the chunk's boundary lengths, G = 7."""
    lengths = np.array([0, 1, chunk - 1, chunk, chunk + 1, S], np.int32)
    B, H, KV, D = len(lengths), 14, 2, 16
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, S, H, KV, D, D, seed=7), dtype)
    tlen = torch.from_numpy(lengths)
    so, sm, sl = da.plain_split(tq, tk, tv, tlen, chunk)
    po, pm, pl = da.plain(tq, tk, tv, tlen)
    assert (sm[0] == -1e30).all() and (sl[0] == 0).all() and (so[0] == 0).all()
    tol = DTYPES[dtype][2]
    _close(sm, pm, tol)
    _close(sl, pl, tol)
    _close((so / sl[..., None])[1:], (po / pl[..., None])[1:], tol)
    o, m, l = pallas_decode(jq, jk, jv, jnp.asarray(lengths), block_k=64, interpret=True)
    want = np.asarray(o)[1:] / np.asarray(l)[1:, :, None]
    _close((so / sl[..., None])[1:], want, tol)
    np.testing.assert_array_equal(sm[0].numpy(), np.asarray(m)[0])
    np.testing.assert_array_equal(sl[0].numpy(), np.asarray(l)[0])
    if dtype == "f32":
        _close(sm, m, 2e-5)
        _close(sl, l, 2e-5)


def test_decode_combine_of_empty_parts_is_the_empty_row():
    """Every part empty (a length-0 row) -> exactly m = -1e30, l = 0, o = 0."""
    empty = (torch.zeros(2, 3, 8), torch.full((2, 3), -1e30), torch.zeros(2, 3))
    o, m, l = da.combine([empty, empty, empty])
    assert (m == -1e30).all() and (l == 0).all() and (o == 0).all()
