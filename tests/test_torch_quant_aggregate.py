"""The port's int8 aggregation (``repro_torch/kernels``) against the JAX
package's, on the same numpy inputs.

Tolerances:
- bitwise against the JAX fused path run op by op (not jitted): both
  accumulate ``(q * scale) * w`` in client order, one rounding per op;
- rtol 1e-5 / atol 1e-6 against ``ref.quant_aggregate_ref`` and the Pallas
  kernel in interpret mode, which sum the clients in another order (the
  tolerance ``tests/test_kernels.py`` holds those two to);
- bitwise within the port: fused == dequant-first (the CUDA kernel against
  its plain version is in ``test_torch_gpu.py``, on the card).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.quant_aggregate import quant_aggregate as pallas_quant_agg
from repro_torch.kernels import ops
from repro_torch.kernels import quant_aggregate as qa
from repro_torch.kernels import ref


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


SHAPES = [(4, 8192, 256), (10, 4096, 128), (32, 16384, 512),
          # N not a multiple of the Pallas tile (4096)
          (5, 1280, 256), (5, 4096 + 128, 128), (5, 512, 512)]


def _inputs(C, N, qblock, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randint(-127, 128, (C, N)).astype(np.int8)
    s = rng.uniform(1e-4, 1e-2, (C, N // qblock)).astype(np.float32)
    w = rng.uniform(0, 1, (C,)).astype(np.float32)
    return q, s, (w / w.sum()).astype(np.float32)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("C,N,qblock", SHAPES)
def test_plain_equals_jax_fused_bitwise(C, N, qblock):
    q, s, w = _inputs(C, N, qblock)
    want = np.asarray(jops._quant_agg_fused(jnp.asarray(q), jnp.asarray(s),
                                            jnp.asarray(w)))
    got = qa.plain(*_torch(q, s, w)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("C,N,qblock", SHAPES)
def test_plain_close_to_jax_ref_and_pallas_interpret(C, N, qblock):
    q, s, w = _inputs(C, N, qblock, seed=1)
    got = qa.plain(*_torch(q, s, w)).numpy()
    jq, js, jw = jnp.asarray(q), jnp.asarray(s), jnp.asarray(w)
    np.testing.assert_allclose(got, np.asarray(jref.quant_aggregate_ref(jq, js, jw)),
                               rtol=1e-5, atol=1e-6)
    # the Pallas wrapper wants N % block_n == 0: the largest multiple of
    # qblock dividing N, at most 4096
    block_n = max(b for b in range(qblock, min(N, 4096) + 1, qblock) if N % b == 0)
    pallas = pallas_quant_agg(jq, js, jw, block_n=block_n, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, ref.quant_aggregate_ref(*_torch(q, s, w)).numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("C,N,qblock", [(4, 8192, 256), (7, 4096, 128),
                                        (1, 2048, 256)])
def test_fused_equals_dequant_first_bitwise(C, N, qblock):
    q, s, w = _torch(*_inputs(C, N, qblock, seed=2))
    assert torch.equal(ops._quant_agg_fused(q, s, w),
                       ops._quant_agg_dequant_first(q, s, w))


@pytest.mark.parametrize("n,block", [(8192, 256), (4096, 128)])
def test_quantize_blockwise_equals_jax_bitwise(n, block):
    rng = np.random.RandomState(3)
    x = (rng.randn(n) * np.repeat(rng.uniform(1e-4, 10, n // block), block))
    x = x.astype(np.float32)
    x[:block] = 0.0                                 # an all-zero block: scale 1
    x[block:2 * block] = np.round(x[block:2 * block])  # exact values, ties
    jq, js = jref.quantize_blockwise_ref(jnp.asarray(x), block=block)
    q, s = ops.quantize_blockwise(torch.from_numpy(x), block=block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # a leading client dim quantizes each row on its own
    qb, sb = ops.quantize_blockwise(torch.from_numpy(np.stack([x, -x])), block=block)
    assert torch.equal(qb[0], q) and torch.equal(qb[1], -q) and torch.equal(sb[1], s)


def test_dispatcher_counts_calls_and_takes_plain_on_cpu():
    q, s, w = _torch(*_inputs(3, 1024, 256))
    launches = (qa.quant_aggregate.launches, dict(qa.quant_aggregate.launches_by_shape))
    with ops.quant_agg_scope() as frame:
        for _ in range(3):
            out = ops.quant_aggregate(q, s, w)
    assert frame["calls"] == 3 and frame["last_impl"] == "plain"
    # no kernel on the CPU
    assert (qa.quant_aggregate.launches, qa.quant_aggregate.launches_by_shape) == launches
    assert torch.equal(out, qa.plain(q, s, w))
    ops.reset_quant_agg_stats()
    ops.quant_aggregate(q, s, w)
    assert ops.quant_agg_stats()["calls"] == 1


@pytest.mark.parametrize("bad", ["dtype", "qblock", "rank", "clients"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, s, w = _torch(*_inputs(2, 1024, 256))
    if bad == "dtype":
        q = q.to(torch.int16)
    elif bad == "qblock":
        s = torch.ones((2, 1024 // 8))          # qblock 8, not a multiple of 16
    elif bad == "rank":
        q = q[None]
    else:
        w = w[:1]
    with pytest.raises((TypeError, ValueError)):
        qa.quant_aggregate(q, s, w)


# -- the kernel's launch geometry (kernels/quant_aggregate.launch_plan) -----
# chip_smoke.py's KERNEL_SHAPES: the FL path, BENCH_agg, a ragged tail, one client
KERNEL_SHAPES = [(100, 189_952, 256), (16, 1_048_576, 256), (7, 4_224, 128),
                 (1, 189_952, 256)]


@pytest.mark.parametrize("C,N,qblock", KERNEL_SHAPES + [(1, N, qb) for _, N, qb in
                                                        KERNEL_SHAPES[:3]]
                         + [(1000, 99_344, 16), (9, 4_224, 128)])
@pytest.mark.parametrize("tile", qa.TILES)
def test_launch_plan_covers_every_output_and_client_once(C, N, qblock, tile):
    """CTA b takes tiles b, b + grid, ...; in tile ti its consumer thread t
    owns outputs [ti * tile + 8t, +8) where that lies below N; stage k
    streams clients [k * stage_clients, +stage_clients) where below C, and
    the scales come in chunks of whole stages."""
    plan = qa.launch_plan(C, N, qblock, tile=tile)
    consumers = plan.threads - 32
    assert consumers * qa.OUT_PER_THREAD == plan.tile == tile and consumers % 32 == 0
    assert plan.threads <= 1024 and plan.smem <= 227 * 1024
    n_tiles = -(-N // tile)
    assert 1 <= plan.grid <= n_tiles and plan.grid <= qa.CTAS_PER_SM * 132
    seen = np.zeros(n_tiles * plan.tile, dtype=np.int64)
    for b in range(plan.grid):
        for ti in range(b, n_tiles, plan.grid):
            n0 = ti * plan.tile + qa.OUT_PER_THREAD * np.arange(consumers)
            for i in range(qa.OUT_PER_THREAD):
                np.add.at(seen, (n0 + i)[n0 < N], 1)
    assert (seen[:N] == 1).all() and (seen[N:] == 0).all()
    # the outputs of a thread share one scale block; a tile's q slice is
    # whole 16-byte rows of a TMA box
    assert qblock % qa.OUT_PER_THREAD == 0 and N % 16 == 0
    clients = np.zeros(C, dtype=np.int64)
    for k in range(-(-C // plan.stage_clients)):
        clients[k * plan.stage_clients:(k + 1) * plan.stage_clients] += 1
    assert (clients == 1).all()
    assert 1 <= plan.stage_clients <= qa.STAGE_CLIENTS and 1 <= plan.stages <= qa.STAGES
    assert plan.chunk % plan.stage_clients == 0 and plan.chunk >= plan.stage_clients
    assert plan.chunk >= C or plan.chunk * 4 * (tile // qblock + 3) <= qa.SCALE_BYTES


@pytest.mark.parametrize("N,sm_count,tile", [
    (189_952, 132, 768),     # the FL path on an H100: 248 CTAs, 2 on the busiest SM
    (1_048_576, 132, 1024),  # BENCH_agg: 1,024 CTAs
    (4_224, 132, 256),       # few outputs: the smallest tile
    (189_952, 114, 256)])    # 114 SMs: 742 CTAs of 256 put 1,792 on the busiest
def test_launch_plan_takes_the_tile_that_least_loads_the_busiest_sm(N, sm_count, tile):
    plan = qa.launch_plan(100, N, 128, sm_count)
    assert plan.tile == tile
    per_sm = {t: -(-(-(-N // t)) // sm_count) * t for t in qa.TILES}
    assert per_sm[tile] == min(per_sm.values())


def test_max_clients_is_taken_at_the_limit_and_refused_above():
    plan = qa.launch_plan(qa.MAX_CLIENTS, 4096, 256)
    assert plan.stage_clients == qa.STAGE_CLIENTS and plan.stages == qa.STAGES
    # the ring and one chunk of scales: shared memory stops growing with C
    assert plan.smem == qa.launch_plan(10 * qa.SCALE_BYTES, 4096, 256).smem
    assert plan.smem <= qa.STAGES * (qa.STAGE_CLIENTS * max(qa.TILES) + 16) + 2 * qa.SCALE_BYTES
    with pytest.raises(ValueError, match="clients"):
        qa.launch_plan(qa.MAX_CLIENTS + 1, 4096, 256)
    for tile in (1000, 2048, 1280):
        with pytest.raises(ValueError):
            qa.launch_plan(4, 4096, 256, tile=tile)


# -- lanes: (S, C, N) in one launch (a campaign's int8 round) -----------------

@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("C,N,qblock", SHAPES[:3] + [(5, 4096 + 128, 128)])
def test_lane_plain_is_each_lanes_plain_and_close_to_jax_ref(S, C, N, qblock):
    """The lane plain version runs lane by lane: bitwise each lane's (C, N)
    plain version, and within ``ref.quant_aggregate_ref``'s tolerance of
    the JAX oracle lane by lane (rtol 1e-5 / atol 1e-6, another client
    order)."""
    lanes = [_inputs(C, N, qblock, seed=10 + s) for s in range(S)]
    q, s, w = (np.stack([ln[i] for ln in lanes]) for i in range(3))
    got = qa.plain(*_torch(q, s, w))
    assert got.shape == (S, N)
    for i, ln in enumerate(lanes):
        assert torch.equal(got[i], qa.plain(*_torch(*ln)))
        want = np.asarray(jref.quant_aggregate_ref(*(jnp.asarray(a) for a in ln)))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-5, atol=1e-6)
    # the custom op's vmap rule: one (S, C, N) call, the same values
    with ops.quant_agg_scope() as frame:
        vm = torch.func.vmap(ops.quant_aggregate)(*_torch(q, s, w))
    assert frame["calls"] == 1 and frame["batched_fallbacks"] == 0
    assert torch.equal(vm, got)


@pytest.mark.parametrize("S", [2, 4, 7])
@pytest.mark.parametrize("C,N,qblock", KERNEL_SHAPES + [(13, 768 * 5, 256)])
def test_launch_plan_covers_every_lane_output_once(S, C, N, qblock):
    """The persistent CTAs walk S * ceil(N / tile) tiles: tile gi is tile
    gi % n_tiles of lane gi // n_tiles, so every (lane, output) is owned
    once and no CTA is left without a tile."""
    plan = qa.launch_plan(C, N, qblock, S=S)
    n_tiles = -(-N // plan.tile)
    assert 1 <= plan.grid <= S * n_tiles and plan.grid <= qa.CTAS_PER_SM * 132
    seen = np.zeros((S, n_tiles * plan.tile), dtype=np.int64)
    consumers = plan.threads - 32
    for b in range(plan.grid):
        for gi in range(b, S * n_tiles, plan.grid):
            lane, ti = divmod(gi, n_tiles)
            n0 = ti * plan.tile + qa.OUT_PER_THREAD * np.arange(consumers)
            for i in range(qa.OUT_PER_THREAD):
                np.add.at(seen[lane], (n0 + i)[n0 < N], 1)
    assert (seen[:, :N] == 1).all() and (seen[:, N:] == 0).all()


def test_launch_plan_at_the_campaign_lane_shape():
    """S = 4 lanes of the FL path: 256-output tiles would put 4 % fewer
    outputs on the busiest SM than 1,024, but give each CTA a quarter of
    the consumer threads; the plan takes the largest tile within 10 %."""
    plan = qa.launch_plan(100, 189_952, 256, S=4)
    assert plan.tile == 1024 and plan.grid == qa.CTAS_PER_SM * 132
    assert qa.launch_plan(100, 189_952, 256, S=1) == qa.launch_plan(100, 189_952, 256)
    with pytest.raises(ValueError, match="lanes"):
        qa.launch_plan(100, 4096, 256, S=0)


def test_wrapper_checks_lane_shapes():
    q, s, w = _torch(*_inputs(4, 1024, 256))
    with pytest.raises(ValueError, match=r"\[S,\]"):
        qa.quant_aggregate(q[None], s, w)
    with pytest.raises(ValueError, match=r"\[S,\]"):
        qa.quant_aggregate(torch.stack([q, q]), torch.stack([s, s, s]), torch.stack([w, w]))


@pytest.mark.parametrize("C", [1, 2, 100])
def test_launch_plan_takes_n_up_to_the_tma_column_limit_and_refuses_more(C):
    """N past 2**31 (an LM's packed delta: minicpm3-4b's is 4,073,937,408)
    plans; the TMA copy's column, in int32 words of q, is a signed 32-bit
    coordinate, so N above 4 * (2**31 - 1) is refused with the limit named,
    and the C entry point's ``kMaxN`` is that same limit."""
    import pathlib
    import re
    assert qa.MAX_N == 4 * (2**31 - 1)
    for N in (4_073_937_408, qa.MAX_N - 252):
        plan = qa.launch_plan(C, N, 256)
        last_column = (-(-N // plan.tile) - 1) * plan.tile // 4
        assert last_column <= 2**31 - 1, (N, plan)
    for N, qblock in ((2**33, 16), (2**33 + 256, 256), (2**34, 256)):
        with pytest.raises(ValueError, match=f"N up to {qa.MAX_N}"):
            qa.launch_plan(C, N, qblock)
    src = (pathlib.Path(qa.__file__).parents[1] / "csrc" / "quant_aggregate.cu").read_text()
    limit = re.search(r"constexpr int64_t kMaxN = \(int64_t\)0x7fffffff \* 4;", src)
    assert limit is not None and 0x7fffffff * 4 == qa.MAX_N
    assert "N > kMaxN" in src
