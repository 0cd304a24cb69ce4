"""Card-only tests of the port: the hand-written kernels against their plain
versions, and the main paths through them (the FL round loop, LM serving),
on a CUDA device.

Imports neither ``jax`` nor ``repro`` so it also runs on a machine with the
card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card every test skips with its reason. ``quant_aggregate`` is held
to its plain version bitwise (same client order, no FMA contraction); the
RMSNorm and attention kernels within the tolerances of
``tests/test_kernels.py`` (rmsnorm 1e-5, attention 2e-5 in f32; 2e-2 in
bf16), since they sum in another order than their plain versions.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.configs.reduce import reduced_config
from repro_torch.core import sweeps
from repro_torch.core.jobs import load_job
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import quant_aggregate as qa
from repro_torch.kernels import rmsnorm as rms
from repro_torch.launch import serve
from repro_torch.models import model_zoo
from repro_torch.models.small import SmallModel
from repro_torch.runtime.campaign import CampaignExecutor
from repro_torch.runtime.executor import Executor

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(C, N, qblock, device, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randint(-127, 128, (C, N)).astype(np.int8)
    s = rng.uniform(1e-4, 1e-2, (C, N // qblock)).astype(np.float32)
    w = rng.uniform(0, 1, (C,)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (q, s, w / w.sum())]


@pytest.mark.parametrize("C,N,qblock", [(100, 189_952, 256), (16, 1 << 20, 256),
                                        (7, 4224, 128), (1, 2048, 256),
                                        (3, 16, 16)])
def test_kernel_equals_plain_bitwise(cuda, C, N, qblock):
    q, s, w = _inputs(C, N, qblock, cuda)
    launches = qa.quant_aggregate.launches
    by_shape = qa.quant_aggregate.launches_by_shape.get((1, C, N, qblock), 0)
    got = qa.quant_aggregate(q, s, w)
    torch.cuda.synchronize()
    assert qa.quant_aggregate.launches == launches + 1
    assert qa.quant_aggregate.launches_by_shape[1, C, N, qblock] == by_shape + 1
    assert got.shape == (N,) and torch.equal(got, qa.plain(q, s, w))


@pytest.mark.parametrize("N,qblock", [(4224, 128),      # 33 blocks, a 128-output tail tile
                                      (99_344, 16)])    # 6,209 blocks, a 16-output tail tile
@pytest.mark.parametrize("C", [1, 7, 100, 1000])
def test_kernel_equals_plain_bitwise_at_odd_blocks_and_ragged_tiles(cuda, C, N, qblock):
    """An odd number of scale blocks (scale rows not 16-byte aligned), a last
    tile shorter than the others, and client counts below, at and far above
    one ring stage."""
    q, s, w = _inputs(C, N, qblock, cuda, seed=C)
    plan = qa.launch_plan(C, N, qblock)
    assert (N // qblock) % 2 == 1 and N % plan.tile
    got = qa.quant_aggregate(q, s, w)
    torch.cuda.synchronize()
    assert torch.equal(got, qa.plain(q, s, w))


@pytest.mark.parametrize("tile", qa.TILES)
@pytest.mark.parametrize("stages", [1, 2, 4])
@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("grid", [1, 3, None])
def test_kernel_equals_plain_bitwise_at_other_tiles_rings_chunks_and_grids(
        cuda, tile, stages, chunk, grid):
    """Other geometries than the plan's: smaller tiles, shorter rings, the
    scales of 29 clients staged 8 or 16 at a time, and one or three CTAs
    taking every tile in turn (None: one tile per CTA)."""
    C, N, qblock = 29, 33 * 256, 256
    q, s, w = _inputs(C, N, qblock, cuda, seed=tile)
    plan = qa.launch_plan(C, N, qblock, tile=tile)
    plan = plan._replace(stages=stages, chunk=chunk, grid=grid or -(-N // tile))
    got = qa._launch(q, s, w, qblock, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, qa.plain(q, s, w))


def _lane_inputs(S, C, N, qblock, device):
    lanes = [_inputs(C, N, qblock, device, seed=100 + s) for s in range(S)]
    return [torch.stack([ln[i] for ln in lanes]).contiguous() for i in range(3)], lanes


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("C,N,qblock", [(100, 189_952, 256),   # the FL path's lanes
                                        (7, 4224, 128),        # odd blocks, a tail tile
                                        (3, 99_344, 16),       # 6,209 blocks, tail 16
                                        (13, 768 * 5, 256)])   # an odd tile count
def test_kernel_lanes_equal_plain_and_single_launches_bitwise(cuda, S, C, N, qblock):
    """(S, C, N) in one launch: each lane bitwise its plain version and its
    own (C, N) launch, including ragged N, odd block and tile counts, and a
    lane's last stage reading the next lane's rows."""
    (q, s, w), lanes = _lane_inputs(S, C, N, qblock, cuda)
    launches = qa.quant_aggregate.launches
    got = qa.quant_aggregate(q, s, w)
    torch.cuda.synchronize()
    assert qa.quant_aggregate.launches == launches + 1
    assert got.shape == (S, N)
    assert torch.equal(got, qa.plain(q, s, w))
    assert torch.equal(got, torch.stack([qa.quant_aggregate(*ln) for ln in lanes]))


@pytest.mark.parametrize("grid", [1, 5, None])
def test_kernel_lanes_at_other_grids(cuda, grid):
    """CTAs taking tiles of several lanes in turn (grid 1 and 5), and one
    tile per CTA."""
    S, C, N, qblock = 3, 29, 33 * 256, 256
    (q, s, w), _ = _lane_inputs(S, C, N, qblock, cuda)
    plan = qa.launch_plan(C, N, qblock, S=S, tile=256)
    plan = plan._replace(grid=grid or S * -(-N // 256))
    got = qa._launch(q, s, w, qblock, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, qa.plain(q, s, w))


def test_vmapped_call_is_one_lane_launch(cuda):
    """``ops.quant_aggregate`` under ``torch.func.vmap`` over lanes launches
    the kernel once for all of them."""
    (q, s, w), _ = _lane_inputs(4, 10, 4096, 256, cuda)
    launches = qa.quant_aggregate.launches
    got = torch.func.vmap(ops.quant_aggregate)(q, s, w)
    torch.cuda.synchronize()
    assert qa.quant_aggregate.launches == launches + 1
    assert torch.equal(got, qa.plain(q, s, w))


def test_kernel_rejects_misaligned_input(cuda):
    q, s, w = _inputs(2, 4096 + 16, 16, cuda)
    with pytest.raises(ValueError, match="aligned"):
        qa.quant_aggregate(q.reshape(-1)[1:1 + 2 * 4096].reshape(2, 4096),
                           s[:, :256].contiguous(), w)


def _job(compression, rounds_per_launch, **train):
    job = load_job({
        "model": {"arch": "flsim-cnn"},
        "dataset": {"dataset": "synthetic_vision", "n_items": 256},
        "strategy": {"strategy": "compressed" if compression == "int8" else "fedavg",
                     "train_params": {"n_clients": 6, "cohort": 4, "local_steps": 2,
                                      "batch_size": 8, "client_lr": 0.05,
                                      "rounds": 4, "compression": compression,
                                      "rounds_per_launch": rounds_per_launch, **train}},
        "runtime": {"straggler_prob": 0.1, "straggler_overprovision": 1.25}})
    job.model = SmallModel(job.model.cfg.replace(d_model=8, d_ff=16), "cnn")
    return job


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_int8_campaign_on_card_launches_once_per_flush_for_every_lane(cuda, mode):
    """An int8 campaign of 4 lanes: one B1 launch per round (sync) or per
    event where some lane flushes (FedBuff); chunks of 1 == chunks of 2."""
    runs = []
    for chunk in (2, 1):
        job = _job("int8", chunk, **({"mode": "async", "async_buffer": 3} if mode == "async"
                                     else {}))
        job.sweep = sweeps.parse_sweep({"seed": [0, 1], "client_lr": [0.05, 0.1]})
        launches = qa.quant_aggregate.launches
        ex = CampaignExecutor(job).scaffold()
        ex.run()
        n = qa.quant_aggregate.launches - launches
        if mode == "sync":
            assert n == 4
        else:
            flushes = {e for sc in ex.schedules for e in np.nonzero(sc.apply[:12])[0]}
            assert n == len(flushes)
        runs.append(ex)
    a, b = runs
    assert all(torch.equal(a.state["params"][k], b.state["params"][k]) for k in a.state["params"])


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_executor_on_card_is_chunking_invariant_and_launches_per_round(
        cuda, compression):
    runs = []
    for chunk in (2, 1):
        launches = qa.quant_aggregate.launches
        with ops.quant_agg_scope() as frame:
            st, lg = Executor(_job(compression, chunk)).scaffold().run()
        assert qa.quant_aggregate.launches - launches == \
            (4 if compression == "int8" else 0)
        assert frame["calls"] == (4 if compression == "int8" else 0)
        assert st["params"]["c1"].is_cuda
        runs.append((st, lg.series("loss")))
    (s2, l2), (s1, l1) = runs
    assert l2 == l1 and all(np.isfinite(l2))
    assert all(torch.equal(s2["params"][k], s1["params"][k]) for k in s2["params"])


def test_normals_projections_and_poison_give_the_same_bits_on_the_card(cuda):
    from repro_torch.core import consensus, determinism as det
    ctr = torch.arange(1 << 20, dtype=torch.int64)
    assert torch.equal(det.normal(12345, ctr.to(cuda)).cpu(), det.normal(12345, ctr))
    assert torch.equal(consensus._projection(3, 128, 4, cuda).cpu(),
                       consensus._projection(3, 128, 4, torch.device("cpu")))
    tree = {"a": torch.linspace(-1, 1, 5000), "b": torch.ones(3, 7)}
    got = consensus.poison({k: v.to(cuda) for k, v in tree.items()}, 3.0, 77)
    want = consensus.poison(tree, 3.0, 77)
    assert all(torch.equal(got[k].cpu(), want[k]) for k in tree)


@pytest.mark.parametrize("name,W", [("majority_digest", 3), ("median", 4),
                                    ("trimmed_mean", 4)])
@pytest.mark.parametrize("placement", ["spatial", "temporal"])
def test_honest_majority_consensus_on_card_is_bitwise_one_worker(cuda, name, W, placement):
    """int8 sends, one B1 launch per round; a ledger block per chunk."""
    runs = []
    for extra in ({}, {"n_workers": W, "byzantine_workers": 1, "consensus": name,
                       "blockchain": "hashchain"}):
        job = _job("int8", 2, placement=placement, **extra)
        launches = qa.quant_aggregate.launches
        ex = Executor(job).scaffold()
        st, lg = ex.run()
        assert qa.quant_aggregate.launches - launches == 4
        runs.append((st, lg.series("loss"), ex))
    (s1, l1, _), (sw, lw, ex) = runs
    assert l1 == lw and all(torch.equal(s1["params"][k], sw["params"][k]) for k in s1["params"])
    assert ex.job.ledger.verify() and len(ex.job.ledger.blocks()) == 3   # genesis + 2 chunks


def test_hash_gives_the_same_bits_on_the_card(cuda):
    from repro_torch.core import determinism as det
    key = det.round_key(det.root_key(0), 7)
    assert torch.equal(det.client_keys(key, 100, cuda).cpu(), det.client_keys(key, 100, "cpu"))
    ctr = torch.arange(1 << 16, dtype=torch.int64)
    assert torch.equal(det.draw_bits(key, ctr.to(cuda)).cpu(), det.draw_bits(key, ctr))
    lens = torch.arange(1, 65)[:, None]
    assert torch.equal(det.uniform_index(key, ctr[None, :256].to(cuda), lens.to(cuda)).cpu(),
                       det.uniform_index(key, ctr[None, :256], lens))


@pytest.mark.parametrize("C,zero_rows", [(10, False), (10, True), (1, False)])
def test_kernel_equals_plain_bitwise_at_the_async_and_temporal_shapes(cuda, C, zero_rows):
    """A FedBuff flush of K = 10 rows (with zero rows and zero coefficients:
    an unfilled slot, accepted zero-weight clients) and packed FedAsync's
    C = 1, at flsim-cnn's N."""
    q, s, w = _inputs(C, 189_952, 256, cuda, seed=C + zero_rows)
    if zero_rows:
        q[2].zero_()
        s[2].zero_()
        w[[2, 5, 8]] = 0.0
    got = qa.quant_aggregate(q, s, w)
    torch.cuda.synchronize()
    assert torch.equal(got, qa.plain(q, s, w))


@pytest.mark.parametrize("S,C,real", [(1, 25, (20,)), (1, 128, (100,)),
                                      (4, 25, (10, 20, 10, 20))])
def test_kernel_equals_plain_bitwise_at_the_ragged_shapes(cuda, S, C, real):
    """The ragged plane's launches at flsim-cnn's N: C = max_cohort slots
    with the pads at weight 0, one client grid or S lanes in one launch."""
    lanes = [_inputs(C, 189_952, 256, cuda, seed=70 + s) for s in range(S)]
    for (_, _, w), k in zip(lanes, real):
        w[k:] = 0.0
    q, s, w = (torch.stack([ln[i] for ln in lanes]) for i in range(3))
    if S == 1:
        q, s, w = q[0], s[0], w[0]
    launches = qa.quant_aggregate.launches
    got = qa.quant_aggregate(q, s, w)
    torch.cuda.synchronize()
    assert qa.quant_aggregate.launches == launches + 1
    assert torch.equal(got, qa.plain(q, s, w))


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_streaming_equals_resident_on_card(cuda, mode):
    """The ragged plane on the card: the streaming stager's pinned buffers,
    side-stream copies and events feed the bytes the resident gather
    feeds (bitwise, chunks of 1 so every chunk after the first comes from
    the prefetch); int8 launches B1 once a round (sync) or flush (FedBuff)."""
    tp = {"max_cohort": 6, "error_feedback": False}
    if mode == "async":
        tp.update(mode="async", async_buffer=3, cohort=0)
    runs = []
    for streaming in (False, True):
        launches = qa.quant_aggregate.launches
        ex = Executor(_job("int8", 1, streaming=streaming, **tp)).scaffold()
        st, lg = ex.run()
        n = qa.quant_aggregate.launches - launches
        assert n == (4 if mode == "sync" else int(ex.schedule.apply[:12].sum()))
        runs.append((st, lg.series("loss"), ex.stager.chunk_stats()))
    (s_res, l_res, _), (s_str, l_str, stats) = runs
    assert l_res == l_str and all(np.isfinite(l_res))
    for k in ("params", "server"):
        a, b = s_res[k], s_str[k]
        assert all(torch.equal(a[n], b[n]) for n in a) if isinstance(a, dict) else a == b
    assert all(s["prefetched"] and s["h2d_ms"] > 0 for s in stats[1:])


def _async_job(**train):
    tp = {"n_clients": 4, "local_steps": 2, "batch_size": 8, "client_lr": 0.05,
          "rounds": 3, "rounds_per_launch": 3, "seed": 11}
    tp.update(train)
    job = load_job({"model": {"arch": "flsim-cnn"},
                    "dataset": {"dataset": "synthetic_vision", "n_items": 256},
                    "strategy": {"strategy": tp.pop("strategy", "fedavg"), "train_params": tp},
                    "runtime": {"straggler_prob": 0.0, "duration_sigma": 0.0,
                                "rate_spread": 0.0}})
    job.model = SmallModel(job.model.cfg.replace(d_model=8, d_ff=16), "cnn")
    return job


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_fedbuff_identity_with_sync_temporal_fedavg_on_card(cuda, compression):
    strategy = "compressed" if compression == "int8" else "fedavg"
    with ops.quant_agg_scope() as frame:
        sync, _ = Executor(_async_job(placement="temporal", strategy=strategy,
                                      compression=compression)).scaffold().run()
    assert frame["calls"] == (3 if compression == "int8" else 0)
    assert frame["last_impl"] in (None, "cuda")
    asy, _ = Executor(_async_job(mode="async", async_buffer=4, strategy=strategy,
                                 compression=compression)).scaffold().run()
    assert sync["params"]["c1"].is_cuda
    assert all(torch.equal(sync["params"][k], asy["params"][k]) for k in sync["params"])


TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _randn(shape, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).to(device)


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [(64, 128), (3, 40, 256), (130, 512), (8, 7168),
                                   (2048, 7168), (5, 100), (7, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype, w_dtype):
    x = _randn(shape, dtype, cuda, 0)
    w = _randn(shape[-1:], w_dtype, cuda, 1)
    key = (x.numel() // shape[-1], shape[-1])
    launches = rms.rmsnorm.launches
    by_shape = rms.rmsnorm.launches_by_shape.get(key, 0)
    got = rms.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rms.rmsnorm.launches == launches + 1
    assert rms.rmsnorm.launches_by_shape[key] == by_shape + 1
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, rms.plain(x, w), 1e-5 if dtype == torch.float32 else 2e-2)


def test_rmsnorm_kernel_takes_a_misaligned_row(cuda):
    """A row that starts off a 16-byte boundary takes the scalar path."""
    flat = _randn((3 * 64 + 1,), torch.bfloat16, cuda, 2)
    x = flat[1:].view(3, 64)
    w = _randn((64,), torch.bfloat16, cuda, 3)
    _close(rms.rmsnorm(x, w), rms.plain(x, w), 2e-2)


def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


MIXES = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
         (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("rows", ["1", "8", "sm-1", "sm", "sm+1", "16384"])
@pytest.mark.parametrize("dtype,w_dtype", MIXES)
def test_rmsnorm_kernel_in_both_row_layouts(cuda, rows, dtype, w_dtype):
    """Rows of 7168 (yi-34b's width) from one row to prefill's 16,384: a
    wide CTA per row below the SM count, a narrow one from it on."""
    sm = _sm_count(cuda)
    R = {"sm-1": sm - 1, "sm": sm, "sm+1": sm + 1}.get(rows) or int(rows)
    x = _randn((R, 7168), dtype, cuda, R)
    w = _randn((7168,), w_dtype, cuda, 1)
    by_layout = dict(rms.rmsnorm.launches_by_layout)
    got = rms.rmsnorm(x, w)
    torch.cuda.synchronize()
    layout = "wide_row" if R < sm else "row"
    assert rms.rmsnorm.launches_by_layout[layout] == by_layout[layout] + 1
    assert rms.launch_plan(R, 7168, dtype, sm).layout == layout
    _close(got, rms.plain(x, w), 1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("R", [8, 300])
@pytest.mark.parametrize("D", [64, 7168, 7169])
@pytest.mark.parametrize("dtype,w_dtype", MIXES)
def test_rmsnorm_kernel_takes_misaligned_rows_in_both_layouts(cuda, R, D, dtype, w_dtype):
    """Rows that start off a 16-byte boundary, or a D that is no whole number
    of 16-byte vectors, take the scalar path in either layout."""
    flat = _randn((R * D + 1,), dtype, cuda, D)
    x = flat[1:].view(R, D)
    w = _randn((D,), w_dtype, cuda, 3)
    _close(rms.rmsnorm(x, w), rms.plain(x, w), 1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("K", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_at_every_cluster_size(cuda, K, dtype):
    """The decode shape (8 x 7168) with each cluster size forced: the kernel
    against the plain version and the cluster's summation mirror."""
    x = _randn((8, 7168), dtype, cuda, K)
    w = _randn((7168,), torch.bfloat16, cuda, 5)
    plan = rms.launch_plan(8, 7168, dtype, _sm_count(cuda), K=K)
    got = rms._launch(x, w, torch.empty_like(x), 1e-6, plan)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    _close(got, rms.plain(x, w), tol)
    _close(got, rms.plain_cluster(x, w, 1e-6, K), tol)


@pytest.mark.parametrize("R", [8, 300])
@pytest.mark.parametrize("D,dtype", [(32_768, torch.bfloat16), (16_384, torch.float32),
                                     (8_193, torch.float32)])
def test_rmsnorm_kernel_splits_long_rows_over_a_cluster(cuda, R, D, dtype):
    """Rows too long for one CTA's registers take the cluster layout by
    themselves: the kernel against the plain version and the cluster's
    summation mirror."""
    x = _randn((R, D), dtype, cuda, 8)
    w = _randn((D,), torch.float32, cuda, 9)
    by_layout = dict(rms.rmsnorm.launches_by_layout)
    got = rms.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rms.rmsnorm.launches_by_layout["cluster"] == by_layout["cluster"] + 1
    K = rms.launch_plan(R, D, dtype, _sm_count(cuda)).K
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    _close(got, rms.plain(x, w), tol)
    _close(got, rms.plain_cluster(x, w, 1e-6, K), tol)


def test_rmsnorm_kernel_refuses_a_plan_that_misses_the_row(cuda):
    x = _randn((8, 7168), torch.bfloat16, cuda, 6)
    w = _randn((7168,), torch.bfloat16, cuda, 7)
    plan = rms.launch_plan(8, 7168, torch.bfloat16, _sm_count(cuda))
    with pytest.raises(RuntimeError, match="launch failed"):
        rms._launch(x, w, torch.empty_like(x), 1e-6, plan._replace(per_cta=plan.per_cta - 8))


@pytest.mark.parametrize("B,Sq,Sk,H,KV,Dk,Dv,causal", [
    (2, 128, 128, 4, 4, 64, 64, True),       # MHA
    (1, 256, 256, 8, 2, 64, 64, True),       # GQA
    (2, 128, 256, 4, 1, 32, 32, True),       # MQA, Sq != Sk (q_offset 128)
    (1, 128, 128, 4, 2, 96, 64, True),       # Dk != Dv
    (2, 128, 256, 4, 1, 32, 32, False),      # full attention
    (1, 300, 300, 56, 8, 128, 128, True),    # yi-34b heads (G = 7), ragged S
    (2, 70, 200, 4, 1, 64, 64, True),        # ragged Sq and Sk, q_offset 130
    (2, 64, 64, 4, 2, 16, 16, True),         # reduced yi-34b head dim
    (1, 50, 50, 4, 2, 20, 20, True),         # rows not 16-byte aligned: narrower copies
    (1, 129, 129, 4, 1, 288, 256, True),     # MLA absorbed (f32: tf32x3, bf16: wgmma)
    (2, 100, 100, 8, 8, 96, 64, True),       # MLA expanded
    (1, 300, 300, 40, 1, 288, 256, True),    # 40 heads on one kv head
    (2, 70, 200, 4, 2, 24, 16, True),        # reduced minicpm3-4b absorbed, q_offset 130
    (1, 1, 333, 8, 2, 128, 128, True),       # one query row at q_offset 332
    (1, 1, 333, 40, 1, 288, 256, True),      # one row, 40 heads in one tile
    (2, 32, 32, 4, 2, 64, 64, True),         # a single kv block
    (1, 50, 50, 4, 2, 20, 20, False),        # rows not 16-byte aligned, full attention
    (2, 100, 100, 8, 8, 96, 64, False),      # full attention at MLA's expanded dims
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, B, Sq, Sk, H, KV, Dk, Dv, causal, dtype):
    q = _randn((B, Sq, H, Dk), dtype, cuda, 0)
    k = _randn((B, Sk, KV, Dk), dtype, cuda, 1)
    v = _randn((B, Sk, KV, Dv), dtype, cuda, 2)
    key = (B, Sq, Sk, H, KV, Dk, Dv, causal)
    launches = fa.flash_attention_fwd.launches
    by_shape = fa.flash_attention_fwd.launches_by_shape.get(key, 0)
    out, lse = fa.flash_attention_fwd(q, k, v, Sk - Sq, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == launches + 1
    assert fa.flash_attention_fwd.launches_by_shape[key] == by_shape + 1
    want, want_lse = fa.plain(q, k, v, Sk - Sq, causal)
    assert out.dtype == dtype and out.shape == (B, Sq, H, Dv)
    _close(out, want, TOL[dtype])
    _close(lse, want_lse, TOL[dtype])


@pytest.mark.parametrize("B,Sq,Sk,H,KV,Dk,Dv,causal", [
    (2, 128, 128, 4, 4, 128, 128, True),     # MHA
    (2, 128, 128, 4, 4, 128, 128, False),    # full attention
    (2, 128, 256, 4, 1, 64, 64, True),       # q_offset 128
    (2, 128, 256, 4, 1, 64, 64, False),
    (2, 70, 200, 4, 1, 128, 128, True),      # ragged Sq and Sk, q_offset 130
    (2, 70, 200, 4, 1, 128, 128, False),
    (1, 300, 300, 56, 8, 128, 128, True),    # yi-34b heads (G = 7), ragged S
    (1, 300, 300, 56, 8, 128, 128, False),
    (1, 192, 192, 8, 2, 128, 64, True),      # Dk != Dv
    (1, 192, 192, 8, 2, 64, 128, True),
    (1, 1, 333, 8, 2, 128, 128, True),       # one query row at q_offset 332
    (1, 300, 300, 40, 1, 288, 256, True),    # MLA absorbed: 40 heads on one kv head
    (1, 300, 300, 40, 1, 288, 256, False),
    (2, 70, 200, 8, 1, 288, 256, True),      # ragged Sq and Sk, q_offset 130
    (1, 1, 333, 40, 1, 288, 256, True),      # one query row at q_offset 332
    (1, 64, 64, 4, 1, 288, 256, True),       # one kv block of 64 keys
    (2, 100, 100, 40, 40, 96, 64, True),     # MLA expanded: two Q/K panels, 6 k-steps
    (2, 100, 100, 40, 40, 96, 64, False),
    (2, 70, 200, 8, 1, 24, 16, True),        # reduced MLA absorbed: 2 k-steps, one panel
    (2, 64, 64, 4, 2, 16, 16, True),         # reduced yi-34b: 1 k-step
    (2, 70, 200, 4, 2, 16, 8, True),         # reduced MLA expanded: Dv 8
    (2, 128, 256, 4, 1, 32, 32, False),
    (1, 192, 192, 8, 2, 192, 192, True),     # 12 k-steps' dims on the 18-step tile
])
def test_flash_wgmma_kernel_matches_plain(cuda, B, Sq, Sk, H, KV, Dk, Dv, causal):
    """The tensor-core kernel (bf16, head dims multiples of 8 that one of
    ``fa.WGMMA_TILES`` holds) against the plain version."""
    q = _randn((B, Sq, H, Dk), torch.bfloat16, cuda, 4)
    k = _randn((B, Sk, KV, Dk), torch.bfloat16, cuda, 5)
    v = _randn((B, Sk, KV, Dv), torch.bfloat16, cuda, 6)
    assert fa.launch_plan(q.dtype, Dk, Dv).kernel == "wgmma"
    by_kernel = dict(fa.flash_attention_fwd.launches_by_kernel)
    out, lse = fa.flash_attention_fwd(q, k, v, Sk - Sq, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches_by_kernel == {
        "wgmma": by_kernel["wgmma"] + 1, "tf32x3": by_kernel["tf32x3"]}
    want, want_lse = fa.plain(q, k, v, Sk - Sq, causal)
    assert out.dtype == torch.bfloat16 and out.shape == (B, Sq, H, Dv)
    _close(out, want, 2e-2)
    _close(lse, want_lse, 2e-2)


def test_flash_simt_kernel_in_bf16_matches_plain(cuda):
    """The tf32x3 kernel takes bf16 at a wgmma shape when asked directly
    (chip_smoke.py times the two side by side)."""
    q = _randn((1, 300, 56, 128), torch.bfloat16, cuda, 7)
    k = _randn((1, 300, 8, 128), torch.bfloat16, cuda, 8)
    v = _randn((1, 300, 8, 128), torch.bfloat16, cuda, 9)
    out, lse = fa._launch("tf32x3", q, k, v, 0, True, None)
    want, want_lse = fa.plain(q, k, v, 0, True)
    _close(out, want, 2e-2)
    _close(lse, want_lse, 2e-2)


def test_flash_kernel_refuses_head_dims_above_128(cuda):
    """The wgmma kernel refuses bf16 head dims that no wgmma tile holds (Dv
    above 256, dims that are not multiples of 8); the wrapper sends those
    to the tf32x3 kernel."""
    for Dk, Dv in ((288, 288), (256, 264), (20, 20)):
        q = torch.zeros(1, 8, 2, Dk, device=cuda, dtype=torch.bfloat16)
        v = torch.zeros(1, 8, 2, Dv, device=cuda, dtype=torch.bfloat16)
        assert fa.launch_plan(torch.bfloat16, Dk, Dv).kernel == "tf32x3"
        with pytest.raises(ValueError, match="wgmma kernel takes bf16"):
            fa._launch("wgmma", q, q, v, 0, True, None)
    q, k, v = (_randn((1, 8, 2, 288), torch.bfloat16, cuda, i) for i in range(3))
    by_kernel = dict(fa.flash_attention_fwd.launches_by_kernel)
    out, _ = fa.flash_attention_fwd(q, k, v)
    assert fa.flash_attention_fwd.launches_by_kernel["tf32x3"] == by_kernel["tf32x3"] + 1
    # bf16 inputs: the tf32x3 kernel against the plain version in f32 (the
    # bf16 plain version rounds the raw scores before scaling)
    _close(out, fa.plain(q.float(), k.float(), v.float())[0], 2e-2)


def test_flash_kernel_takes_dims_up_to_288_and_refuses_beyond(cuda):
    """f32 head dims run up to 288 (MLA's absorbed Dk) on the tf32x3
    kernel, (288, 288) included; (320, 320) and (289, 64) no kernel takes:
    the plan refuses them, whichever kernel is asked for, and the tf32x3
    kernel's C entry point does too."""
    for Dk, Dv in ((192, 192), (288, 256), (96, 64), (288, 288)):
        q = _randn((1, 8, 2, Dk), torch.float32, cuda, 0)
        v = _randn((1, 8, 2, Dv), torch.float32, cuda, 1)
        out, _ = fa.flash_attention_fwd(q, q, v)
        _close(out, fa.plain(q, q, v)[0], 2e-5)
    for Dk, Dv in ((320, 320), (289, 64)):
        q = torch.zeros(1, 8, 2, Dk, device=cuda)
        v = torch.zeros(1, 8, 2, Dv, device=cuda)
        with pytest.raises(NotImplementedError, match="no kernel takes"):
            fa.flash_attention_fwd(q, q, v)
        with pytest.raises(NotImplementedError, match="no kernel takes"):
            fa._launch("tf32x3", q, q, v, 0, True, None)
        # the widest tile, told to the C entry point directly
        last = fa.launch_plan(torch.float32, 288, 288)
        assert last.tile == len(fa.TF32X3_TILES) - 1
        assert _flash_entry(q, q, v, "tf32x3", last.tile, last.smem_bytes) == \
            fa.CUDA_ERROR_INVALID_VALUE
    # a refusal leaves no error behind for the next launch
    q = _randn((1, 8, 2, 64), torch.float32, cuda, 2)
    _close(fa.flash_attention_fwd(q, q, q)[0], fa.plain(q, q, q)[0], 2e-5)


def _flash_entry(q, k, v, kernel, tile, smem):
    """One call of ``kernel``'s C entry point with the given tile and shared
    bytes; returns its code."""
    B, Sq, H, Dk = q.shape
    _, Sk, KV, Dv = v.shape
    out = torch.empty(B, Sq, H, Dv, device=q.device, dtype=q.dtype)
    lse = torch.empty(B, H, Sq, device=q.device)
    rc = fa._entry(fa.SOURCES[kernel])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, Sq, Sk, H, KV, Dk, Dv, 0, 1, 0.1, fa.DTYPE_CODES[q.dtype], tile, smem,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return rc


@pytest.mark.parametrize("dtype,Dk,Dv", [(torch.float32, 128, 128), (torch.bfloat16, 20, 20),
                                         (torch.bfloat16, 128, 128), (torch.bfloat16, 288, 256)])
def test_flash_entry_points_launch_the_plan_and_refuse_another(cuda, dtype, Dk, Dv):
    """The C entry point launches the tile ``launch_plan`` names (and so
    agrees with its shared bytes), and refuses a tile that does not hold the
    dims or shared bytes that are not the tile's; the next launch works."""
    q = _randn((1, 70, 4, Dk), dtype, cuda, 0)
    k = _randn((1, 70, 2, Dk), dtype, cuda, 1)
    v = _randn((1, 70, 2, Dv), dtype, cuda, 2)
    plan = fa.launch_plan(dtype, Dk, Dv)
    assert _flash_entry(q, k, v, plan.kernel, plan.tile, plan.smem_bytes) == 0
    assert _flash_entry(q, k, v, plan.kernel, plan.tile, plan.smem_bytes + 16) == \
        fa.CUDA_ERROR_INVALID_VALUE
    if plan.tile > 0:   # the tile before it does not hold these dims
        assert _flash_entry(q, k, v, plan.kernel, plan.tile - 1, plan.smem_bytes) == \
            fa.CUDA_ERROR_INVALID_VALUE
    assert _flash_entry(q, k, v, plan.kernel, 99, plan.smem_bytes) == \
        fa.CUDA_ERROR_INVALID_VALUE
    out, lse = fa.flash_attention_fwd(q, k, v, 0, True)
    want, want_lse = fa.plain(q, k, v, 0, True)
    _close(out, want, TOL[dtype])
    _close(lse, want_lse, TOL[dtype])


@pytest.mark.parametrize("B,S,H,KV,D", [(2, 256, 8, 2, 64), (1, 512, 4, 4, 128),
                                        (3, 128, 8, 1, 32), (8, 2112, 56, 8, 128),
                                        (4, 77, 4, 2, 16),
                                        (2, 90, 6, 3, 12)])   # rows not 16-byte aligned
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(cuda, B, S, H, KV, D, dtype):
    q = _randn((B, H, D), dtype, cuda, 0)
    k = _randn((B, S, KV, D), dtype, cuda, 1)
    v = _randn((B, S, KV, D), dtype, cuda, 2)
    length = torch.randint(1, S + 1, (B,), generator=torch.Generator().manual_seed(3),
                           dtype=torch.int32)
    length[-1] = S
    if B > 1:
        length[0] = 0                        # an empty row keeps m = -1e30, l = 0
    length = length.to(cuda)
    key = (B, S, H, KV, D, D)
    launches = da.decode_attention_fwd.launches
    by_shape = da.decode_attention_fwd.launches_by_shape.get(key, 0)
    o, m, l = da.decode_attention_fwd(q, k, v, length)
    torch.cuda.synchronize()
    assert da.decode_attention_fwd.launches == launches + 1
    assert da.decode_attention_fwd.launches_by_shape[key] == by_shape + 1
    po, pm, pl = da.plain(q, k, v, length)
    empty = length == 0
    assert (m[empty] == -1e30).all() and (l[empty] == 0).all() and (o[empty] == 0).all()
    _close(o[~empty] / l[~empty][..., None], po[~empty] / pl[~empty][..., None], TOL[dtype])
    _close(m, pm, TOL[dtype])
    _close(l, pl, TOL[dtype])


@pytest.mark.parametrize("S", [600, 2 * da.CHUNK])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_kernel_at_chunk_boundaries(cuda, S, dtype):
    """Lengths 0, 1, chunk-1, chunk, chunk+1 and S, G = 7: the split kernel
    and its combine against the plain version and its split mirror."""
    c = da.CHUNK
    length = torch.tensor([0, 1, c - 1, c, c + 1, S], dtype=torch.int32)
    B, H, KV, D = len(length), 14, 2, 128
    q = _randn((B, H, D), dtype, cuda, 10)
    k = _randn((B, S, KV, D), dtype, cuda, 11)
    v = _randn((B, S, KV, D), dtype, cuda, 12)
    length = length.to(cuda)
    o, m, l = da.decode_attention_fwd(q, k, v, length)
    torch.cuda.synchronize()
    assert (m[0] == -1e30).all() and (l[0] == 0).all() and (o[0] == 0).all()
    for po, pm, pl in (da.plain(q, k, v, length), da.plain_split(q, k, v, length)):
        _close(o[1:] / l[1:, :, None], po[1:] / pl[1:, :, None], TOL[dtype])
        _close(m, pm, TOL[dtype])
        _close(l, pl, TOL[dtype])


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_serve_on_card_matches_cpu_and_launches_each_kernel(cuda):
    """Reduced yi-34b in f32 from the same weights: the card (kernels) and
    the CPU (plain versions) give the same tokens, logits within 1e-4."""
    model = model_zoo.build(reduced_config(get_config("yi-34b")))
    params = model.init(torch.Generator().manual_seed(0))
    prompts = torch.randint(0, 512, (2, 40), generator=torch.Generator().manual_seed(1))
    counts = (rms.rmsnorm.launches, fa.flash_attention_fwd.launches,
              da.decode_attention_fwd.launches)
    toks_cpu = serve.generate(model, params, prompts, 5)
    assert counts == (rms.rmsnorm.launches, fa.flash_attention_fwd.launches,
                      da.decode_attention_fwd.launches)
    card = _to(params, cuda)
    toks_card = serve.generate(model, card, prompts.to(cuda), 5)
    L = model.cfg.n_layers
    assert (rms.rmsnorm.launches - counts[0], fa.flash_attention_fwd.launches - counts[1],
            da.decode_attention_fwd.launches - counts[2]) == ((2 * L + 1) * 6, L, 5 * L)
    assert torch.equal(toks_card.cpu(), toks_cpu)
    _, lc, _ = model.prefill(params, {"tokens": prompts})
    _, lg, _ = model.prefill(card, {"tokens": prompts.to(cuda)})
    _close(lg.cpu(), lc, 1e-4)


def test_serve_in_bf16_at_head_dim_128_launches_only_the_wgmma_kernel(cuda):
    """yi-34b's head dim (128) in bf16: every prefill attention goes to the
    tensor-core kernel, and a second generate repeats the tokens bitwise."""
    cfg = reduced_config(get_config("yi-34b")).replace(
        d_model=256, n_heads=4, n_kv_heads=2, head_dim=128)
    model = model_zoo.build(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), dtype=torch.bfloat16)
    prompts = torch.randint(0, 512, (2, 96), generator=torch.Generator().manual_seed(1))
    prompts = prompts.to(cuda)
    by_kernel = dict(fa.flash_attention_fwd.launches_by_kernel)
    toks = serve.generate(model, params, prompts, 4)
    L = cfg.n_layers
    assert fa.flash_attention_fwd.launches_by_kernel == {
        "wgmma": by_kernel["wgmma"] + L, "tf32x3": by_kernel["tf32x3"]}
    assert torch.equal(serve.generate(model, params, prompts, 4), toks)


def test_f32_serve_launches_the_tf32x3_kernel(cuda):
    """Reduced yi-34b in f32 (head dim 16): every prefill attention is
    counted under the tf32x3 kernel's name, none under wgmma's."""
    model = model_zoo.build(reduced_config(get_config("yi-34b")))
    params = _to(model.init(torch.Generator().manual_seed(0)), cuda)
    prompts = torch.randint(0, 512, (2, 40), generator=torch.Generator().manual_seed(1))
    assert set(fa.flash_attention_fwd.launches_by_kernel) == {"wgmma", "tf32x3"}
    by_kernel = dict(fa.flash_attention_fwd.launches_by_kernel)
    serve.generate(model, params, prompts.to(cuda), 2)
    assert fa.flash_attention_fwd.launches_by_kernel == {
        "wgmma": by_kernel["wgmma"], "tf32x3": by_kernel["tf32x3"] + model.cfg.n_layers}


# -- the LM training path (slice 9): B2 and B3 under autograd and torch.func --
# The kernel's forward with the ported backward (rmsnorm.backward,
# flash_attention.plain_bwd) against autograd through the plain version on
# the card. Gradient tolerance: max |got - want| within GRAD_TOL of
# max(1, max |want|) (f32: the kernels sum in another order; bf16: the two
# round the products at other places, and dk, dv sum over every q row).
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _grad_close(got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(1.0, want.float().abs().max().item()), err


@pytest.mark.parametrize("B,Sq,Sk,H,KV,Dk,Dv,causal,dtype", [
    (2, 512, 512, 8, 2, 128, 128, True, torch.bfloat16),      # wgmma
    (1, 300, 300, 8, 2, 64, 64, True, torch.bfloat16),        # ragged
    (1, 128, 256, 4, 1, 128, 64, True, torch.bfloat16),       # q_offset, Dk != Dv
    (2, 256, 256, 8, 2, 64, 64, False, torch.bfloat16),
    (2, 256, 256, 8, 2, 64, 64, True, torch.float32),         # tf32x3
    (1, 256, 256, 8, 1, 288, 256, True, torch.bfloat16),      # MLA absorbed (wgmma)
    (1, 128, 128, 4, 1, 288, 256, True, torch.float32),       # MLA absorbed (tf32x3)
])
def test_flash_forward_and_backward_match_autograd_of_plain(cuda, B, Sq, Sk, H, KV, Dk, Dv,
                                                            causal, dtype):
    args = [_randn(s, dtype, cuda, i) for i, s in enumerate(
        [(B, Sq, H, Dk), (B, Sk, KV, Dk), (B, Sk, KV, Dv)])]
    dout = _randn((B, Sq, H, Dv), dtype, cuda, 9)
    grads = []
    for fn in (lambda q, k, v: ops.flash_attention(q, k, v, Sk - Sq, causal),
               lambda q, k, v: fa.plain(q, k, v, Sk - Sq, causal)[0]):
        x = [a.clone().requires_grad_() for a in args]
        out = fn(*x)
        out.backward(dout)
        grads.append((out.detach(), *(t.grad for t in x)))
    launches = fa.flash_attention_fwd.launches
    ops.flash_attention(*args, Sk - Sq, causal)
    assert fa.flash_attention_fwd.launches == launches + 1
    _close(grads[0][0], grads[1][0], TOL[dtype])
    for got, want in zip(grads[0][1:], grads[1][1:]):
        _grad_close(got, want, GRAD_TOL[dtype])


def _dense_attention_grads(q, k, v, dout, q_offset, causal, scale):
    """(dq, dk, dv) by f32 autograd of a dense attention on the card: the
    yardstick both backwards' errors are measured against."""
    B, Sq, H, Dk = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    x = [t.float().requires_grad_() for t in (q, k, v)]
    qh = x[0].transpose(1, 2)
    kh, vh = (t.transpose(1, 2).repeat_interleave(H // KV, dim=1) for t in x[1:])
    s = qh @ kh.transpose(-1, -2) * scale
    if causal:
        pos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        s = s.masked_fill(pos < torch.arange(Sk, device=q.device)[None], float("-inf"))
    o = (torch.softmax(s, dim=-1) @ vh).transpose(1, 2)
    return torch.autograd.grad(o, x, dout.float())


@pytest.mark.parametrize("B,Sq,Sk,H,KV,Dk,Dv,causal", [
    (2, 512, 512, 56, 8, 128, 128, True),       # yi-34b's heads
    (1, 1024, 1024, 56, 8, 128, 128, True),     # G = 7 over several q and key tiles
    (1, 300, 300, 8, 2, 64, 64, True),          # ragged Sq = Sk
    (1, 512, 2048, 56, 8, 128, 128, True),      # one rank's 512 of 2,048 rows at 1,536
    (2, 187, 1500, 8, 8, 64, 64, False),        # whisper's cross-attention
    (1, 256, 256, 8, 2, 128, 64, True),         # Dk != Dv
    (1, 192, 192, 8, 2, 64, 128, True),
])
def test_flash_backward_kernel_beats_plain_against_f32_and_repeats_bitwise(
        cuda, B, Sq, Sk, H, KV, Dk, Dv, causal):
    """The backward kernel against f32 autograd of a dense attention, from
    the forward kernel's out and lse: its error at most ``plain_bwd``'s
    (which also rounds the scores and products to bf16), within GRAD_TOL of
    the plain version, two calls bitwise equal (no atomics), one launch a
    call."""
    dtype, off = torch.bfloat16, Sk - Sq
    q, k, v = (_randn(s, dtype, cuda, i) for i, s in enumerate(
        [(B, Sq, H, Dk), (B, Sk, KV, Dk), (B, Sk, KV, Dv)]))
    dout = _randn((B, Sq, H, Dv), dtype, cuda, 9)
    out, lse = fa.flash_attention_fwd(q, k, v, off, causal)
    want = _dense_attention_grads(q, k, v, dout, off, causal, Dk ** -0.5)
    key = (B, Sq, Sk, H, KV, Dk, Dv, causal)
    before = (fa.flash_attention_bwd.launches_by_kernel["wgmma"],
              fa.flash_attention_bwd.launches_by_shape.get(key, 0))
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, off, causal)
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, off, causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd.launches_by_kernel["wgmma"],
            fa.flash_attention_bwd.launches_by_shape[key]) == (before[0] + 2, before[1] + 2)
    plain = fa.plain_bwd(q, k, v, out, lse, dout, off, causal)
    for g, a, p, w in zip(got, again, plain, want):
        assert g.dtype == dtype and g.shape == p.shape
        assert torch.equal(g, a)
        err, plain_err = ((t.float() - w).abs().max().item() for t in (g, p))
        assert err <= 1.1 * plain_err + 1e-3 * w.abs().max().item(), (err, plain_err)
        _grad_close(g, p, GRAD_TOL[dtype])


@pytest.mark.parametrize("rows,D", [((2, 64, 5120), 5120), ((2, 64, 40, 128), 128),
                                    ((3, 64), 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_forward_and_backward_match_autograd_of_plain(cuda, rows, D, dtype):
    x0, w0 = _randn(rows, dtype, cuda, 0), _randn((D,), dtype, cuda, 1)
    g = _randn(rows, dtype, cuda, 2)
    res = []
    for fn in (ops.rmsnorm, rms.plain):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        out = fn(x, w)
        out.backward(g)
        res.append((out.detach(), x.grad, w.grad))
    _close(res[0][0], res[1][0], 1e-5 if dtype == torch.float32 else 2e-2)
    for got, want in zip(res[0][1:], res[1][1:]):
        _grad_close(got, want, GRAD_TOL[dtype])


@pytest.mark.parametrize("n", [1, 2])
def test_vmapped_gradients_on_card_match_the_loop(cuda, n):
    """``vmap(grad(...))`` over a leading dim of 1 and 2 through both
    kernels: one launch each per call (the dim folds into rows and B)."""
    from torch.func import grad, vmap
    q = _randn((n, 2, 128, 8, 64), torch.bfloat16, cuda, 0)
    kv = _randn((n, 2, 128, 2, 64), torch.bfloat16, cuda, 1)
    w = _randn((64,), torch.bfloat16, cuda, 2)

    def f(q, kv, w):
        o = ops.flash_attention(ops.rmsnorm(q, w), kv, kv, 0, True)
        return o.float().square().sum()
    counts = (rms.rmsnorm.launches, fa.flash_attention_fwd.launches)
    got = vmap(grad(f, argnums=(0, 1, 2)), in_dims=(0, 0, None))(q, kv, w)
    assert (rms.rmsnorm.launches - counts[0], fa.flash_attention_fwd.launches - counts[1]) \
        == (1, 1)
    for i in range(n):
        want = grad(f, argnums=(0, 1, 2))(q[i], kv[i], w)
        for a, b in zip(got, want):
            _grad_close(a[i], b, GRAD_TOL[torch.bfloat16])


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "chameleon-34b", "minicpm3-4b",
                                  "qwen3-moe-30b-a3b", "arctic-480b"])
def test_lm_round_on_card_matches_cpu_and_repeats_bitwise(cuda, arch):
    """One temporal fedavgm round of the reduced arch in f32: the card
    (kernels) against the CPU (plain versions), losses and params within
    1e-4; two card runs bitwise."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train_fl_lm
    cfg = reduced_config(get_config(arch))
    fl = FLConfig(strategy="fedavgm", n_clients=4, client_lr=0.05, server_momentum=0.9)
    lm = SyntheticLM(vocab=cfg.vocab_size, seed=0)
    out = {}
    for tag, dev in (("cpu", "cpu"), ("card", cuda), ("card2", cuda)):
        _, round_fn, state = train_fl_lm.setup(cfg, fl, dev)
        state, logger = train_fl_lm.run_rounds(
            round_fn, state, lm, 0, 1, clients=4, cohort=2, batch=2, seq=64,
            local_steps=2, device=dev)
        out[tag] = (logger.series("loss"), {k: v.cpu() for k, v in state["params"].items()})
    assert out["card"][0] == out["card2"][0]
    assert all(torch.equal(out["card"][1][k], out["card2"][1][k]) for k in out["card"][1])
    np.testing.assert_allclose(out["card"][0], out["cpu"][0], rtol=1e-4)
    for k, v in out["cpu"][1].items():
        _close(out["card"][1][k], v, 1e-4)


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "chameleon-34b", "minicpm3-4b",
                                  "qwen3-moe-30b-a3b", "arctic-480b"])
def test_serve_bias_and_qk_norm_archs_on_card_match_cpu(cuda, arch):
    model = model_zoo.build(reduced_config(get_config(arch)))
    params = model.init(torch.Generator().manual_seed(0))
    prompts = torch.randint(0, 512, (2, 40), generator=torch.Generator().manual_seed(1))
    toks_cpu = serve.generate(model, params, prompts, 5)
    toks_card = serve.generate(model, _to(params, cuda), prompts.to(cuda), 5)
    assert torch.equal(toks_card.cpu(), toks_cpu)


def test_mla_serve_in_bf16_launches_wgmma_at_the_absorbed_dims(cuda):
    """minicpm3-4b's MLA dims (kv_lora 256, rope 32, nope 64, v 64) in bf16
    at a small width: every prefill attention goes to the tensor-core
    kernel at (288, 256), and a second generate repeats the tokens bitwise;
    the expanded form of one layer (``mla_seqsharded(absorbed=False)``)
    goes to it too, at (96, 64)."""
    from repro_torch.models import attention
    cfg = get_config("minicpm3-4b").replace(n_layers=2, d_model=256, n_heads=4,
                                             n_kv_heads=4, d_ff=512, vocab_size=512)
    model = model_zoo.build(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), dtype=torch.bfloat16)
    prompts = torch.randint(0, 512, (2, 96), generator=torch.Generator().manual_seed(1))
    prompts = prompts.to(cuda)
    by_kernel = dict(fa.flash_attention_fwd.launches_by_kernel)
    toks = serve.generate(model, params, prompts, 4)
    assert fa.flash_attention_fwd.launches_by_kernel == {
        "wgmma": by_kernel["wgmma"] + 2, "tf32x3": by_kernel["tf32x3"]}
    assert torch.equal(serve.generate(model, params, prompts, 4), toks)
    w = {k: v[0] for k, v in params["blocks"]["attn"].items()}
    h = params["embed"][prompts]
    with torch.inference_mode():
        oa = attention.mla_seqsharded(w, h, cfg)
        oe = attention.mla_seqsharded(w, h, cfg, absorbed=False)
    # two generates (2 layers each), then the absorbed and the expanded form
    assert fa.flash_attention_fwd.launches_by_kernel == {
        "wgmma": by_kernel["wgmma"] + 6, "tf32x3": by_kernel["tf32x3"]}
    # the two forms round in bf16 at other places: their outputs agree in norm
    assert ((oa - oe).norm() / oa.norm()).item() < 5e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_at_whispers_cross_attention(cuda, dtype):
    """B3 full (non-causal) attention at whisper-base's cross-attention:
    Sq = 187 decoder rows over Sk = 1,500 encoder keys, 8 on 8 heads of 64
    (bf16 on wgmma, f32 on tf32x3), forward and the ported backward against
    autograd through the plain version."""
    B, Sq, Sk, H, D = 2, 187, 1500, 8, 64
    args = [_randn(s, dtype, cuda, 20 + i) for i, s in enumerate(
        [(B, Sq, H, D), (B, Sk, H, D), (B, Sk, H, D)])]
    dout = _randn((B, Sq, H, D), dtype, cuda, 23)
    kernel = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    by_kernel = dict(fa.flash_attention_fwd.launches_by_kernel)
    res = []
    for fn in (lambda q, k, v: ops.flash_attention(q, k, v, 0, False),
               lambda q, k, v: fa.plain(q, k, v, 0, False)[0]):
        x = [a.clone().requires_grad_() for a in args]
        out = fn(*x)
        out.backward(dout)
        res.append((out.detach(), *(t.grad for t in x)))
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches_by_kernel[kernel] == by_kernel[kernel] + 1
    _close(res[0][0], res[1][0], TOL[dtype])
    for got, want in zip(res[0][1:], res[1][1:]):
        _grad_close(got, want, GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernel_over_whispers_encoder_cache(cuda, dtype):
    """B4 ``combine=False`` at G = 1 (8 heads on 8 kv heads of 64) over the
    1,500 keys of an encoder cache, every row at the full length, as
    ``EncDecModel.decode_step`` calls it, then normalised as there."""
    B, S, H, D = 8, 1500, 8, 64
    q = _randn((B, H, D), dtype, cuda, 30)
    k = _randn((B, S, H, D), dtype, cuda, 31)
    v = _randn((B, S, H, D), dtype, cuda, 32)
    length = torch.full((B,), S, dtype=torch.int32, device=cuda)
    launches = da.decode_attention_fwd.launches
    o, m, l = ops.decode_attention(q, k, v, length, combine=False)
    torch.cuda.synchronize()
    assert da.decode_attention_fwd.launches == launches + 1
    po, pm, pl = da.plain(q, k, v, length)
    _close(o / torch.clamp(l, min=1e-30)[..., None], po / pl[..., None], TOL[dtype])
    _close(m, pm, TOL[dtype])
    _close(l, pl, TOL[dtype])


@pytest.mark.parametrize("arch", ["whisper-base", "xlstm-125m", "jamba-1.5-large-398b"])
def test_slice12_families_on_card_match_cpu(cuda, arch):
    """Reduced whisper-base, xlstm-125m and jamba in f32 from the same
    weights: prefill logits within 1e-4 and 4 greedy decode steps' tokens
    equal on the card (kernels) and the CPU (plain versions)."""
    from repro_torch.models.transformer import pad_caches
    cfg = reduced_config(get_config(arch))
    model = model_zoo.build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    S = 32 if cfg.family == "encdec" else 40
    batch = {"tokens": torch.randint(0, 512, (2, S), generator=g)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(2, 8 * S, cfg.d_model, generator=g)
    out = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        with torch.inference_mode():
            caches, logits, _ = model.prefill(p, {k: v.to(dev) for k, v in batch.items()})
            caches = pad_caches(caches, 4)
            length = torch.full((2,), S, dtype=torch.int32, device=dev)
            toks, first = [], logits
            for i in range(4):
                tok = model.greedy_token(logits)
                toks.append(tok)
                logits, caches = model.decode_step(p, tok, caches, length + i)
        out[str(dev)] = (first.cpu(), torch.stack(toks).cpu())
    _close(out[str(cuda)][0], out["cpu"][0], 1e-4)
    assert torch.equal(out[str(cuda)][1], out["cpu"][1])


def test_kernel_past_two_to_the_31_equals_plain_over_column_slices(cuda):
    """B1 at (2, 2**31 + 4096), an int8 LM round's shape class (minicpm3-4b's
    packed N is 4.07e9): 64-bit tile, output and scale offsets, the TMA
    column below 2**31 words. The plain version of the whole row needs (C,
    N) f32 temporaries, so it is held bitwise over column slices (each
    output reads its own column and block only): the first, one across
    2**31 and the last."""
    C, N, qblock = 2, 2**31 + 4096, 256
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randint(-127, 128, (C, N), dtype=torch.int8, device=cuda, generator=g)
    s = torch.rand((C, N // qblock), device=cuda, generator=g) * 1e-2 + 1e-4
    w = torch.tensor([0.25, 0.75], device=cuda)
    launches = qa.quant_aggregate.launches
    got = qa.quant_aggregate(q, s, w)
    torch.cuda.synchronize()
    assert qa.quant_aggregate.launches == launches + 1 and got.shape == (N,)
    half = 1 << 21
    for lo in (0, 2**31 - half, N - 2 * half):
        hi = lo + 2 * half
        want = qa.plain(q[:, lo:hi], s[:, lo // qblock:hi // qblock], w)
        assert torch.equal(got[lo:hi], want), lo
    with pytest.raises(ValueError, match="N up to"):
        qa.launch_plan(C, qa.MAX_N + 4, qblock)


@pytest.mark.parametrize("arch", ["yi-34b", "minicpm3-4b", "qwen3-moe-30b-a3b",
                                  "whisper-base", "jamba-1.5-large-398b"])
def test_remat_gradient_on_card_is_bitwise_the_plain_autograd_one(cuda, arch, monkeypatch):
    """The rematerialized loss's gradient on the card (B2 and B3 launched
    again in the recompute) bitwise that of plain autograd keeping every
    activation (the baseline: ``layers.func_transform_active`` patched to
    answer yes, so ``checkpointed`` makes a plain call, as under a
    transform): the kernels, cuBLAS and the MoE routing repeat their bits
    at fixed shapes."""
    from repro_torch.models import layers
    from repro_torch.models.transformer import FlatModel
    cfg = reduced_config(get_config(arch))
    model = FlatModel(model_zoo.build(cfg))
    params = {k: v.to(cuda) for k, v in model.init(torch.Generator().manual_seed(0)).items()}
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), device=cuda, generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, 64 * cfg.dec_len_ratio, cfg.d_model), device=cuda,
                                      generator=g)
    out = {}
    for remat in (True, False):
        if not remat:
            monkeypatch.setattr(layers, "func_transform_active", lambda: True)
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        launches = (rms.rmsnorm.launches, fa.flash_attention_fwd.launches)
        loss = model.loss(p, batch)
        grads = torch.autograd.grad(loss, list(p.values()))
        torch.cuda.synchronize()
        out[remat] = (loss, grads, (rms.rmsnorm.launches - launches[0],
                                    fa.flash_attention_fwd.launches - launches[1]))
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))
    if cfg.family in ("dense", "moe"):
        # each layer's kernels again in its recompute; the final norm once
        L = cfg.n_layers
        norms, flash = out[False][2]
        assert out[True][2] == (2 * (norms - 1) + 1, 2 * flash) and flash == L


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_b2_and_b3_launch_again_in_the_recompute_and_repeat_their_bits(cuda, dtype):
    """``ops.rmsnorm`` and ``ops.flash_attention`` inside
    ``torch.utils.checkpoint`` on the card: the backward's recompute
    launches each kernel a second time, counted by shape where it launches;
    the loss is the forward's bits and the gradients bitwise those of plain
    autograd, whose backward reads the first forward's contexts."""
    import torch.utils.checkpoint as tuc

    def step(x, w, q, k, v):
        h = ops.rmsnorm(x, w)
        return ops.flash_attention(q * h[..., :1, None], k, v).float().sum() \
            + h.float().square().sum()
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((2, 256, 128), device=cuda, generator=g).to(dtype)
    w = torch.randn((128,), device=cuda, generator=g).to(dtype)
    q, k, v = (torch.randn((2, 256, 8, 128), device=cuda, generator=g).to(dtype)
               for _ in range(3))
    rkey, fkey = (512, 128), (2, 256, 256, 8, 8, 128, 128, True)
    out = {}
    for remat in (False, True):
        leaves = [t.clone().requires_grad_() for t in (x, w, q, k, v)]
        before = (rms.rmsnorm.launches_by_shape.get(rkey, 0),
                  fa.flash_attention_fwd.launches_by_shape.get(fkey, 0))
        loss = (tuc.checkpoint(step, *leaves, use_reentrant=False) if remat
                else step(*leaves))
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        out[remat] = (loss.detach(), grads,
                      (rms.rmsnorm.launches_by_shape[rkey] - before[0],
                       fa.flash_attention_fwd.launches_by_shape[fkey] - before[1]))
    assert out[False][2] == (1, 1) and out[True][2] == (2, 2)
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))


def test_int8_lm_round_on_card_launches_b1_once_and_repeats_bitwise(cuda):
    """Reduced minicpm3-4b through the int8 temporal round on the card (f32):
    one B1 launch a round, losses and params within 1e-4 of the CPU's
    (within one quantum where an int8 boundary flips: at most 1e-3 of the
    entries), two card runs bitwise."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train_fl_lm
    cfg = reduced_config(get_config("minicpm3-4b"))
    fl = FLConfig(strategy="compressed", compression="int8", n_clients=4, client_lr=0.05)
    lm = SyntheticLM(vocab=cfg.vocab_size, seed=0)
    out = {}
    for tag, dev in (("cpu", "cpu"), ("card", cuda), ("card2", cuda)):
        _, round_fn, state = train_fl_lm.setup(cfg, fl, dev)
        launches = qa.quant_aggregate.launches
        state, logger = train_fl_lm.run_rounds(
            round_fn, state, lm, 0, 2, clients=4, cohort=2, batch=2, seq=64,
            local_steps=2, device=dev)
        out[tag] = (logger.series("loss"), {k: v.cpu() for k, v in state["params"].items()},
                    qa.quant_aggregate.launches - launches)
    assert out["card"][2] == 2 and out["cpu"][2] == 0
    assert out["card"][0] == out["card2"][0]
    assert all(torch.equal(out["card"][1][k], out["card2"][1][k]) for k in out["card"][1])
    np.testing.assert_allclose(out["card"][0], out["cpu"][0], rtol=1e-4)
    outside = total = 0
    for k, v in out["cpu"][1].items():
        diff = (out["card"][1][k] - v).abs()
        outside += int((diff > 1e-4 * (1 + v.abs())).sum())
        total += diff.numel()
    assert outside <= max(1, 1e-3 * total), (outside, total)
