"""The dry run of a production-mesh cell as one rank (``launch/dryrun.py``)
and its counter (``launch/op_cost.py``), against a real multi-rank run and
against the JAX package's compile of the same cells.

- The counter against a real run: reduced yi-34b, qwen3-moe-30b-a3b (its
  all-to-alls) and jamba-1.5-large-398b (its ``ppermute``s) at their train,
  prefill and decode steps on a (2, 2) mesh of 4 ``gloo`` ranks
  (``launch/mesh.spawn``, once for the file). Each rank records its
  collectives under ``cost_scope`` in a real CPU run; its meta dry run over
  ``mesh.fake_world(4, r)`` must record the same ``(kind, result bytes,
  group size)`` sequence, exactly.
- Against the JAX package (this file as a script on 8 forced host devices,
  its ``launch/dryrun.py`` compile and ``launch/hlo_cost.analyze``), four
  reduced cells on (2, 2): the per-rank input bytes leaf by leaf, and the
  FLOPs within 5 % once each term the port computes otherwise is counted
  (``c10_loss_flops``, ``masked_attention_flops``). The collective counts
  differ by design (``PERF.md`` sets them side by side).
- Published width on the meta device, one cell of each family and path, on
  both production meshes: the record's keys, its input bytes against the
  step's input trees, and costs linear in the depth.
- The kernels' meta branches: the plain version's shapes and dtypes, their
  module's ``cost`` recorded, no launch counted.
- ``launch/train.py --dry-run``.

This module imports no JAX at its top: the spawned ranks import it.
"""
import json
import math
import os
import re
import subprocess
import sys

import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
COUNTER_ARCHS = ("yi-34b", "qwen3-moe-30b-a3b", "jamba-1.5-large-398b")
KINDS = ("train", "prefill", "decode")
JAX_CELLS = (("yi-34b", "train"), ("yi-34b", "prefill"), ("yi-34b", "decode"),
             ("qwen3-moe-30b-a3b", "train"))
S, B = 32, 8                      # tests/test_system.py's reduced dry-run cell
# leaves XLA drops from the compiled program because the step never reads
# them: the fedavg train step's client weight and key, the prefill's labels
UNREAD_BY_JAX = {"train": ("[2]", "[3]"), "prefill": ("[1]/labels",), "decode": ()}
# one cell of each family and path at published width
WIDTH_CELLS = (("yi-34b", "train_4k"), ("qwen3-moe-30b-a3b", "decode_32k"),
               ("arctic-480b", "train_4k"), ("minicpm3-4b", "prefill_32k"),
               ("jamba-1.5-large-398b", "long_500k"), ("whisper-base", "decode_32k"),
               ("xlstm-125m", "long_500k"))
RECORD_KEYS = {"arch", "shape", "mesh", "kind", "layers", "rank", "device", "build_s",
               "run_s", "memory", "fits", "hbm_GiB", "cost", "collectives", "kernels"}


@pytest.fixture(autouse=True)
def one_thread():
    """Every test here on one torch intra-op thread (the suite runs in
    several processes that share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(arch):
    from repro_torch.configs.base import get_config
    from repro_torch.configs.reduce import reduced_config
    return reduced_config(get_config(arch))


def _shape(kind):
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig(kind, S, B, kind)


def _counted_calls(built, shape, device):
    """The collectives of one run of ``built`` on ``device``, in order."""
    from repro_torch.launch import dryrun, op_cost
    if device == "meta":
        return dryrun.measure(built, shape)[1].calls
    inputs = dryrun.rank_inputs(built, shape, device)
    with op_cost.cost_scope() as cost:
        built.fn(*inputs)
    return cost.calls


def counter_rank(rank, world):
    """One of 4 ``gloo`` ranks: every counter cell's collectives in a real
    CPU run on (2, 2), then in the meta dry run of this rank."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps

    torch.set_num_threads(1)
    out = {}
    for device in ("cpu", "meta"):
        if device == "meta":
            mesh_mod.fake_world(world, rank, "meta")
        mesh = mesh_mod.make_test_mesh((2, 2), device=device)
        for arch in COUNTER_ARCHS:
            for kind in KINDS:
                built = steps.make_step_from_cfg(_cfg(arch), _shape(kind), mesh)
                out[device, arch, kind] = _counted_calls(built, _shape(kind), device)
    return out


@pytest.fixture(scope="module")
def counter_runs():
    from repro_torch.launch.mesh import spawn
    return spawn(counter_rank, 4, "cpu")


@pytest.mark.parametrize("arch", COUNTER_ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_meta_dry_run_records_the_collectives_of_a_real_run(counter_runs, arch, kind):
    for rank, runs in enumerate(counter_runs):
        real, meta = runs["cpu", arch, kind], runs["meta", arch, kind]
        assert real, (rank, arch, kind)
        assert meta == real, (rank, arch, kind)
    kinds = {c[0] for runs in counter_runs for c in runs["cpu", arch, kind]}
    if arch == "qwen3-moe-30b-a3b" and kind != "decode":
        assert "all-to-all" in kinds
    if arch == "jamba-1.5-large-398b" and kind != "decode":
        assert "collective-permute" in kinds


def test_permute_traffic_is_what_each_rank_sends(counter_runs):
    """jamba's Mamba conv boundary rows go from each model rank to the
    next, and the last rank of the axis (ranks 1 and 3 of (2, 2)) sends
    none, while every rank sends each hop of the MoE grid ring: the ranks'
    permute bytes differ (the JAX package's SPMD HLO counts them alike)."""
    sent = [sum(b for k, b, _ in runs["cpu", "jamba-1.5-large-398b", "prefill"]
                if k == "collective-permute") for runs in counter_runs]
    assert sent[0] == sent[2] > sent[1] == sent[3] > 0


# -- against the JAX package ------------------------------------------------

def _jax_side(out_path):
    """This file as a script: the JAX package's dry-run compile of the
    reduced cells on (2, 2) -> per cell its argument bytes, per-device
    input leaves, ``hlo_cost`` FLOPs and collective counts."""
    import jax

    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import get_config as j_get_config
    from repro.configs.reduce import reduced_config as j_reduced
    from repro.launch import hlo_cost
    from repro.launch import steps as jsteps
    from repro.launch.dryrun import collective_bytes
    from repro.launch.mesh import make_test_mesh, mesh_context

    mesh = make_test_mesh((2, 2), ("data", "model"))
    res = {}
    for arch, kind in JAX_CELLS:
        built = jsteps.make_step_from_cfg(j_reduced(j_get_config(arch)),
                                          JShape("t", S, B, kind), mesh)
        with mesh_context(mesh):
            compiled = jax.jit(built.fn, donate_argnums=built.donate).lower(
                *built.inputs).compile()
        txt = compiled.as_text()
        leaves = {jax.tree_util.keystr(p): [math.prod(leaf.sharding.shard_shape(leaf.shape)),
                                            leaf.dtype.itemsize, str(leaf.dtype)]
                  for p, leaf in jax.tree_util.tree_leaves_with_path(built.inputs)}
        res[f"{arch}/{kind}"] = {
            "args": compiled.memory_analysis().argument_size_in_bytes,
            "flops": hlo_cost.analyze(txt).flops, "leaves": leaves,
            "coll": dict(collective_bytes(txt)["counts"])}
    with open(out_path, "w") as f:
        json.dump(res, f)


def _norm(path: str) -> str:
    """A JAX ``keystr`` path or the port's as one spelling: ``[i]`` for a
    position, ``/name`` for a key or a field."""
    return re.sub(r"\['([^']*)'\]|\.(\w+)", lambda m: "/" + (m.group(1) or m.group(2)), path)


def _port_leaves(built):
    """{path: (elements, bytes an element, dtype)} of this rank's inputs."""
    from repro_torch.launch import steps

    def walk(t, path):
        if isinstance(t, steps.InputSpec):
            yield path, (math.prod(built.local_shape(t)),
                         torch.empty((), dtype=t.dtype).element_size(), t.dtype)
        elif isinstance(t, dict):
            for k in sorted(t):
                yield from walk(t[k], path + "/" + "/".join(str(k).split(".")))
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for f, v in zip(t._fields, t):
                yield from walk(v, f"{path}/{f}")
        elif isinstance(t, (tuple, list)):
            for i, v in enumerate(t):
                yield from walk(v, f"{path}[{i}]")
    return dict(walk(built.inputs, ""))


def c10_loss_flops(cfg, shape, sizes, kind) -> float:
    """ROADMAP C10: the port's loss runs over every row of the batch shard,
    gathered over the vocab axis (``model``), where the JAX package's runs
    over the rank's own rows: (M - 1) rank-shards of rows more, each row's
    logits 2·D·V/M operations forward and twice that backward."""
    if kind != "train":
        return 0.0
    M = sizes["model"]
    rows = shape.global_batch * shape.seq_len // (sizes["data"] * M)
    return 3 * 2 * (M - 1) * rows * cfg.d_model * cfg.padded_vocab / M


def masked_attention_flops(cfg, shape, sizes, model_index, kind) -> float:
    """The pairs a causal mask takes out: the JAX package's blockwise
    forward computes the rank's rows against every key of the gathered
    sequence, B3's ``cost`` only the pairs the mask lets through (rows at
    ``q_offset = index(model) · S_loc``). One forward a layer, and its
    recompute in training; the backward is torch ops in the port too."""
    from repro_torch.kernels import flash_attention as fa
    if kind == "decode":
        return 0.0
    M = sizes["model"]
    args = (shape.global_batch // sizes["data"], shape.seq_len // M, shape.seq_len,
            cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.resolved_head_dim)
    off = model_index * shape.seq_len // M
    per = fa.cost(*args, 0, False, 2)[0] - fa.cost(*args, off, True, 2)[0]
    return per * cfg.n_layers * (2 if kind == "train" else 1)


@pytest.fixture(scope="module")
def jax_cells(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun") / "jax.json")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), out], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port_cells():
    """Every rank's meta dry run of the JAX cells: (leaves, record)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    out = {}
    try:
        for rank in range(4):
            mesh_mod.fake_world(4, rank, "meta")
            mesh = mesh_mod.make_test_mesh((2, 2), device="meta")
            for arch, kind in JAX_CELLS:
                built = steps.make_step_from_cfg(_cfg(arch), _shape(kind), mesh)
                out[arch, kind, rank] = (_port_leaves(built),
                                         dryrun.measure(built, _shape(kind))[0],
                                         built.ctx.index("model"))
    finally:
        mesh_mod.end_world()
    return out


@pytest.mark.parametrize("cell", JAX_CELLS, ids=lambda c: "-".join(c))
def test_input_bytes_match_the_jax_compile_leaf_by_leaf(jax_cells, port_cells, cell):
    arch, kind = cell
    want = jax_cells[f"{arch}/{kind}"]
    jleaves = {_norm(p): v for p, v in want["leaves"].items()}
    for rank in range(4):
        leaves, rec, _ = port_cells[arch, kind, rank]
        assert set(leaves) == set(jleaves), (rank, set(leaves) ^ set(jleaves))
        wider = 0
        for path, (n, size, dtype) in leaves.items():
            jn, jsize, jdtype = jleaves[path]
            if path in ("[1]/tokens", "[1]/labels") or (kind == "decode" and path == "[1]"):
                # the one named difference: token ids are int64 here, int32 there
                assert (n, dtype, jdtype) == (jn, torch.int64, "int32"), (rank, path)
                wider += n * (size - jsize)
            else:     # the train key: one int64 here, two uint32 there
                assert n * size == jn * jsize, (rank, path)
        port_args = round(rec["memory"]["args_GiB"] * 2**30)
        assert port_args == sum(n * s for n, s, _ in leaves.values())
        unread = sum(jleaves[p][0] * jleaves[p][1] for p in UNREAD_BY_JAX[kind])
        assert port_args - wider - unread == want["args"], rank


@pytest.mark.parametrize("cell", JAX_CELLS, ids=lambda c: "-".join(c))
def test_flops_match_the_jax_hlo_cost_within_5_percent(jax_cells, port_cells, cell):
    arch, kind = cell
    cfg, sizes = _cfg(arch), {"data": 2, "model": 2}
    for rank in range(4):
        _, rec, model_index = port_cells[arch, kind, rank]
        want = (jax_cells[f"{arch}/{kind}"]["flops"]
                + c10_loss_flops(cfg, _shape(kind), sizes, kind)
                - masked_attention_flops(cfg, _shape(kind), sizes, model_index, kind))
        assert abs(rec["cost"]["flops"] - want) <= 0.05 * want, (rank, rec["cost"], want)


# -- published width on the meta device -------------------------------------

def _period(arch) -> int:
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    return (cfg.hybrid.period if cfg.family == "hybrid" else
            cfg.ssm.slstm_every if cfg.family == "ssm" else 1)


def _rank_bytes(tree, sizes) -> int:
    from repro_torch.launch import steps
    total = 0
    for sp in steps._leaves(tree):
        n = math.prod(sp.shape)
        for e in sp.spec:
            if e is not None:
                n //= math.prod(sizes[a] for a in (e if isinstance(e, tuple) else (e,)))
        total += n * torch.empty((), dtype=sp.dtype).element_size()
    return total


def _input_trees(arch, shape_name, sizes, layers):
    """The step's input trees, from the builders that make them."""
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.steps import InputSpec
    from repro_torch.sharding import specs
    cfg, shape = dryrun.truncated(get_config(arch), layers), SHAPES[shape_name]
    bspec = (steps._entry(steps._batch_axes(sizes, shape.global_batch)),)
    temporal = specs.placement_for(cfg) == "temporal"
    if shape.kind == "train":
        return (steps.param_structs(cfg, sizes, "fsdp"),
                steps.batch_struct(cfg, shape, sizes, lead=(1, 1)),
                InputSpec((1,), torch.float32), InputSpec((), torch.int64))
    if shape.kind == "prefill":
        return (steps.param_structs(cfg, sizes, "fsdp" if temporal else "spatial"),
                steps.batch_struct(cfg, shape, sizes))
    return (steps.param_structs(cfg, sizes, "tp" if temporal else "spatial"),
            InputSpec((shape.global_batch,), torch.int64, bspec),
            steps.cache_tree(cfg, shape, sizes),
            InputSpec((shape.global_batch,), torch.int32, bspec))


def _costs(rec) -> dict:
    c = rec["collectives"]
    return {"flops": rec["cost"]["flops"], "bytes": rec["cost"]["bytes_accessed"],
            **{f"count {k}": v for k, v in c["counts"].items()},
            **{f"result {k}": v for k, v in c["result_bytes"].items()},
            "launches": sum(e["launches"] for e in rec["kernels"].values())}


@pytest.fixture(scope="module")
def width_runs():
    """Each width cell at 2, 3 and 4 layers (periods for hybrid and xLSTM)
    on both meshes, and at 2 layers (one period)."""
    from repro_torch.launch import dryrun
    out = {}
    for arch, shape in WIDTH_CELLS:
        p = _period(arch)
        for mp in (False, True):
            for depth in sorted({2, 2 * p, 3 * p, 4 * p}):
                out[arch, shape, mp, depth] = dryrun.run_cell(arch, shape, mp, depth,
                                                               verbose=False)
    return out


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("cell", WIDTH_CELLS, ids=lambda c: "-".join(c))
def test_published_width_cell_runs_on_the_meta_device(width_runs, cell, multi_pod):
    arch, shape = cell
    rec = width_runs[arch, shape, multi_pod, 2]
    assert RECORD_KEYS <= set(rec)
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16") and rec["device"] == "meta"
    assert rec["layers"] == max(2, _period(arch))
    assert set(rec["memory"]) == {"args_GiB", "output_GiB", "temp_GiB", "peak_GiB"}
    assert rec["memory"]["peak_GiB"] >= rec["memory"]["args_GiB"] > 0
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
    assert set(rec["collectives"]) == {"traffic_bytes", "result_bytes", "counts"}
    sizes = ({"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16})
    want = _rank_bytes(_input_trees(arch, shape, sizes, 2), sizes)
    assert round(rec["memory"]["args_GiB"] * 2**30) == want


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("cell", WIDTH_CELLS, ids=lambda c: "-".join(c))
def test_cost_is_linear_in_the_depth(width_runs, cell, multi_pod):
    """cost(4) - cost(2) = 2 (cost(3) - cost(2)), in layers (periods for
    hybrid and xLSTM): the JAX roofline's depth extrapolation assumes it."""
    arch, shape = cell
    p = _period(arch)
    c2, c3, c4 = (_costs(width_runs[arch, shape, multi_pod, k * p]) for k in (2, 3, 4))
    for key in c2:
        assert c4[key] - c2[key] == 2 * (c3[key] - c2[key]), key
    t2, t3, t4 = (width_runs[arch, shape, multi_pod, k * p]["collectives"]["traffic_bytes"]
                  for k in (2, 3, 4))
    for kind in t2:
        assert t4[kind] - t2[kind] == pytest.approx(2 * (t3[kind] - t2[kind]), rel=1e-12)


# -- the pieces ------------------------------------------------------------

def test_traffic_formulas_and_cost_arithmetic():
    from repro_torch.launch import op_cost
    assert op_cost.traffic("all-gather", 1600, 16) == 1500
    assert op_cost.traffic("all-to-all", 1600, 16) == 1500
    assert op_cost.traffic("all-reduce", 1600, 16) == 3000
    assert op_cost.traffic("reduce-scatter", 100, 16) == 1500
    assert op_cost.traffic("collective-permute", 100, 16) == 100
    with pytest.raises(ValueError):
        op_cost.traffic("broadcast", 1, 2)
    with op_cost.cost_scope() as c:
        op_cost.record_collective("all-reduce", 64, 4)
        op_cost.record_kernel("rmsnorm", (4, 8), 128, 72)
        torch.ones(4, 8) @ torch.ones(8, 2)
    assert c.calls == [("all-reduce", 64, 4)] and c.coll_counts["all-reduce"] == 1
    assert c.flops == 128 + 2 * 4 * 8 * 2
    assert c.by_kernel["rmsnorm"] == {"launches": 1, "flops": 128, "bytes": 72,
                                      "by_shape": {"4,8": 1}}
    twice = op_cost.Cost().add(c).add(c)
    assert twice.flops == 2 * c.flops and twice.coll_traffic["all-reduce"] == 2 * 96
    assert twice.scaled(0.5).by_kernel["rmsnorm"]["launches"] == 1
    op_cost.record_collective("all-reduce", 64, 4)     # outside a scope: nothing
    assert not op_cost.active() and len(c.calls) == 1


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_rmsnorm_meta_branch_is_the_kernels_output_and_records_its_cost():
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.launch import op_cost
    x, w = torch.randn(4, 8, 64).bfloat16(), torch.randn(64).bfloat16()
    want = rms.plain(x, w)
    launches = rms.rmsnorm.launches
    with op_cost.cost_scope() as c:
        got = rms.rmsnorm(x.to("meta"), w.to("meta"))
    assert got.shape == want.shape and got.dtype == want.dtype and got.is_meta
    assert c.by_kernel["rmsnorm"]["by_shape"] == {"32,64": 1}
    assert (c.by_kernel["rmsnorm"]["flops"], c.by_kernel["rmsnorm"]["bytes"]) == \
        rms.cost(32, 64, 2, 2)
    assert rms.rmsnorm.launches == launches


def test_flash_attention_meta_branch_is_the_kernels_output_and_records_its_cost():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import op_cost
    q, k, v = torch.randn(2, 16, 4, 32), torch.randn(2, 48, 2, 32), torch.randn(2, 48, 2, 16)
    want = fa.plain(q, k, v, 32, True)
    launches = fa.flash_attention_fwd.launches
    with op_cost.cost_scope() as c:
        got = fa.flash_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"), 32, True)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape and g.dtype == w_.dtype and g.is_meta
    e = c.by_kernel["flash_attention"]
    assert e["by_shape"] == {"2,16,48,4,2,32,16,1": 1}
    assert (e["flops"], e["bytes"]) == fa.cost(2, 16, 48, 4, 2, 32, 16, 32, True, 4)
    # rows at 32..47 see 33..48 keys: every pair of the 48 but the mask's
    assert fa.cost(1, 16, 48, 1, 1, 1, 1, 32, True, 4)[0] == 2 * 2 * sum(range(33, 49))
    assert fa.flash_attention_fwd.launches == launches
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(*(t.to("meta").transpose(0, 1).contiguous().transpose(0, 1)
                                 for t in (q, k, v)))


def test_decode_attention_meta_branch_allocates_its_scratch_and_records_its_cost():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import dryrun, op_cost
    q, k, v = torch.randn(2, 8, 16), torch.randn(2, 600, 2, 16), torch.randn(2, 600, 2, 16)
    length = torch.tensor([5, 600], dtype=torch.int32)
    want = da.plain(q, k, v, length)
    meta = [t.to("meta") for t in (q, k, v, length)]
    with dryrun.LiveBytes("meta") as mem, op_cost.cost_scope() as c:
        got = da.decode_attention_fwd(*meta)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape and g.dtype == w_.dtype and g.is_meta
    e = c.by_kernel["decode_attention"]
    assert e["by_shape"] == {"2,600,8,2,16,16": 1}
    assert (e["flops"], e["bytes"]) == da.cost(2, 600, 8, 2, 16, 16, 4)   # the whole cache
    n_split = -(-600 // da.CHUNK)
    # o, m, l and the split's partials, as the card allocates them
    assert mem.peak == sum(dryrun._block(4 * n) for n in
                           (2 * 8 * 16, 2 * 8, 2 * 8, 2 * 8 * n_split * 18))


def test_quant_aggregate_meta_records_through_the_custom_op():
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_aggregate as qa
    from repro_torch.launch import op_cost
    q = torch.empty(3, 1024, dtype=torch.int8, device="meta")
    s, w = torch.empty(3, 4, device="meta"), torch.empty(3, device="meta")
    with op_cost.cost_scope() as c:
        out = ops.quant_aggregate(q, s, w)
    assert out.shape == (1024,) and out.dtype == torch.float32
    assert c.by_kernel["quant_aggregate"]["by_shape"] == {"1,3,1024,256": 1}
    assert c.by_kernel["quant_aggregate"]["bytes"] == qa.cost(1, 3, 1024, 256)[1]


def test_live_bytes_counts_an_engine_sum_in_place():
    """Two gradients of one tensor: summed in place into one of them by
    the engine without a mode, so the peak holds no third buffer."""
    from repro_torch.launch import dryrun
    x = torch.empty(1024, device="meta", requires_grad=True)
    with dryrun.LiveBytes("meta") as mem:
        y = x * 2
        z = (y * 3).sum() + (y * 4).sum()
        (g,) = torch.autograd.grad(z, x)
    # x's grad flows through y's two uses: 2 * 1024 f32 at most beside y
    assert mem.peak <= 3 * 4096 + 4 * 512


def test_live_bytes_counts_engine_writes_in_place_under_the_cost_counter():
    """As ``measure`` runs a meta step: ``op_cost``'s counter dispatches
    above ``LiveBytes``. The engine's sum and ``gather``'s backward (a
    ``scatter_add`` into zeros, as the loss's vocab gather takes it) still
    count as done in place, as the card does them."""
    from repro_torch.launch import dryrun, op_cost
    x = torch.empty(1024, device="meta", requires_grad=True)
    with dryrun.LiveBytes("meta") as mem, op_cost.cost_scope():
        y = x * 2
        z = (y * 3).sum() + (y * 4).sum()
        (g,) = torch.autograd.grad(z, x)
    assert mem.peak <= 3 * 4096 + 4 * 512
    x = torch.empty(4096, 40, device="meta", requires_grad=True)
    idx = torch.zeros(4096, 1, dtype=torch.long, device="meta")
    with dryrun.LiveBytes("meta") as mem, op_cost.cost_scope():
        mem.track(x)
        (g,) = torch.autograd.grad(x.gather(1, idx).sum(), x)
    # x and its gradient, not a third buffer of x's size
    assert mem.peak < 3 * x.numel() * 4


def test_live_bytes_walks_through_no_other_mode_to_the_engine():
    """Only ``op_cost``'s counter stands between ``LiveBytes`` and the
    engine: under any other mode the op was issued by that mode's Python
    code, so the engine's sum counts out of place."""
    from repro_torch.launch import dryrun

    class Passthrough(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return func(*args, **(kwargs or {}))
    x = torch.empty(1024, device="meta", requires_grad=True)
    with dryrun.LiveBytes("meta") as mem, Passthrough():
        y = x * 2
        z = (y * 3).sum() + (y * 4).sum()
        (g,) = torch.autograd.grad(z, x)
    assert mem.peak > 3 * 4096 + 4 * 512


def test_fake_world_names_the_module_it_needs(monkeypatch):
    from repro_torch.launch import mesh as mesh_mod
    monkeypatch.setitem(sys.modules, "torch.testing._internal.distributed.fake_pg", None)
    with pytest.raises(RuntimeError, match="fake_pg"):
        mesh_mod.fake_world(4, 0)


def test_dry_run_main_names_a_failing_cell(monkeypatch, tmp_path, capsys):
    from repro_torch.launch import dryrun

    def refuse(*a, **k):
        raise ValueError("a port check refuses this cell")
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    monkeypatch.setattr(dryrun.steps_mod, "make_step_from_cfg", refuse)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "yi-34b", "--shape", "decode_32k", "--layers", "1"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "1 FAILURES" in out and "yi-34b__decode_32k__sp__L1" in out and "refuses" in out


def test_train_dry_run_hands_the_cell_to_the_dry_run(monkeypatch, tmp_path):
    from repro_torch.launch import dryrun, train
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    (rec,) = train.main(["--dry-run", "--arch", "yi-34b", "--layers", "1"])
    assert RECORD_KEYS <= set(rec)
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["layers"], rec["device"]) == \
        ("yi-34b", "train_4k", "16x16", 1, "meta")
    assert rec["kernels"]["flash_attention"]["launches"] == 2    # the forward, its recompute
    assert json.loads((tmp_path / "yi-34b__train_4k__sp__L1.json").read_text()) == rec


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    _jax_side(sys.argv[1])
