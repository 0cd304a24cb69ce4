"""The port's partition rule tables (``sharding/specs.py``) against the JAX
package's, and the JAX tests' checks of them (``tests/test_sharding_specs.py``):
for every arch of the registry and every phase the spec tree equals the
JAX package's (its ``PartitionSpec``s through ``interop.specs_from_jax``),
matches ``transformer.param_shapes`` leaf for leaf and divides the
production mesh; the gather table, ``placement_for`` and ``batch_specs``
equal the JAX package's.

The ZeRO-3 gather (``make_gather_fn``) and the gradient sync
(``make_grad_sync``) run on 4 ``gloo`` ranks (a (2, 2) ``("data",
"model")`` mesh; a (2, 2, 2) one over 8 for the sync's axes), spawned once
for the file: the gather of one layer of a widened reduced yi-34b (bf16,
every matrix at least 2**16 values) bitwise the JAX package's under
``shard_map`` on 4 forced host devices, plain and with ``quant=True``
(``REPRO_QUANT_GATHER=1`` in the JAX subprocess only), and each leaf's
sync axes against the JAX package's specs."""
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.sharding import specs as jspecs
from repro_torch.configs.base import ARCHS, get_config
from repro_torch.interop import specs_from_jax
from repro_torch.models import transformer
from repro_torch.sharding import specs

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
SYNC_MESHES = {"dm": ((2, 2), ("data", "model")),
               "pdm": ((2, 2, 2), ("pod", "data", "model"))}

MESH_SIZES = {"data": 16, "model": 16, "pod": 2}
PHASES = ("fsdp", "tp", "spatial")


def _leaves(tree, keys=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], keys + (k,))
    else:
        yield keys, tree


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("phase", PHASES)
def test_specs_equal_the_jax_tables(arch, phase):
    assert specs.param_specs(get_config(arch), phase) == \
        specs_from_jax(jspecs.param_specs(j_get_config(arch), phase))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("phase", PHASES)
def test_specs_match_and_divide(arch, phase):
    cfg = get_config(arch)
    shapes = list(_leaves(transformer.param_shapes(cfg)))
    spec_leaves = list(_leaves(specs.param_specs(cfg, phase)))
    assert [k for k, _ in shapes] == [k for k, _ in spec_leaves], f"{arch}/{phase}: tree mismatch"
    for (keys, shape), (_, spec) in zip(shapes, spec_leaves):
        assert len(spec) in (0, len(shape)), (arch, phase, keys)
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            factor = math.prod(MESH_SIZES[n] for n in names)
            assert shape[dim] % factor == 0, (
                f"{arch}/{phase} {'/'.join(keys)}: dim {dim} size {shape[dim]} "
                f"not divisible by {names}={factor}")


@pytest.mark.parametrize("arch", ARCHS)
def test_gather_table_equals_jax(arch):
    table = specs.gather_dim_table(get_config(arch))   # asserts on conflicts
    assert table and table == jspecs.gather_dim_table(j_get_config(arch))


@pytest.mark.parametrize("arch", ARCHS + ("flsim-cnn", "flsim-logreg"))
def test_placement_and_batch_specs_equal_jax(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert specs.placement_for(cfg) == jspecs.placement_for(jcfg)
    for kind in ("train", "prefill", "decode"):
        for batch in (1, 8, 32, 256):
            for axes in ((("data", 16), ("model", 16)),
                         (("pod", 2), ("data", 16), ("model", 16)), (("data", 2),)):
                assert specs.batch_specs(cfg, kind, batch, axes) == \
                    specs_from_jax(jspecs.batch_specs(jcfg, kind, batch, axes)), (kind, batch, axes)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_invariant_across_phases(arch):
    """Sharding never changes the parameter count (subgrid packing too)."""
    cfg = get_config(arch)
    shapes = transformer.param_shapes(cfg)
    assert sum(math.prod(s) for _, s in _leaves(shapes)) > 0
    if cfg.moe is not None and cfg.moe.ep_mode == "subgrid":
        blocks = shapes["blocks"]["moe"]["w1"]
        assert blocks[1] == cfg.moe.n_experts * cfg.moe.f_sub
        assert blocks[3] == cfg.moe.expert_d_ff // cfg.moe.f_sub


def _gather_cfg(j=False):
    """Reduced yi-34b widened so that every matrix of a layer has at least
    2**16 values (the int8 gather's threshold)."""
    from repro.configs.reduce import reduced_config as j_reduced
    from repro_torch.configs.reduce import reduced_config
    cfg = j_reduced(j_get_config("yi-34b")) if j else reduced_config(get_config("yi-34b"))
    return cfg.replace(d_model=256, d_ff=1024, head_dim=64)


def _layer():
    """Layer 0 of the widened config, bf16 values (f32 draws with their low
    16 bits cleared, so both packages' casts are exact), as nested numpy f32."""
    rng = np.random.RandomState(3)
    out = {}
    for part, leaves in transformer.dense_block_shapes(_gather_cfg()).items():
        out[part] = {}
        for name, shape in leaves.items():
            x = rng.randn(*shape).astype(np.float32)
            out[part][name] = (x.view(np.uint32) & 0xFFFF0000).view(np.float32)
    return out


def _local(layer, rank):
    """Rank (d, m)'s shard of the layer: its model block of each leaf's
    gather dim (``gather_dim_table``)."""
    table = specs.gather_dim_table(_gather_cfg())
    m = rank % 2
    out = {}
    for part, leaves in layer.items():
        out[part] = {}
        for name, x in leaves.items():
            d = table[(part, name)]
            n = x.shape[d] // 2
            out[part][name] = torch.from_numpy(np.take(x, range(m * n, (m + 1) * n), axis=d)
                                               .copy()).to(torch.bfloat16)
    return out


def rank_body(rank, world):
    """One rank: the layer's gather, plain and int8; each leaf's sync axes
    on both meshes for every arch; one sync on (2, 2)."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import mesh_ctx

    torch.set_num_threads(1)
    ctxs = {m: mesh_ctx(make_test_mesh(shape, axes, device="cpu"))
            for m, (shape, axes) in SYNC_MESHES.items()}
    out = {"axes": {m: {arch: specs.grad_sync_axes(get_config(arch), ctx)
                        for arch in ARCHS} for m, ctx in ctxs.items()}}
    if rank >= 4:
        return out
    ctx = ctxs["dm"]
    blk = _local(_layer(), rank)
    for quant in (False, True):
        got = specs.make_gather_fn(_gather_cfg(), ctx, quant=quant)(blk)
        out[("gather", quant)] = {f"{p}/{k}": v.to(torch.float32).numpy()
                                  for p, leaves in got.items() for k, v in leaves.items()}
    # the sync on a rank-valued gradient: mean over data, sum over model
    cfg = _gather_cfg()
    grads = {k: torch.full((1, 2), float(rank + 1)) for k in
             transformer.flatten_params(transformer.param_shapes(cfg))}
    out["synced"] = {k: v.numpy() for k, v in specs.make_grad_sync(cfg, ctx)(grads).items()}
    return out


def _jax_side(out_path):
    """This file as a script: the JAX gather under ``shard_map`` on a (2, 2)
    mesh of forced host devices, plain and with REPRO_QUANT_GATHER=1."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.launch.mesh import make_test_mesh
    from repro.sharding.axes import AxisCtx
    try:
        from jax.experimental.shard_map import shard_map
    except ImportError:
        from jax.sharding import shard_map

    cfg = _gather_cfg(j=True)
    mesh = make_test_mesh((2, 2), ("data", "model"))
    ctx = AxisCtx(data="data", model="model")
    table = jspecs.gather_dim_table(cfg)
    layer = _layer()
    in_specs = {p: {k: P(*[("model" if i == table[(p, k)] else None)
                           for i in range(x.ndim)]) for k, x in leaves.items()}
                for p, leaves in layer.items()}
    blk = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), layer)
    res = {}
    for quant in (False, True):
        os.environ["REPRO_QUANT_GATHER"] = "1" if quant else "0"
        gather = jspecs.make_gather_fn(cfg, ctx)

        def body(b, gather=gather):
            return jax.tree.map(lambda t: t.astype(jnp.float32)[None], gather(b))
        f = shard_map(body, mesh=mesh, in_specs=(in_specs,),
                      out_specs=P(("data", "model")), check_rep=False)
        got = jax.jit(f)(blk)
        for p, leaves in got.items():
            for k, v in leaves.items():
                res[f"{int(quant)}|{p}/{k}"] = np.asarray(v)       # (4, ...) device order
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The port's 8 ranks and the JAX gather, each run once."""
    from repro_torch.launch.mesh import spawn

    out = str(tmp_path_factory.mktemp("gather") / "jax.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), out], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    got = spawn(rank_body, 8, "cpu")
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with np.load(out) as z:
        return got, dict(z)


@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
def test_gather_fn_matches_jax_bitwise(ranks, quant):
    got, jx = ranks
    layer = _layer()
    n = 0
    for r in range(4):
        for key, v in got[r][("gather", quant)].items():
            want = jx[f"{int(quant)}|{key}"][r]
            np.testing.assert_array_equal(v, want, err_msg=f"rank {r} {key}")
            if not quant:
                part, name = key.split("/")
                np.testing.assert_array_equal(v, layer[part][name])   # the whole leaf
            n += 1
    assert n == 4 * len(transformer.flatten_params(layer))
    if quant:      # the int8 round trip moved values: it is not the plain gather
        assert any(not np.array_equal(v, got[0][("gather", False)][k])
                   for k, v in got[0][("gather", True)].items())


def _jax_rule(cfg, axes):
    """Each flat leaf's (mean axes, sum axes) from the JAX package's fsdp
    specs: the mean over the batch axes it is not sharded over (its
    ``make_grad_sync``), the sum over ``model`` where it is not sharded."""
    flat = transformer.flatten_params(specs_from_jax(jspecs.param_specs(
        j_get_config(cfg.name), "fsdp")))

    def has(sp, a):
        return any(a in (e if isinstance(e, tuple) else (e,)) for e in sp if e is not None)
    return {k: (tuple(a for a in ("pod", "data") if a in axes and not has(sp, a)),
                ("model",) if not has(sp, "model") else ())
            for k, sp in flat.items()}


@pytest.mark.parametrize("mesh", sorted(SYNC_MESHES))
def test_grad_sync_axes_per_leaf(ranks, mesh):
    got, _ = ranks
    axes = SYNC_MESHES[mesh][1]
    for arch in ARCHS:
        want = _jax_rule(get_config(arch), axes)
        assert got[0]["axes"][mesh][arch] == want, arch
        assert all(got[r]["axes"][mesh][arch] == want for r in range(len(got)))
    yi = got[0]["axes"][mesh]["yi-34b"]
    assert yi["final_norm/w"][1] == ("model",) and yi["blocks/attn/wq"][1] == ()


def test_grad_sync_means_over_data_and_sums_over_model(ranks):
    got, _ = ranks
    # rank r = 2 d + m holds r + 1: the data mean of ranks (m, 2 + m) is m + 2,
    # the model sum of that over m = 0, 1 is 5
    for r in range(4):
        for k, v in got[r]["synced"].items():
            want = 5.0 if k == "final_norm/w" else (r % 2) + 2.0
            np.testing.assert_array_equal(v, np.full((1, 2), want, np.float32), err_msg=k)


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    _jax_side(sys.argv[1])
