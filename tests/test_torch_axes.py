"""The port's ``AxisCtx`` (``sharding/axes.py``) against the JAX package's
on the same meshes, and the mesh configs (``configs/base.py``).

Every collective of ``AxisCtx`` runs on a (2, 2) ``("data", "model")`` and
a (2, 2, 2) ``("pod", "data", "model")`` mesh: the port on 8 ``gloo`` ranks
(``launch/mesh.spawn``; every rank builds both meshes, ranks 4-7 sit
outside the (2, 2) one), the JAX package under ``shard_map`` on 8 forced
host devices in a subprocess (this file run as a script: the device count
must be set before jax initializes). Each rank or device holds block
``rank`` of one numpy-seeded global array; single axes and tuples of axes
(``data_axes``, the whole grid in either order) are checked. Gathers,
all-to-alls and permutes move data only: bitwise. Sums: within 1e-6.

The gradients (C9): each differentiable collective's gradient of
``sum(f(x) * c)``, ``c`` a numpy-seeded cotangent block shaped like the
output, on every rank against ``jax.grad`` inside the ``shard_map`` body
(the transposes ``jax.lax`` gives under ``check_rep=False``), within 1e-6;
``pmax``'s value as ``jax.lax.pmax`` gives it, and no gradient.
This module imports no JAX at its top: the spawned ranks import it.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
MESHES = {"dm": ((2, 2), ("data", "model")),
          "pdm": ((2, 2, 2), ("pod", "data", "model"))}
NAMES = {"dm": ["data", "model", ("data", "model"), ("model", "data")],
         "pdm": ["pod", "data", "model", ("pod", "data"), ("data", "model"),
                 ("pod", "data", "model"), ("model", "pod", "data")]}
LOCAL = (2, 8, 8)           # each device's block of the global array
OPS = ("psum", "pmean", "all_gather", "psum_scatter", "all_to_all", "ppermute", "index",
       "pmax")
GRAD_OPS = ("psum", "pmean", "all_gather", "psum_scatter", "all_to_all", "ppermute")


def _key(mesh, name, op):
    return f"{mesh}|{'+'.join(name) if isinstance(name, tuple) else name}|{op}"


def _global_x():
    return np.random.RandomState(0).randn(8 * LOCAL[0], *LOCAL[1:]).astype(np.float32)


def _pmax(ctx):
    """``ctx.pmax``, or for the JAX package's ``AxisCtx`` (which has none)
    ``jax.lax.pmax``, as its model code calls it."""
    if hasattr(ctx, "pmax"):
        return ctx.pmax
    import jax
    return lambda x, name: jax.lax.pmax(x, name)


def _ops(ctx, name):
    """op name -> the collective of ``ctx`` over ``name`` as a function of
    the local block (``ppermute``: the ring shift, single axes only)."""
    ops = {"psum": lambda x: ctx.psum(x, name),
           "pmean": lambda x: ctx.pmean(x, name),
           "all_gather": lambda x: ctx.all_gather(x, name, axis=1),
           "psum_scatter": lambda x: ctx.psum_scatter(x, name, axis=1),
           "all_to_all": lambda x: ctx.all_to_all(x, name, split_axis=1, concat_axis=2),
           "pmax": lambda x: _pmax(ctx)(x, name)}
    if not isinstance(name, tuple):
        sz = ctx.size(name)
        ops["ppermute"] = lambda x: ctx.ppermute(x, name, [(i, (i + 1) % sz)
                                                           for i in range(sz)])
    return ops


def _collectives(ctx, x, name, put):
    """Every collective of ``ctx`` over ``name`` on the local block ``x``;
    ``put(op, value)`` records each."""
    for op, fn in _ops(ctx, name).items():
        put(op, fn(x))
    put("index", ctx.index(name))


def _out_shape(op, n):
    """The local output shape of ``op`` over an axis of ``n`` devices."""
    b, s, d = LOCAL
    return {"all_gather": (b, s * n, d), "psum_scatter": (b, s // n, d),
            "all_to_all": (b, s // n, d * n)}.get(op, LOCAL)


def _cotangent(mesh, name, op, n):
    """The global cotangent of ``op``: one numpy-seeded block a device,
    stacked on dim 0 in device order."""
    shape = _out_shape(op, _size(mesh, name))
    seed = sum(map(ord, _key(mesh, name, op)))
    return np.random.RandomState(seed).randn(n * shape[0], *shape[1:]).astype(np.float32)


def _size(mesh, name):
    shape, axes = MESHES[mesh]
    names = name if isinstance(name, tuple) else (name,)
    return int(np.prod([shape[axes.index(a)] for a in names]))


def rank_body(rank, world):
    """One port rank: its block through every collective of both meshes."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import mesh_ctx
    from repro_torch.sharding.axes import gather_params

    torch.set_num_threads(1)
    x = torch.from_numpy(_global_x()[rank * LOCAL[0]:(rank + 1) * LOCAL[0]])
    out = {}
    for m, (shape, axes) in MESHES.items():
        mesh = make_test_mesh(shape, axes, device="cpu")
        ctx = mesh_ctx(mesh)          # every rank: the groups are world-collective
        if rank >= mesh.size():
            continue
        out[f"{m}|sizes"] = [ctx.size(a) for a in axes] + [ctx.size(tuple(axes))]
        out[f"{m}|data_axes"] = ctx.data_axes
        # ZeRO-3's gather: dim 1 sharded over model, dim 0 over nothing
        got = gather_params(ctx, {"w": x, "v": {"u": x}},
                            {"w": (None, "model", None), "v": {"u": (None,) * 3}}, "model")
        out[f"{m}|gather_params"] = (got["w"].numpy(), got["v"]["u"].numpy())
        for name in NAMES[m]:
            _collectives(ctx, x, name,
                         lambda op, v: out.__setitem__(
                             _key(m, name, op),
                             v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)))
            for op, fn in _ops(ctx, name).items():
                xg = x.clone().requires_grad_()
                y = fn(xg)
                if op == "pmax":
                    out[_key(m, name, "pmax") + "|grad"] = y.requires_grad
                    continue
                c = _cotangent(m, name, op, mesh.size())
                c = torch.from_numpy(c[rank * y.shape[0]:(rank + 1) * y.shape[0]])
                out[_key(m, name, op) + "|grad"] = \
                    torch.autograd.grad((y * c).sum(), xg)[0].numpy()
        if m == "dm":
            xg = x.clone().requires_grad_()
            out["dm|sum_psum_data|grad"] = \
                torch.autograd.grad(ctx.psum(xg, "data").sum(), xg)[0].numpy()
    return out


def _jax_side(out_path):
    """This file as a script: the JAX ``AxisCtx`` under ``shard_map`` on 8
    forced host devices, every device's results stacked in device order."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.launch.mesh import make_test_mesh
    from repro.sharding.axes import AxisCtx
    try:
        from jax.experimental.shard_map import shard_map
    except ImportError:
        from jax.sharding import shard_map

    xg = jnp.asarray(_global_x())
    res = {}
    for m, (shape, axes) in MESHES.items():
        mesh = make_test_mesh(shape, axes)
        n = int(np.prod(shape))
        ctx = AxisCtx(**{a: a for a in axes})
        for name in NAMES[m]:
            def body(x, name=name):
                vals = {}
                _collectives(ctx, x, name, lambda op, v: vals.__setitem__(
                    op, jnp.asarray(v).reshape((1,) + jnp.shape(v))))
                return vals
            f = shard_map(body, mesh=mesh, in_specs=P(tuple(axes)),
                          out_specs=P(tuple(axes)), check_rep=False)
            got = jax.jit(f)(xg[:n * LOCAL[0]])
            for op, v in got.items():
                res[_key(m, name, op)] = np.asarray(v)      # (n, ...) device order
            for op in GRAD_OPS:
                if op == "ppermute" and isinstance(name, tuple):
                    continue

                def grad_body(x, c, op=op, name=name):
                    fn = _ops(ctx, name)[op]        # sizes are read inside the body
                    return jax.grad(lambda x: jnp.sum(fn(x) * c))(x)
                g = shard_map(grad_body, mesh=mesh, in_specs=(P(tuple(axes)), P(tuple(axes))),
                              out_specs=P(tuple(axes)), check_rep=False)
                got = jax.jit(g)(xg[:n * LOCAL[0]], jnp.asarray(_cotangent(m, name, op, n)))
                res[_key(m, name, op) + "|grad"] = np.asarray(got).reshape(n, *LOCAL)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The port's ranks and the JAX devices, each run once."""
    from repro_torch.launch.mesh import spawn

    out = str(tmp_path_factory.mktemp("axes") / "jax.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), out], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = spawn(rank_body, 8, "cpu")
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with np.load(out) as z:
        return ranks, dict(z)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("op", OPS)
def test_every_collective_matches_jax(both, mesh, op):
    ranks, jx = both
    n = int(np.prod(MESHES[mesh][0]))
    checked = 0
    for name in NAMES[mesh]:
        key = _key(mesh, name, op)
        if key not in jx:
            assert op == "ppermute" and isinstance(name, tuple)
            continue
        for r in range(n):
            got, want = ranks[r][key], jx[key][r]
            assert got.shape == want.shape, (key, r)
            if op in ("psum", "pmean", "psum_scatter"):
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=f"{key} {r}")
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{key} {r}")
        checked += 1
    assert checked >= 2


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("op", GRAD_OPS)
def test_every_collective_gradient_matches_jax(both, mesh, op):
    """C9: the gradient through each collective is its JAX transpose's."""
    ranks, jx = both
    n = int(np.prod(MESHES[mesh][0]))
    checked = 0
    for name in NAMES[mesh]:
        key = _key(mesh, name, op) + "|grad"
        if key not in jx:
            assert op == "ppermute" and isinstance(name, tuple)
            continue
        for r in range(n):
            got, want = ranks[r][key], jx[key][r]
            assert got.shape == want.shape == LOCAL, (key, r)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=f"{key} {r}")
        checked += 1
    assert checked >= 2


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_pmax_carries_no_gradient(both, mesh):
    ranks, _ = both
    for r in range(int(np.prod(MESHES[mesh][0]))):
        for name in NAMES[mesh]:
            assert ranks[r][_key(mesh, name, "pmax") + "|grad"] is False


def test_grad_of_sum_psum_is_the_axis_size(both):
    """The re-anchor's probe of C9: d sum(psum(x)) / dx over a 2-rank axis
    is 2 everywhere (JAX's value; the port gave 1.0 before C9's fix)."""
    ranks, _ = both
    for r in range(4):
        np.testing.assert_array_equal(ranks[r]["dm|sum_psum_data|grad"],
                                      np.full(LOCAL, 2.0, np.float32))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sizes_and_data_axes(both, mesh):
    ranks, _ = both
    shape, axes = MESHES[mesh]
    for r in range(int(np.prod(shape))):
        assert ranks[r][f"{mesh}|sizes"] == list(shape) + [int(np.prod(shape))]
        assert ranks[r][f"{mesh}|data_axes"] == tuple(a for a in ("pod", "data") if a in axes)
    assert not any(k.startswith("dm|") for r in range(4, 8) for k in ranks[r])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_gather_params_gathers_the_sharded_dim(both, mesh):
    ranks, jx = both
    x = _global_x()
    for r in range(int(np.prod(MESHES[mesh][0]))):
        w, u = ranks[r][f"{mesh}|gather_params"]
        np.testing.assert_array_equal(w, jx[_key(mesh, "model", "all_gather")][r])
        np.testing.assert_array_equal(u, x[r * LOCAL[0]:(r + 1) * LOCAL[0]])


def test_single_is_the_identity():
    from repro_torch.sharding.axes import SINGLE, AxisCtx, gather_on_spec, gather_params

    x = torch.randn(3, 4)
    assert SINGLE == AxisCtx() and SINGLE.data_axes is None
    assert SINGLE.size(SINGLE.data) == 1 and SINGLE.index(SINGLE.model) == 0
    assert torch.equal(SINGLE.pmax(x, None), x)
    for out in (SINGLE.psum(x, None), SINGLE.pmean(x, ()), SINGLE.all_gather(x, None, 0),
                SINGLE.psum_scatter(x, None, 0), SINGLE.all_to_all(x, None, 0, 1),
                SINGLE.ppermute(x, None, [(0, 0)]), gather_on_spec(SINGLE, x, (None, "model"), None)):
        assert out is x
    tree = {"a": x, "b": {"c": x}}
    assert gather_params(SINGLE, tree, {"a": ("model", None), "b": {"c": ()}}, None) == tree
    with pytest.raises(ValueError, match="DeviceMesh"):
        AxisCtx(data="data")


def test_mesh_config_and_shapes_match_jax():
    from repro.configs import base as jbase
    from repro_torch.configs import base

    for kw in ({}, {"multi_pod": True}, {"lanes": 4}, {"multi_pod": True, "lanes": 2, "pods": 3},
               {"data": 4, "model": 2}):
        mine, theirs = base.MeshConfig(**kw), jbase.MeshConfig(**kw)
        assert (mine.shape, mine.axes, mine.n_chips) == (theirs.shape, theirs.axes, theirs.n_chips)
    assert {k: tuple(v.__dict__.values()) for k, v in base.SHAPES.items()} == \
        {k: tuple(v.__dict__.values()) for k, v in jbase.SHAPES.items()}
    assert base.SUBQUADRATIC == jbase.SUBQUADRATIC
    for arch in jbase.ARCHS:
        assert base.shapes_for(arch) == tuple(jbase.shapes_for(arch))


def test_meshes_refuse_without_enough_ranks():
    from repro_torch.launch import mesh

    with pytest.raises(ValueError, match="wants 256 ranks but only 1 are visible"):
        mesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="wants 512 ranks"):
        mesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="lane_mesh"):
        mesh.lane_mesh(2)
    assert mesh.shard_lanes({"x": torch.ones(4)}, None)["x"].shape == (4,)
    assert mesh.lane_sharding(None) == () and mesh.current_mesh() is None
    with mesh.mesh_context("m") as m:
        assert m == "m" and mesh.current_mesh() == "m"


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    _jax_side(sys.argv[1])
