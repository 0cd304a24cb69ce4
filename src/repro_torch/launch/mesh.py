"""Device meshes and the processes behind them (port of
``repro/launch/mesh.py``).

A JAX ``shard_map`` over a mesh becomes SPMD here: one process per device,
each running the per-shard function, its collectives c10d calls on the
process groups of a ``torch.distributed.device_mesh.DeviceMesh``
(``sharding/axes.AxisCtx``). ``spawn`` starts the processes; every mesh
function below runs inside them, after ``torch.distributed`` is set up.

- ``make_test_mesh`` / ``make_production_mesh``: ``("data", "model")`` or
  ``("pod", "data", "model")`` meshes over the first ranks of the world. A
  ``cuda`` mesh needs NCCL behind the process group and raises without it;
  a ``cpu`` mesh runs on ``gloo``.
- ``lane_mesh``: the campaigns' 1-D ``("lanes",)`` mesh. Lanes share
  nothing in a round, so it carries no device collective: its ``gloo``
  group gathers host objects (result rows, eval, checkpoint state) at chunk
  boundaries, and several ranks may share one card.
- ``shard_lanes``: the rank's contiguous block of ``S_pad // n`` lanes of
  every leaf mapped over the sweep axis; unmapped leaves stay whole.
- ``fake_world``: one process as one rank of a world whose other ranks do
  not exist (the fake backend), for the dry run of a production mesh.

Nothing here touches ``torch.distributed`` at import.
"""
from __future__ import annotations

import contextlib
import math
import os
import pathlib
import pickle
import tempfile

import torch
import torch.distributed as dist

_CURRENT = []      # the mesh_context stack


def _visible() -> int:
    """Ranks this process can see: the world, or 1 outside ``spawn``."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_mesh(device: str, shape, axes):
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    if n > _visible():
        raise ValueError(
            f"a {tuple(shape)} mesh wants {n} ranks but only {_visible()} are visible; "
            f"start them with repro_torch.launch.mesh.spawn(fn, {n}, device)")
    config = str(dist.get_backend_config())
    if device == "cuda" and dist.get_backend() != "nccl" and "cuda:nccl" not in config \
            and "cuda:fake" not in config:
        raise RuntimeError(
            "a cuda mesh needs NCCL behind the process group "
            f"(backend {dist.get_backend_config()!r}); start the ranks with "
            "spawn(fn, world, 'cuda')")
    # a dry run's meta tensors take the CPU's groups (fake_world gives them a
    # backend); DeviceMesh itself knows no meta device
    return DeviceMesh("cpu" if device == "meta" else device,
                      torch.arange(n).reshape(tuple(shape)), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The JAX package's production meshes: ``(16, 16)`` ``("data",
    "model")``, or ``(2, 16, 16)`` with a leading ``"pod"`` axis; refuses
    to build with fewer ranks than the shape (``fake_world`` gives one
    process all of them)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(device, shape, axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device: str = "cuda"):
    """A small mesh over the first ``prod(shape)`` ranks."""
    return _device_mesh(device, shape, axes)


def lane_mesh(n=0):
    """The 1-D ``("lanes",)`` mesh of a device-parallel campaign over ``n``
    ranks (``n`` a count or a ``configs.base.MeshConfig``, whose ``lanes``
    axis is the count; 0 takes every visible rank). Its group is ``gloo``:
    it moves host objects only, so ranks sharing one card are fine."""
    n = int(getattr(n, "lanes", n)) or _visible()
    if n > _visible():
        raise ValueError(
            f"lane_mesh({n}) wants {n} devices but only {_visible()} are visible; "
            f"start {n} ranks with repro_torch.launch.mesh.spawn(fn, {n}, device) "
            "(one process per lane shard; several may share one card) and build "
            "the campaign inside them")
    return _device_mesh("cpu", (n,), ("lanes",))


def lane_rank(mesh) -> int:
    """This rank's block index on a lane mesh (0 without one)."""
    return 0 if mesh is None else mesh.get_local_rank("lanes")


def lane_block(mesh, s_pad: int) -> range:
    """The lanes this rank runs: its contiguous block of ``s_pad // n``."""
    if mesh is None:
        return range(s_pad)
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is outside the lane mesh")
    per = s_pad // mesh.size()
    r = lane_rank(mesh)
    return range(r * per, (r + 1) * per)


def lane_sharding(mesh, replicated: bool = False) -> tuple:
    """The spec of a campaign plane on a lane mesh, one entry per leading
    dim as the port writes a ``PartitionSpec``: ``("lanes",)`` for a plane
    split over the lanes, ``()`` for one every rank keeps whole
    (``replicated``: the concatenated data roots, the unique schedules)."""
    return () if replicated or mesh is None else ("lanes",)


def _block(t, mesh):
    n = mesh.size()
    if t.shape[0] % n:
        raise ValueError(f"a lane-mapped leaf of {t.shape[0]} lanes does not split "
                         f"over {n} ranks (pad S first)")
    block = lane_block(mesh, t.shape[0])
    return t[block.start:block.stop]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_lanes(tree, mesh, axes=None):
    """This rank's share of a campaign plane: mapped leaves (every leaf
    without ``axes``; with a dict like ``data/pipeline.DEDUP_STAGED_AXES``,
    the entries that are 0) keep the rank's contiguous block of their
    leading lane dim, unmapped ones (``None``) stay whole. The identity for
    ``mesh=None``."""
    if mesh is None:
        return tree
    if axes is None:
        return _map(lambda t: _block(t, mesh), tree)
    return {k: (v if axes.get(k) is None else _map(lambda t: _block(t, mesh), v))
            for k, v in tree.items()}


def gather_objects(mesh, obj) -> list:
    """Every lane rank's ``obj``, in block order (host objects, ``gloo``)."""
    if mesh is None:
        return [obj]
    out = [None] * mesh.size()
    dist.all_gather_object(out, obj, group=mesh.get_group("lanes"))
    return out


def barrier(mesh) -> None:
    """Wait for every rank of the mesh (a no-op without one)."""
    if mesh is not None:
        dist.barrier(group=mesh.get_group(mesh.mesh_dim_names[0]))


@contextlib.contextmanager
def mesh_context(mesh):
    """The ambient mesh for the block (``current_mesh()``), as
    ``jax.set_mesh`` sets it."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh():
    """The innermost ``mesh_context``'s mesh, or None."""
    return _CURRENT[-1] if _CURRENT else None


# ---------------------------------------------------------------------------
# the processes
# ---------------------------------------------------------------------------

def _rank_main(rank, fn, world, device, backend, store, out_dir, args):
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        result = fn(rank, world, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def fake_world(world: int, rank: int = 0, device: str = "meta") -> None:
    """Make this process rank ``rank`` of a ``world``-rank world whose other
    ranks do not exist (a dry run, ``launch/dryrun.py``): ``torch.
    distributed`` on PyTorch's fake backend for the CPU's, the meta
    device's and, for ``device="cuda"``, the card's tensors. Its
    collectives move no bytes and leave their outputs as they found them.
    A world already up is torn down first (``end_world``), so one process
    can take the 256-rank mesh, then the 512-rank one. The backend comes from
    ``torch.testing._internal.distributed.fake_pg``; a torch without that
    module raises, naming it."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("a dry run needs PyTorch's fake process group, "
                           "torch.testing._internal.distributed.fake_pg, which this "
                           f"torch ({torch.__version__}) lacks") from e
    if device not in ("meta", "cuda"):
        raise ValueError(f"a fake world runs on meta or cuda, not {device}")
    end_world()
    backend = "cpu:fake,meta:fake" + (",cuda:fake" if device == "cuda" else "")
    dist.init_process_group(backend, store=FakeStore(), rank=rank, world_size=world)


def end_world() -> None:
    """Tear down this process's ``torch.distributed`` world, if any, and
    every mesh's cached groups (``sharding/axes.forget_groups``)."""
    from repro_torch.sharding.axes import forget_groups
    if dist.is_initialized():
        dist.destroy_process_group()
    forget_groups()


def default_backend(device: str) -> str:
    """NCCL for a card's tensors (with ``gloo`` beside it for host ones),
    ``gloo`` alone for the CPU."""
    return "cpu:gloo,cuda:nccl" if device == "cuda" else "gloo"


def spawn(fn, world: int, device: str = "cuda", *args, backend=None) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes (the
    ``spawn`` start method: CUDA may be initialised in the parent), each in a
    ``torch.distributed`` process group of the world (a ``file://`` store in
    a temporary directory; ``backend`` defaults to ``default_backend``) and,
    on ``cuda``, on card ``rank % device_count``. Returns every rank's
    return value (pickled), in rank order; raises if a rank fails. ``fn``
    must be importable: a function at module level. On ``cuda`` the parent
    builds every kernel first, so no two ranks run ``nvcc`` on one source."""
    import torch.multiprocessing as mp

    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("spawn(..., 'cuda') needs a CUDA card; pass device='cpu'")
        if backend is None and not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL: a cuda mesh cannot be built")
        from repro_torch.kernels import build
        build.build(build.sources())
    backend = backend or default_backend(device)
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        store = os.path.join(tmp, "store")
        mp.start_processes(_rank_main, nprocs=world, start_method="spawn",
                           args=(fn, world, device, backend, store, tmp, args))
        out = []
        for r in range(world):
            with open(pathlib.Path(tmp) / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
    return out

