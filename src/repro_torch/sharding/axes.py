"""Mesh-axis context: collectives that are the identity off the mesh (port
of ``repro/sharding/axes.py``).

Code is written once against an ``AxisCtx``. With ``SINGLE`` (every axis
None) each collective is the identity and the code runs on one device; with
the axes of a ``DeviceMesh`` (``launch/steps.mesh_ctx``) the same code runs
in every rank of the mesh (SPMD, one process per device) and its
collectives are c10d calls on the mesh's process groups: NCCL for a
``cuda`` mesh, ``gloo`` for a ``cpu`` one. A collective that fails raises;
nothing falls back.

- ``psum``/``pmean``: ``all_reduce`` over the axis's group; a tuple of
  axes (``data_axes``, ``(pod, data, model)``) is one group over their
  flattened grid, built once per mesh; ``pmean`` divides by a device
  scalar (``divisor``), so it rounds as the CPU does.
- ``all_gather``, ``psum_scatter`` and ``all_to_all`` are tiled, as the JAX
  package's ``tiled=True`` calls are: shards concatenate along the dim.
- ``ppermute``: ``batch_isend_irecv`` over the group's ranks; a rank that
  receives nothing gets zeros, and a self pair (an axis of size 1) is a copy.
- ``pmax``: ``all_reduce(MAX)``, a stabiliser: its result carries no
  gradient.

Every collective but ``pmax`` is differentiable (a ``torch.autograd.Function``),
its backward the transpose that ``jax.lax`` gives it under ``shard_map``
with ``check_rep=False``: ``psum``'s is ``psum`` (so ``pmean``'s is
``pmean``), ``all_gather``'s is ``psum_scatter`` on the same dim and the
reverse, ``all_to_all``'s swaps split and concat, ``ppermute``'s is the
inverse permutation. A backward is a collective too, so every rank must run
the same backwards in the same order, as every rank runs the same forwards.

Each c10d call, a backward's and ``pmax``'s too, records its kind, its
result's bytes and its group's size in an open ``launch/op_cost.cost_scope``
(the dry run's counter). A permute records the bytes this rank sends, so a
rank at the edge of a permutation sends nothing and ranks can differ.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.launch import op_cost

_FOLLOW_MODEL = "__follow_model__"
_GROUPS: dict = {}       # id(mesh) -> (mesh, {axes tuple: (group, index, size, row)})
_BY_SET: dict = {}       # sorted global ranks -> their process group


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def divisor(n, device) -> torch.Tensor:
    """``n`` as a 0-d f32 tensor on ``device``, to divide by: CUDA turns a
    host-scalar divisor into a multiply by its reciprocal, which rounds
    otherwise than the CPU's (and XLA's) true divide. Made by a fill on the
    device, not copied from the host."""
    return torch.full((), float(n), device=device)


def _mesh_groups(mesh) -> dict:
    """Every axis tuple's group on ``mesh`` as ``(group, index, size,
    row)``: ``row`` the global ranks of this rank's grid line over the
    tuple's axes in row-major order (its ``index`` there), the group one
    per distinct set of ranks (so one for ``(data, model)`` and ``(model,
    data)``; c10d orders a group's ranks ascending, the collectives map
    between the two orders). Built on first use, and collective over the
    whole world: every rank builds every mesh's context in the same order,
    a rank outside the mesh too (its entries are None)."""
    key = id(mesh)
    if key in _GROUPS:
        return _GROUPS[key][1]
    import torch.distributed as dist

    names = tuple(mesh.mesh_dim_names)
    grid = mesh.mesh
    me = dist.get_rank()
    out = {}
    for k in range(1, len(names) + 1):
        for axes in itertools.permutations(names, k):
            dims = [names.index(a) for a in axes]
            rest = [d for d in range(len(names)) if d not in dims]
            rows = grid.permute(*rest, *dims).reshape(
                -1, math.prod(grid.shape[d] for d in dims)).tolist()
            out[axes] = None
            for row in rows:
                if k == 1:            # the mesh's own dim groups
                    if me in row:
                        out[axes] = (mesh.get_group(axes[0]), row.index(me), len(row), row)
                    continue
                members = tuple(sorted(row))
                if members not in _BY_SET:
                    _BY_SET[members] = dist.new_group(ranks=list(members))
                if me in row:
                    out[axes] = (_BY_SET[members], row.index(me), len(row), row)
    _GROUPS[key] = (mesh, out)        # the mesh held, so its id stays its own
    return out


def forget_groups() -> None:
    """Drop every mesh's cached groups: after the world they belong to is
    torn down (``launch/mesh.fake_world`` building another)."""
    _GROUPS.clear()
    _BY_SET.clear()


def _to_row_order(parts: list, row: list) -> list:
    """Parts in c10d's group order (ascending ranks) -> the row's order."""
    order = sorted(row)
    return [parts[order.index(r)] for r in row]


def _to_group_order(parts: list, row: list) -> list:
    """Parts in the row's order -> c10d's group order (ascending ranks)."""
    return [parts[row.index(r)] for r in sorted(row)]


@dataclass(frozen=True)
class AxisCtx:
    """The mesh axes a function runs over, and the mesh itself."""
    data: Optional[str] = None    # FL-client / batch axis
    model: Optional[str] = None   # TP / FSDP / EP axis
    pod: Optional[str] = None     # hierarchical / replica axis
    # vocab-sharding axis for embeddings/logits/loss; defaults to `model`
    vocab: Optional[str] = _FOLLOW_MODEL
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.mesh is None and any((self.data, self.model, self.pod)):
            raise ValueError("an AxisCtx with axes needs their DeviceMesh "
                             "(launch/steps.mesh_ctx builds one)")
        if self.mesh is not None:
            _mesh_groups(self.mesh)

    @property
    def vaxis(self) -> Optional[str]:
        return self.model if self.vocab == _FOLLOW_MODEL else self.vocab

    def _axes(self, name) -> tuple:
        if name is None:
            return ()
        return tuple(name) if isinstance(name, tuple) else (name,)

    def _group(self, name):
        entry = _mesh_groups(self.mesh)[self._axes(name)]
        if entry is None:
            raise ValueError(f"this rank is outside the mesh of axis {name!r}")
        return entry

    # -- axis sizes (1 when absent) -----------------------------------
    def size(self, name) -> int:
        if not self._axes(name):
            return 1
        return self._group(name)[2]

    def index(self, name) -> int:
        if not self._axes(name):
            return 0
        return self._group(name)[1]

    @property
    def grid_axes(self) -> tuple:
        """The whole client grid ``(pod, data, model)``, its absent axes
        dropped; ``()`` off the mesh."""
        return tuple(a for a in (self.pod, self.data, self.model) if a is not None)

    @property
    def data_axes(self):
        """Axes that jointly act as the batch/client grid (data [+ pod])."""
        axes = tuple(a for a in (self.pod, self.data) if a is not None)
        return axes if axes else None

    # -- collectives ---------------------------------------------------
    def all_gather(self, x, name, axis: int):
        if not self._axes(name):
            return x
        return _AllGather.apply(x, self._group(name), axis)

    def psum(self, x, name):
        if not self._axes(name):
            return x
        entry = self._group(name)
        return _tree_map(lambda t: _Psum.apply(t, entry), x)

    def pmean(self, x, name):
        if not self._axes(name):
            return x
        n = self.size(name)
        return _tree_map(lambda t: t / divisor(n, t.device), self.psum(x, name))

    def pmax(self, x, name):
        """The elementwise max over the axis, of ``x.detach()``: a
        stabiliser (the JAX package takes it under ``stop_gradient``)."""
        if not self._axes(name):
            return x.detach()
        return _all_reduce(x.detach(), self._group(name), "max")

    def psum_scatter(self, x, name, axis: int):
        if not self._axes(name):
            return x
        return _PsumScatter.apply(x, self._group(name), axis)

    def all_to_all(self, x, name, split_axis: int, concat_axis: int):
        if not self._axes(name):
            return x
        return _AllToAll.apply(x, self._group(name), split_axis, concat_axis)

    def ppermute(self, x, name, perm):
        if not self._axes(name):
            return x
        return _Ppermute.apply(x, self._group(name), tuple(map(tuple, perm)))


# The c10d calls; ``entry`` is a ``_mesh_groups`` value (group, index, size,
# row). Each records what it moves in an open ``launch/op_cost.cost_scope``:
# its kind, its result's bytes (a permute: the bytes this rank sends) and
# its group's size.

def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _all_reduce(x, entry, op: str = "sum"):
    import torch.distributed as dist
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                    group=entry[0])
    if op_cost.active():
        op_cost.record_collective("all-reduce", _nbytes(out), entry[2])
    return out


def _all_gather(x, entry, axis: int):
    import torch.distributed as dist
    g, _, n, row = entry
    # integers (token ids) start from zeros: a group that moves no bytes (a
    # dry run's fake one) then leaves ids in range, not whatever the memory held
    new = torch.empty_like if x.is_floating_point() else torch.zeros_like
    parts = [new(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=g)
    if op_cost.active():
        op_cost.record_collective("all-gather", n * _nbytes(x), n)
    return torch.cat(_to_row_order(parts, row), dim=axis)


def _reduce_scatter(x, entry, axis: int):
    import torch.distributed as dist
    g, _, n, row = entry
    moved = torch.cat(_to_group_order(list(x.movedim(axis, 0).chunk(n)), row))
    out = moved.new_empty((moved.shape[0] // n, *moved.shape[1:]))
    dist.reduce_scatter_tensor(out, moved, op=dist.ReduceOp.SUM, group=g)
    if op_cost.active():
        op_cost.record_collective("reduce-scatter", _nbytes(out), n)
    return out.movedim(0, axis)


def _all_to_all(x, entry, split_axis: int, concat_axis: int):
    import torch.distributed as dist
    g, _, n, row = entry
    moved = torch.cat(_to_group_order(list(x.movedim(split_axis, 0).chunk(n)), row))
    out = torch.empty_like(moved)
    dist.all_to_all_single(out, moved, group=g)
    if op_cost.active():
        op_cost.record_collective("all-to-all", _nbytes(out), n)
    parts = _to_row_order(list(out.chunk(n)), row)
    return torch.cat([p.movedim(0, split_axis) for p in parts], dim=concat_axis)


def _permute(x, entry, perm):
    import torch.distributed as dist
    g, me, n, row = entry
    out = torch.zeros_like(x)
    x = x.contiguous()
    ops, sends = [], 0
    for src, dst in perm:
        if src == me and dst == me:
            out = x.clone()
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, row[dst], g))
            sends += 1
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, row[src], g))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if op_cost.active():
        op_cost.record_collective("collective-permute", sends * _nbytes(x), n)
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(x, entry):
        return _all_reduce(x, entry)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.entry = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.entry), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(x, entry, axis):
        return _all_gather(x, entry, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.entry, ctx.axis = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.entry, ctx.axis), None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(x, entry, axis):
        return _reduce_scatter(x, entry, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.entry, ctx.axis = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.entry, ctx.axis), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(x, entry, split_axis, concat_axis):
        return _all_to_all(x, entry, split_axis, concat_axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.entry, ctx.split, ctx.concat = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.entry, ctx.concat, ctx.split), None, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(x, entry, perm):
        return _permute(x, entry, perm)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.entry, ctx.perm = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.entry, tuple((d, s) for s, d in ctx.perm)), None, None


# Convenience contexts
SINGLE = AxisCtx()


def gather_on_spec(ctx: AxisCtx, tensor, spec, axis_name):
    """All-gather ``tensor`` along whichever dim ``spec`` (a tuple of axis
    names or None per dim, the port's ``PartitionSpec``) shards over
    ``axis_name``; the tensor whole on that dim."""
    if axis_name is None:
        return tensor
    for dim, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        if axis_name in names:
            return ctx.all_gather(tensor, axis_name, axis=dim)
    return tensor


def gather_params(ctx: AxisCtx, params: dict, specs: dict, axis_name):
    """ZeRO-3 style: all-gather every tensor on its ``axis_name``-sharded
    dim (``params`` and ``specs`` same-keyed dicts, nested or flat)."""
    if isinstance(params, dict):
        return {k: gather_params(ctx, v, specs[k], axis_name) for k, v in params.items()}
    if params is None:
        return None
    return gather_on_spec(ctx, params, specs, axis_name)
