"""Step builders on a device mesh (port of ``repro/launch/steps.py``).

A JAX step is one ``shard_map`` program over global arrays; here it is the
per-rank function of an SPMD program (``launch/mesh.spawn``), over the
rank's shards. There is no ``ShapeDtypeStruct``: a ``BuiltStep`` carries the
per-rank function and its inputs' global shapes, dtypes and specs
(``InputSpec``), and ``materialize`` builds each rank's shards from one
numpy draw of the global arrays.

Built here: the spatial train step (``make_train_step`` for a spatial
arch, ``sharding/specs.SPATIAL_ARCHS``): each point of the ``(data,
model)`` grid holds ``n_clients = data x model`` clients' share of the
batch, lead ``(n_clients, 1, B // n_clients)``, params and server state
replicated, the round ``core/rounds.build_spatial_round`` bound to the
mesh. With one client a rank, an LM client takes ``local_train``'s
rematerialized autograd path. The temporal step (ZeRO-3 and sequence
sharding, ROADMAP A16.2) and the serve steps (A16.2, A16.3) raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import FLConfig, ModelConfig, ShapeConfig
from repro_torch.core.rounds import build_spatial_round
from repro_torch.core.strategies import get_strategy
from repro_torch.models import model_zoo
from repro_torch.models.transformer import FlatModel, flatten_params, param_shapes
from repro_torch.sharding import specs as sspecs
from repro_torch.sharding.axes import AxisCtx


def mesh_ctx(mesh) -> AxisCtx:
    """The ``AxisCtx`` of a mesh's ``data``/``model``/``pod`` axes."""
    names = tuple(mesh.mesh_dim_names)
    return AxisCtx(data="data" if "data" in names else None,
                   model="model" if "model" in names else None,
                   pod="pod" if "pod" in names else None, mesh=mesh)


def _axis_sizes(mesh):
    return list(zip(mesh.mesh_dim_names, mesh.shape))


class InputSpec(NamedTuple):
    """A step input's global shape, dtype and spec (one entry per dim:
    None, an axis name or a tuple of names)."""
    shape: tuple
    dtype: torch.dtype
    spec: tuple = ()


def _is_spec(x) -> bool:
    return isinstance(x, InputSpec)


def _map(fn, tree):
    if _is_spec(tree) or not isinstance(tree, (dict, tuple, list)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    return type(tree)(_map(fn, v) for v in tree)


def _map2(fn, a, b):
    if _is_spec(a):
        return fn(a, b)
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in sorted(a)}
    return type(a)(_map2(fn, x, y) for x, y in zip(a, b))


@dataclasses.dataclass(frozen=True)
class BuiltStep:
    """``fn(*inputs)`` on this rank's shards; ``inputs``: the global
    ``InputSpec`` trees, in ``fn``'s argument order."""
    fn: Any
    inputs: tuple
    kind: str
    ctx: AxisCtx

    def global_arrays(self, seed: int = 0) -> tuple:
        """``global_arrays(self.inputs, seed)``."""
        return global_arrays(self.inputs, seed)

    def shard(self, arrays, device) -> tuple:
        """This rank's shards of the global ``arrays`` (a tree like
        ``inputs``), on ``device``: each dim with an axis entry cut to the
        rank's block along it."""
        ctx = self.ctx

        def cut(sp, a):
            t = torch.as_tensor(a).to(sp.dtype)
            for dim, entry in enumerate(sp.spec):
                if entry is None:
                    continue
                n, i = ctx.size(entry), ctx.index(entry)
                per = t.shape[dim] // n
                t = t.narrow(dim, i * per, per)
            return t.contiguous().to(device)
        return _map2(cut, self.inputs, arrays)

    def materialize(self, seed: int = 0, device="cuda") -> tuple:
        """This rank's shards of ``global_arrays(seed)``."""
        return self.shard(self.global_arrays(seed), device)


def global_arrays(inputs, seed: int = 0):
    """One numpy draw of every global input of an ``InputSpec`` tree, leaf
    by leaf in flatten order (dict keys sorted), as CPU tensors: integers
    in [0, 2), floats N(0, 0.02²) in the input's dtype (bf16: the f32 draw
    rounded)."""
    rng = np.random.RandomState(seed)

    def draw(sp):
        if not sp.dtype.is_floating_point:
            return torch.from_numpy(rng.randint(0, 2, size=sp.shape).astype(np.int64))
        return torch.from_numpy((rng.randn(*sp.shape) * 0.02).astype(np.float32)).to(sp.dtype)
    return _map(draw, inputs)


def _server_specs(strategy, shapes: dict, dtype) -> Any:
    """The server state's ``InputSpec`` tree (replicated), from the
    strategy's init over meta tensors shaped like the params."""
    meta = {k: torch.empty(s, dtype=dtype, device="meta") for k, s in shapes.items()}

    def spec(t):
        return InputSpec(tuple(t.shape), t.dtype, ()) if isinstance(t, torch.Tensor) else t
    return _map(spec, strategy.server_state_init(meta))


def make_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    fl: Optional[FLConfig] = None, dtype=torch.bfloat16) -> BuiltStep:
    """The spatial FL train step of ``cfg`` on ``mesh`` (one round with
    one local step per client). ``dtype``: the params' and frames'."""
    fl = fl or FLConfig(strategy="fedavg", local_epochs=1, client_lr=1e-2)
    if sspecs.placement_for(cfg) != "spatial":
        raise ValueError(
            f"{cfg.name} trains in the temporal placement (ZeRO-3 and sequence "
            "sharding over the mesh), which comes with ROADMAP A16.2")
    model = FlatModel(model_zoo.build(cfg))
    strategy = get_strategy(fl)
    ctx = mesh_ctx(mesh)
    round_fn = build_spatial_round(model, strategy, fl, ctx=ctx)

    def fn(state, batch, weights, rng):
        return round_fn(state, batch, weights, int(rng))

    inputs = train_inputs(cfg, shape, dict(_axis_sizes(mesh)), strategy, dtype)
    return BuiltStep(fn, inputs, "train", ctx)


def train_inputs(cfg: ModelConfig, shape: ShapeConfig, sizes: dict, strategy,
                 dtype=torch.bfloat16) -> tuple:
    """The spatial train step's ``(state, batch, weights, rng)``
    ``InputSpec`` trees on a mesh of axis ``sizes``: the batch and weights
    over the ``(data, model)`` client grid, the rest replicated."""
    n_clients = sizes.get("data", 1) * sizes.get("model", 1)
    B, S = shape.global_batch, shape.seq_len
    lead = (n_clients, 1, max(B // n_clients, 1))
    cspec = ("data", "model")

    def client_sharded(shp, dt):
        return InputSpec(lead + shp, dt, (cspec,) + (None,) * (len(lead) + len(shp) - 1))
    if cfg.family == "encdec":
        S_dec = S // cfg.dec_len_ratio
        batch = {"frames": client_sharded((S, cfg.d_model), dtype),
                 "tokens": client_sharded((S_dec,), torch.int64),
                 "labels": client_sharded((S_dec,), torch.int64)}
    else:
        batch = {"tokens": client_sharded((S,), torch.int64),
                 "labels": client_sharded((S,), torch.int64)}
    shapes = flatten_params(param_shapes(cfg))
    params = {k: InputSpec(tuple(s), dtype, ()) for k, s in shapes.items()}
    state = {"params": params, "server": _server_specs(strategy, shapes, dtype),
             "clients": ()}
    weights = InputSpec((n_clients,), torch.float32, (cspec,))
    rng = InputSpec((), torch.int64, ())
    return state, batch, weights, rng


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh) -> BuiltStep:
    """The prefill step on a mesh: ROADMAP A16.2 (sequence-sharded
    attention, ZeRO-3 gathers), A16.3 for the sharded MLA, MoE, Mamba and
    cross-attention halves."""
    raise ValueError("the prefill step on a device mesh comes with ROADMAP A16.2 "
                     "(and A16.3 for MLA, MoE, Mamba and the encdec cross decode)")


def make_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh) -> BuiltStep:
    """The decode step on a mesh: ROADMAP A16.2 / A16.3."""
    raise ValueError("the decode step on a device mesh comes with ROADMAP A16.2 "
                     "(and A16.3 for MLA, MoE, Mamba and the encdec cross decode)")

