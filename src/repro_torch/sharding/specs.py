"""Partition rule tables for every (architecture x phase) (port of
``repro/sharding/specs.py``).

A spec is the port's ``PartitionSpec``: a tuple with one entry per dim,
each None (whole), an axis name or a tuple of names. Phases:

- ``fsdp`` (train / prefill): every block tensor ZeRO-3-sharded over
  ``model`` on one divisible dim; MoE expert tensors EP-resident.
- ``tp`` (decode): column/row tensor-parallel resident weights; tensors
  whose parallel dim does not divide the mesh (MLA attention, xLSTM)
  replicate.
- ``spatial`` (small archs): everything replicated; the flattened (data x
  model) grid is the FL client grid.

The tables are the JAX package's, keyed by parameter leaf name. Built from
them for the temporal placement on a mesh: the per-layer ZeRO-3 gather
(``make_gather_fn``), the gradient sync (``make_grad_sync``), and a rank's
view of the whole model (``TreeShards``: sums that count each element once,
each element's global flat index), through which the strategies, the probes
and the consensus compute the meshless function on a rank's shards.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.treeview import WholeTree
from repro_torch.models import transformer
from repro_torch.sharding.axes import AxisCtx, divisor

# Archs small enough for spatial (per-chip replica) placement.
SPATIAL_ARCHS = ("whisper-base", "xlstm-125m", "flsim-cnn", "flsim-mlp",
                 "flsim-logreg")


def placement_for(cfg: ModelConfig) -> str:
    """"spatial" for the archs of ``SPATIAL_ARCHS``, else "temporal"."""
    name = cfg.name.removesuffix("-reduced")
    return "spatial" if name in SPATIAL_ARCHS else "temporal"


# name -> dim sharded over `model` (per-layer shapes, no stack dim); None:
# replicated
_FSDP_DIM = {
    # attention (GQA)
    "wq": 1, "wk": 1, "wv": 1, "wo": 0, "bq": 0, "bk": 0, "bv": 0,
    "q_norm": 0, "k_norm": 0,
    # MLA
    "wdq": 1, "wuq": 1, "wdkv": 1, "kv_norm": 0, "wukv": 1,
    # MLP
    "w1": 1, "w3": 1, "w2": 0, "b1": 0, "b2": 0,
    # norms
    "w": 0, "b": 0,
    # moe (router gathered; experts resident)
    "router": 1,
    # mamba
    "in_proj_x": 1, "in_proj_z": 1, "conv_w": 1, "conv_b": 0,
    "x_proj": 1, "dt_proj": 1, "dt_bias": 0, "A_log": 0, "D_skip": 0,
    "out_proj": 0,
    # xlstm
    "up_proj": 1, "wif": 0, "o_norm": 0, "down_proj": 0,
    "wx": 1, "rh": 1, "ff1": 1, "ff2": 0,
}

_TP_DIM = {
    # attention: column for qkv, row for wo
    "wq": 1, "wk": 1, "wv": 1, "wo": 0, "bq": 0, "bk": 0, "bv": 0,
    "q_norm": None, "k_norm": None,
    # MLA decode: replicated (absorbed einsums are not head-shardable)
    "wdq": None, "wuq": None, "wdkv": None, "kv_norm": None, "wukv": None,
    # MLP
    "w1": 1, "w3": 1, "w2": 0, "b1": 0, "b2": None,
    "w": None, "b": None,
    "router": None,
    # mamba decode: channels (d_inner) sharded
    "in_proj_x": 1, "in_proj_z": 1, "conv_w": 1, "conv_b": 0,
    "x_proj": 0, "dt_proj": 1, "dt_bias": 0, "A_log": 0, "D_skip": 0,
    "out_proj": 0,
    # xlstm decode: replicated (tiny)
    "up_proj": None, "wif": None, "o_norm": None, "down_proj": None,
    "wx": None, "rh": None, "ff1": None, "ff2": None,
}

# MLA attention weights replicate in tp mode
_TP_MLA_OVERRIDE = {"wo": None, "wq": None, "wk": None, "wv": None}

_BASE_NDIM = {
    "wq": 2, "wk": 2, "wv": 2, "wo": 2, "bq": 1, "bk": 1, "bv": 1,
    "q_norm": 1, "k_norm": 1, "wdq": 2, "wuq": 2, "wdkv": 2,
    "kv_norm": 1, "wukv": 2, "w1": 2, "w3": 2, "w2": 2, "b1": 1, "b2": 1,
    "w": 1, "b": 1, "router": 2, "in_proj_x": 2, "in_proj_z": 2,
    "conv_w": 2, "conv_b": 1, "x_proj": 2, "dt_proj": 2, "dt_bias": 1,
    "A_log": 2, "D_skip": 1, "out_proj": 2, "up_proj": 2, "wif": 2,
    "o_norm": 1, "down_proj": 2, "wx": 2, "rh": 2, "ff1": 2, "ff2": 2,
    "embed": 2, "lm_head": 2,
}


def _moe_expert_spec(cfg: ModelConfig, nstack: int) -> dict:
    """Expert tensors (stack, E, D, F) / (stack, E, F, D): EP-resident."""
    lead = (None,) * nstack
    if cfg.moe.ep_mode == "model":
        w1 = w2 = lead + ("model", None, None)
    elif cfg.moe.ep_mode == "subgrid":
        # packed (E*f_sub, D, F/f_sub) over the flattened grid
        w1 = w2 = lead + (("data", "model"), None, None)
    else:  # grid: E over data, F over model
        w1 = lead + ("data", None, "model")
        w2 = lead + ("data", "model", None)
    return {"w1": w1, "w3": w1, "w2": w2}


def _base_ndim(keys) -> int:
    """ndim of the per-layer tensor (no stack dims) for this leaf."""
    name = keys[-1]
    if "moe" in keys and name in ("w1", "w3", "w2"):
        return 3  # (E, D, F)
    return _BASE_NDIM[name]


def _map_shapes(fn, shapes, keys=()):
    """``fn(keys, shape)`` over the shape tuples of a nested dict."""
    if isinstance(shapes, dict):
        return {k: _map_shapes(fn, v, keys + (k,)) for k, v in shapes.items()}
    return fn(keys, shapes)


def param_specs(cfg: ModelConfig, phase: str) -> dict:
    """A spec tree matching ``transformer.param_shapes(cfg)`` exactly."""
    shapes = transformer.param_shapes(cfg)
    if phase == "spatial":
        return _map_shapes(lambda keys, sh: (), shapes)
    table = dict(_TP_DIM if phase == "tp" else _FSDP_DIM)
    if phase == "tp" and cfg.attn_type == "mla":
        table.update(_TP_MLA_OVERRIDE)

    def assign(keys, shape):
        name, top = keys[-1], keys[0]
        # input embedding D-sharded; tied embeddings stay vocab-sharded
        if name == "embed":
            return ("model", None) if cfg.tie_embeddings else (None, "model")
        if name == "lm_head":
            return (None, "model")
        if top in ("final_norm", "enc_final_norm"):
            return (None,)
        nstack = len(shape) - _base_ndim(keys)
        if "moe" in keys and name in ("w1", "w3", "w2"):
            return _moe_expert_spec(cfg, nstack)[name]
        dim = table.get(name, 0 if len(shape) == 1 else None)
        if dim is None:
            return (None,) * len(shape)
        dim += nstack
        if shape[dim] % 16 != 0:
            # replicate where the mesh cannot divide the dim
            return (None,) * len(shape)
        spec = [None] * len(shape)
        spec[dim] = "model"
        return tuple(spec)

    return _map_shapes(assign, shapes)


def _flat(tree, keys=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, keys + (k,))
    else:
        yield keys, tree


def gather_dim_table(cfg: ModelConfig) -> dict:
    """(parent, name) -> the per-layer gather dim over ``model`` (the spec's
    ``model`` position minus the one stack dim a layer loop consumes), or
    None: never gathered (EP experts, vocab shards, replicated leaves)."""
    table: dict = {}
    for keys, spec in _flat(param_specs(cfg, "fsdp")):
        name = keys[-1]
        parent = keys[-2] if len(keys) >= 2 else ""
        if keys[0] in ("embed", "lm_head", "final_norm", "enc_final_norm"):
            continue
        if "moe" in keys and name in ("w1", "w3", "w2"):
            table[(parent, name)] = None
            continue
        dim = None
        for i, entry in enumerate(spec):
            if entry == "model" or (isinstance(entry, tuple) and "model" in entry):
                dim = i - 1
                break
        prev = table.get((parent, name), "missing")
        assert prev in ("missing", dim), \
            f"gather-dim conflict for {(parent, name)}: {prev} vs {dim}"
        table[(parent, name)] = dim
    return table


def _has(spec, axis) -> bool:
    return any(axis in (e if isinstance(e, tuple) else (e,)) for e in spec if e is not None)


def make_gather_fn(cfg: ModelConfig, ctx, quant: bool = False):
    """The per-layer ZeRO-3 all-gather of the layer loops: a function of
    one entry's param subtree (a decoder layer, an encoder block, a hybrid
    period) that all-gathers every leaf of ``gather_dim_table`` over
    ``model`` on its dim, the rest as they are. The identity without a
    model axis and for spatial archs. Differentiable: a gathered leaf's
    gradient is the ``psum_scatter`` of the ranks' gradients.

    ``quant`` (the JAX package's ``REPRO_QUANT_GATHER=1``): a bf16 leaf of
    at least 2**16 values crosses as symmetric int8, one f32 scale per
    line along the gathered dim (``amax / 127``, 1 where the line is
    zero), and is dequantized after: shard j of the gather by scale slice
    j, as there. The scale is ``amax`` times the f32 reciprocal of 127,
    which is how XLA computes the JAX package's ``amax / 127.0``."""
    if ctx.model is None or placement_for(cfg) == "spatial":
        return lambda blk: blk
    table = gather_dim_table(cfg)

    def ag(t, d):
        if quant and t.numel() >= 1 << 16 and t.dtype == torch.bfloat16:
            tf = t.to(torch.float32)
            amax = tf.abs().amax(dim=d, keepdim=True)
            scale = torch.where(amax > 0, amax * (1.0 / 127.0), torch.ones_like(amax))
            q = torch.clamp(torch.round(tf / scale), -127, 127).to(torch.int8)
            qg = ctx.all_gather(q, ctx.model, axis=d)
            sg = ctx.all_gather(scale, ctx.model, axis=d)
            m = sg.shape[d]
            qm, sm = qg.movedim(d, -1), sg.movedim(d, -1)
            out = (qm.reshape(*qm.shape[:-1], m, qm.shape[-1] // m).to(torch.float32)
                   * sm[..., None]).reshape(qm.shape)
            return out.movedim(-1, d).to(t.dtype)
        return ctx.all_gather(t, ctx.model, axis=d)

    def gather(blk, parent=""):
        out = {}
        for name, t in blk.items():
            if isinstance(t, dict):
                out[name] = gather(t, name)
                continue
            d = table.get((parent, name))
            out[name] = t if d is None else ag(t, d)
        return out

    return gather


def grad_sync_axes(cfg: ModelConfig, ctx) -> dict:
    """flat param key -> (the axes its gradient is averaged over, the axes
    it is summed over) on the temporal placement's mesh.

    Averaged over ``(pod, data)`` where the leaf is not sharded over them
    (the JAX package's ``make_grad_sync``: each batch shard's mean-loss
    gradient, averaged). Summed over ``model`` where the leaf is not
    sharded over it (``final_norm``; a leaf replicated because the mesh
    cannot divide it): each model rank runs such a leaf on its own rows
    only, so its gradient there is one rank's share of the sum (a gathered
    leaf's comes whole, from the gather's ``psum_scatter``). The JAX
    package sums nothing over ``model`` there (part of ROADMAP C10)."""
    out = {}
    for key, spec in transformer.flatten_params(param_specs(cfg, "fsdp")).items():
        mean = tuple(a for a in (ctx.pod, ctx.data) if a is not None and not _has(spec, a))
        total = (ctx.model,) if ctx.model is not None and not _has(spec, "model") else ()
        out[key] = (mean, total)
    return out


def grad_split_axes(cfg: ModelConfig, ctx) -> dict:
    """flat param key -> the batch axes ``(pod, data)`` the leaf is
    sharded over (grid- and subgrid-EP experts: ``data``). Such a leaf's
    gradient already sums every batch shard's loss gradient (its tokens
    came from every data row through the all-to-all, each with its row's
    whole cotangent), so the sync divides it by their size, the mean the
    other leaves take by ``pmean``. The JAX package's ``make_grad_sync``
    leaves it the sum (ROADMAP C11)."""
    return {key: tuple(a for a in (ctx.pod, ctx.data) if a is not None and _has(spec, a))
            for key, spec in transformer.flatten_params(param_specs(cfg, "fsdp")).items()}


def make_grad_sync(cfg: ModelConfig, ctx):
    """The temporal round's gradient sync over a flat gradient dict (its
    leaves may carry a leading client dim): ``grad_sync_axes``'s mean and
    sum per leaf, and ``grad_split_axes``'s division. The identity off the
    mesh."""
    if ctx.pod is None and ctx.data is None and ctx.model is None:
        return lambda g: g
    axes = grad_sync_axes(cfg, ctx)
    split = grad_split_axes(cfg, ctx)

    def sync(grads):
        out = {}
        for key, g in grads.items():
            mean, total = axes[key]
            if total:
                g = ctx.psum(g, total[0])
            if split[key]:
                g = g / divisor(ctx.size(split[key]), g.device)
            out[key] = ctx.pmean(g, mean) if mean else g
        return out

    return sync


def batch_specs(cfg: ModelConfig, shape_kind: str, global_batch: int, mesh_axes) -> tuple:
    """The spec of the leading batch dim: over (pod, data) where they
    divide it; a spatial arch's train batch over the (data, model) client
    grid. ``mesh_axes``: (name, size) pairs."""
    axes, n = [], 1
    sizes = dict(mesh_axes)
    if placement_for(cfg) == "spatial" and shape_kind == "train":
        want = ["data", "model"]
    else:
        want = ["pod", "data"]
    for a in want:
        if a in sizes and global_batch % (n * sizes[a]) == 0:
            axes.append(a)
            n *= sizes[a]
    if not axes:
        return (None,)
    return (axes[0] if len(axes) == 1 else tuple(axes),)   # a 1-tuple is its name


def _entry_axes(entry) -> tuple:
    """A spec entry's axis names: () for None."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class TreeShards(WholeTree):
    """This rank's view (``core/treeview``) of a flat param tree
    (``transformer.flatten_params`` keys) laid out by ``param_specs(cfg,
    "fsdp")`` on ``ctx`` (spec entries naming an axis the mesh lacks are
    whole), as the temporal placement holds its params, server state and
    every delta.

    - ``total`` / ``sq_norm``: a sum over the whole model, each element
      counted once: a leaf's partial sum ``psum``med over the axes its spec
      shards it on only (a leaf replicated over an axis is counted once,
      not once a rank). The same value on every rank.
    - ``flat_index``: the global row-major index, in its leaf, of each of
      the rank's elements (counter-based draws at these counters are the
      meshless draws).
    - ``loss_term``: a term every rank adds to its loss whole, its gradient
      scaled by 1 / the model axis's size: ``make_grad_sync`` sums a leaf's
      gradient over ``model`` (where the spec leaves it whole) or takes it
      whole from the gather's ``psum_scatter``, so this makes the term's
      gradient the meshless one."""

    def __init__(self, cfg: ModelConfig, ctx: AxisCtx):
        present = {a for a in (ctx.pod, ctx.data, ctx.model) if a is not None}
        self.ctx = ctx
        self.shapes = {k: tuple(s) for k, s in
                       transformer.flatten_params(transformer.param_shapes(cfg)).items()}
        self.specs = {}
        for k, spec in transformer.flatten_params(param_specs(cfg, "fsdp")).items():
            keep = [e if e is not None and set(_entry_axes(e)) <= present else None
                    for e in spec]
            self.specs[k] = tuple(keep) + (None,) * (len(self.shapes[k]) - len(keep))
        self.axes = {k: tuple(a for e in spec for a in _entry_axes(e))
                     for k, spec in self.specs.items()}
        self.local_shapes = {k: tuple(g // ctx.size(e) if e is not None else g
                                      for g, e in zip(self.shapes[k], self.specs[k]))
                             for k in self.shapes}

    def total(self, parts: dict):
        """Each leaf's partial sum ``psum``med over the axes the leaf is
        sharded on (one ``psum`` per distinct set of axes), then summed as
        off the mesh. Differentiable (the ``psum``'s backward)."""
        groups: dict = {}
        for k in sorted(parts):
            groups.setdefault(self.axes[k], []).append(k)
        summed = {}
        for axes, keys in groups.items():
            stacked = torch.stack([parts[k] for k in keys])
            if axes:
                stacked = self.ctx.psum(stacked, axes if len(axes) > 1 else axes[0])
            summed.update(zip(keys, stacked.unbind(0)))
        return super().total(summed)

    def flat_index(self, key: str, device, lo: int, hi: int):
        """The global flat indices of the rank's elements (a rank's block
        keeps the leaf's row-major order)."""
        local = self.local_shapes[key]
        pos = torch.arange(lo, hi, dtype=torch.int64, device=device)
        out = torch.zeros_like(pos)
        stride = 1
        for d in range(len(local) - 1, -1, -1):
            e = self.specs[key][d]
            start = self.ctx.index(e) * local[d] if e is not None else 0
            out += (pos % local[d] + start) * stride
            pos = pos // local[d]
            stride *= self.shapes[key][d]
        return out

    def whole_shape(self, key: str, shape) -> tuple:
        return self.shapes[key]

    def loss_term(self, x):
        """``x`` (the same on every rank), its gradient scaled by 1 / the
        model axis's size (see the class docstring)."""
        m = self.ctx.size(self.ctx.model)
        return x if m == 1 else transformer._ScaleGrad.apply(x, 1.0 / m)
