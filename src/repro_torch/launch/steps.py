"""Step builders on a device mesh (port of ``repro/launch/steps.py``).

A JAX step is one ``shard_map`` program over global arrays; here it is the
per-rank function of an SPMD program (``launch/mesh.spawn``), over the
rank's shards. There is no ``ShapeDtypeStruct``: a ``BuiltStep`` carries the
per-rank function and its inputs' global shapes, dtypes and specs
(``InputSpec``), and ``materialize`` builds each rank's shards from one
numpy draw of the global arrays (``empty``: straight on the device, as a
dry run of a production mesh needs, ``launch/dryrun.py``).

- The spatial train step (``make_train_step`` for a spatial arch,
  ``sharding/specs.SPATIAL_ARCHS``): each point of the ``(data, model)``
  grid holds ``n_clients = data x model`` clients' share of the batch,
  lead ``(n_clients, 1, B // n_clients)``, params and server state
  replicated, the round ``core/rounds.build_spatial_round`` bound to the
  mesh.
- The temporal train step (the other archs): one client of the whole
  mesh, lead ``(1, 1)``; params (and server state shaped like them)
  ZeRO-3-sharded over ``model`` (``fsdp``), the batch over ``(pod,
  data)`` and the sequence over ``model`` (``layout="dp2d"``: the batch
  over ``model`` too, whole sequences); ``core/rounds.build_temporal_round``
  bound to the mesh.
- ``make_prefill_step``: ``fsdp`` params gathered per layer (a spatial
  arch's replicated), the caches out in ``cache_tree``'s layout, the last
  position's logits over the whole vocab.
- ``make_decode_step``: tensor-parallel (``tp``) params (a spatial arch's
  replicated), the caches ``cache_tree``'s, the logits ``(B, V_loc)`` of
  the rank's vocab slice (``Model.greedy_token(..., ctx=)`` takes the
  global argmax).

Every family runs there: the dense and MoE decoders (GQA or MLA, their
expert leaves resident, each rank's shard materialized from the global draw
like any other leaf), jamba (hybrid: its training batch over ``(data,
model, pod)``, its prefill sequence-sharded, its decode tensor-parallel),
and the spatial whisper-base and xlstm-125m. A subgrid-EP arch on a mesh
whose ``E / data * f_sub`` is not ``model`` raises (``moe.check_mesh``), and
so does an input whose sharded dim an axis does not divide (whisper's
decoder length ``S // 8`` over ``model``, say).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import FLConfig, ModelConfig, ShapeConfig, get_config
from repro_torch.core.rounds import build_spatial_round, build_temporal_round
from repro_torch.core.strategies import get_strategy
from repro_torch.models import model_zoo
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import KVCache, LatentCache
from repro_torch.models.ssm import MambaState, MLSTMState, SLSTMState, mamba_dims, xlstm_dims
from repro_torch.models.transformer import (EncDecCaches, FlatModel, flatten_params,
                                            n_stacks, pad_caches, param_shapes,
                                            seq_sharded_in, unflatten_params)
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


def _batch_axes(sizes: dict, global_batch: int, order=("pod", "data")) -> tuple:
    """The axes of ``sizes`` (name -> size) in ``order`` that the leading
    batch dim shards over, each taken while it divides the batch."""
    axes, n = [], 1
    for a in order:
        if a in sizes and global_batch % (n * sizes[a]) == 0:
            axes.append(a)
            n *= sizes[a]
    return tuple(axes)


def _entry(axes: tuple):
    """A spec entry for ``axes``: None, the name, or the tuple."""
    return None if not axes else axes[0] if len(axes) == 1 else axes


class InputSpec(NamedTuple):
    """A step input's global shape, dtype and spec (one entry per dim:
    None, an axis name or a tuple of names); ``host``: it lives on the CPU
    whatever the step's device (the train step's rng key, read as a Python
    int)."""
    shape: tuple
    dtype: torch.dtype
    spec: tuple = ()
    host: bool = False


def _is_spec(x) -> bool:
    return isinstance(x, InputSpec)


def _rebuild(tree, parts):
    """A tuple, list or NamedTuple like ``tree`` holding ``parts``."""
    parts = list(parts)
    return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(parts)


def _map(fn, tree):
    if _is_spec(tree) or not isinstance(tree, (dict, tuple, list)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    return _rebuild(tree, (_map(fn, v) for v in tree))


def _leaves(tree):
    """The ``InputSpec``s of a tree, in ``_map``'s order."""
    if _is_spec(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


def check_divisible(inputs, sizes: dict, what: str) -> None:
    """Raise a ``ValueError`` naming the sizes where an axis (or the
    product of a tuple of axes) of a mesh of axis ``sizes`` does not divide
    the dim an ``InputSpec`` of ``inputs`` shards over it (a JAX
    ``shard_map`` fails there too)."""
    for sp in _leaves(inputs):
        for dim, entry in enumerate(sp.spec):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            n = int(np.prod([sizes[a] for a in names]))
            if sp.shape[dim] % n:
                raise ValueError(f"{what}: dim {dim} of an input of shape {sp.shape} has "
                                 f"{sp.shape[dim]} rows, which {entry!r} (size {n}) does "
                                 "not divide")


def _map2(fn, a, b):
    if _is_spec(a):
        return fn(a, b)
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in sorted(a)}
    return _rebuild(a, (_map2(fn, x, y) for x, y in zip(a, b)))


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
            return t.contiguous().to("cpu" if sp.host else device)
        return _map2(cut, self.inputs, arrays)

    def materialize(self, seed: int = 0, device="cuda") -> tuple:
        """This rank's shards of ``global_arrays(seed)``."""
        return self.shard(self.global_arrays(seed), device)

    def local_shape(self, sp: InputSpec) -> tuple:
        """The shape of this rank's shard of input ``sp``."""
        return tuple(d // self.ctx.size(e) if e is not None else d
                     for d, e in zip(sp.shape, sp.spec + (None,) * len(sp.shape)))

    def empty(self, device, seed: int = 0) -> tuple:
        """This rank's shards built straight on ``device`` from the
        ``InputSpec``s, with no global draw (yi-34b's would be 34 B values):
        floats N(0, 0.02²) drawn on the device from ``seed``, integers zero
        (token ids in range), nothing drawn on the meta device. Not the
        shards of ``materialize``: the rank draws its own."""
        gen = None if torch.device(device).type == "meta" else \
            torch.Generator(device=device).manual_seed(seed)

        def make(sp):
            dev = "cpu" if sp.host else device
            if not sp.dtype.is_floating_point:
                return torch.zeros(self.local_shape(sp), dtype=sp.dtype, device=dev)
            t = torch.empty(self.local_shape(sp), dtype=sp.dtype, device=dev)
            return t if gen is None else t.normal_(0.0, 0.02, generator=gen)
        return _map(make, self.inputs)


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


def _server_specs(strategy, shapes: dict, dtype, specs: Optional[dict] = None) -> Any:
    """The server state's ``InputSpec`` tree, from the strategy's init over
    meta tensors shaped like the (flat) params: a leaf under a param's key
    and of its shape sharded as ``specs`` shards that param, every other
    leaf (and every leaf without ``specs``) replicated."""
    meta = {k: torch.empty(s, dtype=dtype, device="meta") for k, s in shapes.items()}

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if not isinstance(t, torch.Tensor):
            return t
        sp = ()
        if specs is not None and key in specs and tuple(t.shape) == tuple(shapes[key]):
            sp = specs[key]
        return InputSpec(tuple(t.shape), t.dtype, sp)
    return walk(strategy.server_state_init(meta))


def make_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    fl: Optional[FLConfig] = None, dtype=torch.bfloat16,
                    layout: str = "sp", quant_ring: bool = False) -> BuiltStep:
    """The FL train step of ``cfg`` on ``mesh`` (one round with one local
    step per client): the spatial round for a spatial arch, else the
    temporal one (``layout``: its training layout, ``"sp"`` or ``"dp2d"``,
    ``transformer.seq_sharded_in``; ``quant_ring``: ``Model.quant_ring``).
    ``dtype``: the params' and frames'. ``fn``'s ``rng`` is a Python int or
    a host tensor, never read from a device."""
    fl = fl or FLConfig(strategy="fedavg", local_epochs=1, client_lr=1e-2)
    strategy = get_strategy(fl)
    ctx = mesh_ctx(mesh)
    sizes = dict(_axis_sizes(mesh))
    if sspecs.placement_for(cfg) == "spatial":
        model = FlatModel(model_zoo.build(cfg))
        round_fn = build_spatial_round(model, strategy, fl, ctx=ctx)
        inputs = train_inputs(cfg, shape, sizes, strategy, dtype)
    else:
        moe_mod.check_mesh(cfg, sizes)
        model = FlatModel(dataclasses.replace(model_zoo.build(cfg), layout=layout,
                                              quant_ring=quant_ring))
        round_fn = build_temporal_round(model, strategy, fl, ctx=ctx)
        inputs = temporal_train_inputs(cfg, shape, sizes, strategy, dtype, layout)
    check_divisible(inputs, sizes, f"{cfg.name}'s train step")

    def fn(state, batch, weights, rng):
        return round_fn(state, batch, weights, int(rng))

    return BuiltStep(fn, inputs, "train", ctx)


def temporal_train_inputs(cfg: ModelConfig, shape: ShapeConfig, sizes: dict, strategy,
                          dtype=torch.bfloat16, layout: str = "sp") -> tuple:
    """The temporal train step's ``(state, batch, weights, rng)``
    ``InputSpec`` trees on a mesh of axis ``sizes``: params ``fsdp``
    (``param_structs``) and server state shaped like them sharded as they
    are, the batch ``batch_struct`` with lead ``(1, 1)``, one client
    weight and the key replicated (the key on the host: the step reads it
    as a Python int)."""
    params = param_structs(cfg, sizes, "fsdp", dtype)
    shapes = {k: sp.shape for k, sp in params.items()}
    specs = {k: sp.spec for k, sp in params.items()}
    state = {"params": params, "server": _server_specs(strategy, shapes, dtype, specs),
             "clients": ()}
    batch = batch_struct(cfg, shape, sizes, lead=(1, 1), layout=layout, dtype=dtype)
    return (state, batch, InputSpec((1,), torch.float32, (None,)),
            InputSpec((), torch.int64, (), host=True))


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
    rng = InputSpec((), torch.int64, (), host=True)
    return state, batch, weights, rng


def batch_struct(cfg: ModelConfig, shape: ShapeConfig, sizes: dict, lead: tuple = (),
                 layout: str = "sp", dtype=torch.bfloat16) -> dict:
    """The token and label (and, for encdec, frame, in ``dtype``)
    ``InputSpec``s of one step on a mesh of axis ``sizes``, ``lead`` dims
    prepended whole. The batch dim over ``(pod, data)`` where they divide
    it; the sequence over ``model`` where ``transformer.seq_sharded_in``
    says so, else (training without it, but for ssm) the batch over
    ``(data, model, pod)``."""
    B, S = shape.global_batch, shape.seq_len
    sharded_seq = seq_sharded_in(cfg, shape.kind, layout)
    order = (("data", "model", "pod") if shape.kind == "train" and not sharded_seq
             and cfg.family != "ssm" else ("pod", "data"))
    baxes = _batch_axes(sizes, B, order)
    seq = "model" if sharded_seq and "model" in sizes and "model" not in baxes else None
    pad = (None,) * len(lead)

    def tok(shp, spec, dt=torch.int64):
        return InputSpec(lead + shp, dt, pad + spec)
    if cfg.family == "encdec":
        S_dec = S // cfg.dec_len_ratio
        return {"frames": tok((B, S, cfg.d_model), (_entry(baxes), seq, None), dtype),
                "tokens": tok((B, S_dec), (_entry(baxes), seq)),
                "labels": tok((B, S_dec), (_entry(baxes), seq))}
    return {"tokens": tok((B, S), (_entry(baxes), seq)),
            "labels": tok((B, S), (_entry(baxes), seq))}


def param_structs(cfg: ModelConfig, sizes: dict, phase: str, dtype=torch.bfloat16) -> dict:
    """The flat params' ``InputSpec``s (``transformer.flatten_params``
    keys) with ``sharding/specs.param_specs(cfg, phase)``, on a mesh of
    axis ``sizes`` (an axis it lacks leaves its dims whole)."""
    shapes = flatten_params(param_shapes(cfg))
    specs = flatten_params(sspecs.param_specs(cfg, phase))

    def keep(entry):
        names = entry if isinstance(entry, tuple) else (entry,)
        return entry if entry is not None and all(n in sizes for n in names) else None
    return {k: InputSpec(tuple(shapes[k]), dtype, tuple(keep(e) for e in specs[k]))
            for k in shapes}


def cache_tree(cfg: ModelConfig, shape: ShapeConfig, sizes: dict,
               dtype=torch.bfloat16):
    """The decode cache's ``InputSpec`` tree at context length
    ``shape.seq_len`` (the JAX package's ``cache_tree``, which reads the
    tree off the prefill), stacked over the entries (layers, or periods):

    - dense and MoE: a KVCache, (L, B, S, KV, HD) each, or for MLA a
      LatentCache;
    - hybrid: ``{"attn": KVCache, "mamba": [MambaState] * (period - 1)}``,
      ``h`` (L, B, d_inner, N) f32 and ``conv`` (L, B, d_conv - 1,
      d_inner);
    - ssm: ``{"mlstm": [MLSTMState] * (slstm_every - 1), "slstm":
      SLSTMState}``, f32;
    - encdec: ``EncDecCaches``, the self KVCache at the decoder's length
      ``S // dec_len_ratio`` and the cross K/V at the encoder's ``S``.

    The batch over ``(pod, data)``; KV and latent rows over ``model`` on
    the sequence dim; a Mamba state's channels over ``model`` in a
    temporal (tensor-parallel) decode where ``d_inner`` divides by 16, as
    its weights are (the JAX package's rule); the xLSTM states replicated
    over it. The cross K/V are sequence-sharded too, the layout the decode's
    combine over ``model`` reads (the JAX package's ``cache_tree``
    replicates them while its prefill returns each rank's slice: ROADMAP
    C12)."""
    L, B, S = n_stacks(cfg), shape.global_batch, shape.seq_len
    batch = _entry(_batch_axes(sizes, B))
    seq = "model" if "model" in sizes else None
    f32 = torch.float32

    def leaf(shp, spec, dt=dtype):
        return InputSpec((L, B) + shp, dt, (None, batch) + spec)

    def kv(s_len):
        if cfg.attn_type == "mla":
            return LatentCache(ckv=leaf((s_len, cfg.mla.kv_lora_rank), (seq, None)),
                               krope=leaf((s_len, cfg.mla.qk_rope_head_dim), (seq, None)))
        rest = (cfg.n_kv_heads, cfg.resolved_head_dim)
        return KVCache(k=leaf((s_len,) + rest, (seq, None, None)),
                       v=leaf((s_len,) + rest, (seq, None, None)))
    if cfg.family == "encdec":
        cross = leaf((S, cfg.n_kv_heads, cfg.resolved_head_dim), (seq, None, None))
        return EncDecCaches(kv(S // cfg.dec_len_ratio), cross, cross)
    if cfg.family == "ssm":
        _, H, dh = xlstm_dims(cfg)
        D = cfg.d_model
        mlstm = MLSTMState(C=leaf((H, dh, dh), (None,) * 3, f32),
                           n=leaf((H, dh), (None, None), f32), m=leaf((H,), (None,), f32))
        return {"mlstm": [mlstm] * (cfg.ssm.slstm_every - 1),
                "slstm": SLSTMState(*[leaf((D,), (None,), f32)] * 4)}
    if cfg.family != "hybrid":
        return kv(S)
    d_inner, _, N, d_conv = mamba_dims(cfg)
    ch = None
    if sspecs.placement_for(cfg) == "temporal" and d_inner % 16 == 0 and seq is not None:
        if d_inner % sizes["model"]:
            raise ValueError(f"{cfg.name}: its Mamba weights shard d_inner {d_inner} over "
                             f"model, whose {sizes['model']} ranks do not divide it, so the "
                             "decode state cannot shard with them")
        ch = "model"
    state = MambaState(h=leaf((d_inner, N), (ch, None), f32),
                       conv=leaf((d_conv - 1, d_inner), (None, ch)))
    return {"attn": kv(S), "mamba": [state] * (cfg.hybrid.period - 1)}


def _serve_ctx(cfg: ModelConfig, mesh) -> AxisCtx:
    """The serve steps' ctx: the mesh's, without the vocab axis for a
    spatial arch (its embeddings stay whole, as in the JAX package); a
    subgrid-EP arch on a mesh its experts cannot tile raises."""
    ctx = mesh_ctx(mesh)
    moe_mod.check_mesh(cfg, dict(_axis_sizes(mesh)))
    if sspecs.placement_for(cfg) == "spatial":
        ctx = dataclasses.replace(ctx, vocab=None)
    return ctx


def to_cache_layout(caches, tree, ctx: AxisCtx):
    """A prefill's caches on this rank -> ``cache_tree``'s layout (``tree``,
    its ``InputSpec``s). Only a Mamba state needs it: its ``conv`` rows
    become the last sequence shard's on every rank (a masked sum over
    ``model``), then ``h`` (already the global final state) and ``conv``
    are cut to the rank's block of the dims the tree shards over
    ``model`` (the channels, in a tensor-parallel decode)."""
    M = ctx.size(ctx.model)
    if M == 1:
        return caches

    def cut(t, sp):
        for dim, entry in enumerate(sp.spec):
            if entry == "model":
                n = t.shape[dim] // M
                t = t.narrow(dim, ctx.index(ctx.model) * n, n).contiguous()
        return t

    def walk(c, sp):
        if isinstance(c, MambaState):
            is_last = float(ctx.index(ctx.model) == M - 1)
            return MambaState(cut(c.h, sp.h), cut(ctx.psum(c.conv * is_last, ctx.model), sp.conv))
        if isinstance(c, dict):
            return {k: walk(c[k], sp[k]) for k in c}
        if isinstance(c, list):
            return [walk(a, b) for a, b in zip(c, sp)]
        return c
    return walk(caches, tree)


def grow_caches(caches, ctx: AxisCtx, extra: int):
    """Grow the sequence-sharded attention caches of a tree by ``extra``
    slots (``transformer.pad_caches`` on a mesh): a shard holds a contiguous
    block of positions, so each cache is all-gathered over ``model``,
    padded and cut again (``extra`` chosen so that the model axis divides
    the new length). The recurrent states and the cross K/V pass through."""
    M = ctx.size(ctx.model)

    def relayout(c):
        whole = type(c)(*(ctx.all_gather(t, ctx.model, axis=2) for t in c))
        whole = pad_caches(whole, extra)
        n = whole[0].shape[2] // M
        return type(c)(*(t.narrow(2, ctx.index(ctx.model) * n, n).contiguous() for t in whole))

    def walk(c):
        if isinstance(c, (KVCache, LatentCache)):
            return relayout(c) if M > 1 else pad_caches(c, extra)
        if isinstance(c, EncDecCaches):
            return c._replace(self_caches=walk(c.self_caches))
        if isinstance(c, dict):
            return {k: walk(v) for k, v in c.items()}
        if isinstance(c, list):
            return [walk(v) for v in c]
        return c
    return walk(caches)


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      dtype=torch.bfloat16) -> BuiltStep:
    """The prefill step on ``mesh``: ``fn(params, batch) -> (caches,
    logits)``, under ``torch.inference_mode``. Params ``fsdp``, gathered
    per layer (a spatial arch's replicated); the batch as ``batch_struct``
    shards it; the caches this rank's shard in exactly ``cache_tree``'s
    layout (``to_cache_layout``), so the decode step on the same mesh takes
    them; the logits (B_loc, Vp), the last position's over the whole vocab
    on every rank."""
    ctx = _serve_ctx(cfg, mesh)
    sizes = dict(_axis_sizes(mesh))
    model = model_zoo.build(cfg)
    spatial = sspecs.placement_for(cfg) == "spatial"
    gather = sspecs.make_gather_fn(cfg, ctx)
    tree = cache_tree(cfg, shape, sizes, dtype)

    def fn(params, batch):
        with torch.inference_mode():
            caches, logits, _ = model.prefill(unflatten_params(params), batch, ctx=ctx,
                                              gather_fn=gather)
            return to_cache_layout(caches, tree, ctx), logits

    inputs = (param_structs(cfg, sizes, "spatial" if spatial else "fsdp", dtype),
              batch_struct(cfg, shape, sizes, dtype=dtype))
    check_divisible(inputs + (tree,), sizes, f"{cfg.name}'s prefill step")
    return BuiltStep(fn, inputs, "prefill", ctx)


def make_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     dtype=torch.bfloat16) -> BuiltStep:
    """The decode step on ``mesh``: ``fn(params, tokens, caches, length)
    -> (logits, caches)``, under ``torch.inference_mode``, the caches
    written in place. Params ``tp`` (tensor-parallel, resident; a spatial
    arch's replicated); tokens and lengths (B,) over ``(pod, data)``; the
    caches ``cache_tree`` at capacity ``shape.seq_len``; the logits (B_loc,
    V_loc) of the rank's vocab slice (the whole vocab for a spatial
    arch)."""
    ctx = _serve_ctx(cfg, mesh)
    sizes = dict(_axis_sizes(mesh))
    model = model_zoo.build(cfg)
    tp = sspecs.placement_for(cfg) == "temporal"

    def fn(params, tokens, caches, length):
        with torch.inference_mode():
            return model.decode_step(unflatten_params(params), tokens, caches, length,
                                     ctx=ctx, tp=tp)

    B = shape.global_batch
    bspec = (_entry(_batch_axes(sizes, B)),)
    inputs = (param_structs(cfg, sizes, "tp" if tp else "spatial", dtype),
              InputSpec((B,), torch.int64, bspec), cache_tree(cfg, shape, sizes, dtype),
              InputSpec((B,), torch.int32, bspec))
    check_divisible(inputs, sizes, f"{cfg.name}'s decode step")
    return BuiltStep(fn, inputs, "decode", ctx)


def make_step_from_cfg(cfg: ModelConfig, shape_cfg: ShapeConfig, mesh,
                       fl: Optional[FLConfig] = None) -> BuiltStep:
    """The step of ``shape_cfg.kind``: train, prefill or decode."""
    if shape_cfg.kind == "train":
        return make_train_step(cfg, shape_cfg, mesh, fl)
    if shape_cfg.kind == "prefill":
        return make_prefill_step(cfg, shape_cfg, mesh)
    return make_decode_step(cfg, shape_cfg, mesh)


def make_step(arch: str, shape_cfg: ShapeConfig, mesh,
              fl: Optional[FLConfig] = None) -> BuiltStep:
    """``make_step_from_cfg`` for an arch name."""
    return make_step_from_cfg(get_config(arch), shape_cfg, mesh, fl)
