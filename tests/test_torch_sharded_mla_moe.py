"""MLA and the MoE FFN's expert parallelism in the temporal placement on a
device mesh (``launch/steps.make_{train,prefill,decode}_step``, reduced
minicpm3-4b, qwen3-moe-30b-a3b and arctic-480b; ``moe.moe_ffn(ctx=)`` in
its model, grid and subgrid modes) against the port's meshless steps and
the JAX package's, at tight f32 tolerances.

The port runs on 8 ``gloo`` ranks (``launch/mesh.spawn``, once for the
file), each building a (2, 2, 2) ``("pod", "data", "model")`` mesh over all
8, a (2, 2) ``("data", "model")`` mesh and a (1, 4) one over ranks 0-3. The
JAX side runs this file as a script on 8 forced host devices
(``REPRO_KERNEL_IMPL=jnp``). Inputs are f32: params drawn by the port's
``init_params`` (carried to JAX through ``interop``), tokens and labels
over the whole vocab.

The MoE step on a mesh is the JAX package's: each rank sizes its expert
buckets from its own tokens (``capacity(T_loc, ...)``), so pairs drop per
rank, and each rank's aux losses are averaged over ``(pod, data,
model)``. So:

- Train, no drops: one FedAvg round of one local step of 8 x 32 tokens on
  (2, 2) and (2, 2, 2), at capacity factor 4.0 with the aux weights at 0
  and no pair dropped on any rank: loss rtol 1e-5, params atol 1e-5 /
  rtol 1e-4 against the port's meshless ``build_temporal_round`` (for
  minicpm3-4b, which has no MoE, the aux weights do not enter).
- Train, the mesh semantics: the same round at the configs' own capacity
  factor with the aux losses on, against the JAX package's meshless round
  with its ``moe_ffn`` applied to each rank's block of tokens and the
  blocks' aux losses averaged (the function the JAX mesh step defines, and
  its exact gradient), same tolerances. The JAX ``shard_map`` step itself
  departs from it (ROADMAP C10: strict xfails).
- ``moe_ffn`` alone, on (2, 2) and (2, 2, 2): model EP (qwen3-moe), the
  grid ring (jamba's MoE config: plain, ``quant_ring`` against the JAX
  package run with ``REPRO_QUANT_RING=1``, and at decode the ``psum``) and
  subgrid EP (arctic, train and decode): each rank's output, aux losses,
  drop fraction and ``torch.autograd`` gradients (of ``sum(out * ct) +
  load_balance + z_loss`` on the rank) against ``jax.grad`` inside the
  JAX ``shard_map``, atol 1e-5 / rtol 1e-4. ROADMAP C11 on the JAX side
  (a strict xfail): its gradient sync leaves a data-resident expert leaf
  the sum over the data rows; the port's ``grad_split_axes`` divides it.
- Decode and prefill on (2, 2) for minicpm3-4b and qwen3-moe: one decode
  step over a 32-slot cache at per-row lengths that leave the second model
  shard empty in some rows (logits, written cache, greedy tokens against
  the port's and the JAX meshless steps and the JAX ``shard_map`` decode),
  and the (B, V) prefill logits and caches against meshless.
- Refusals: arctic-480b on (1, 4) (``E / data * f_sub != model``) and
  ``moe_ffn`` given a rank's expert shard without the mesh.
- The input trees: ``batch_struct``, ``param_structs`` (fsdp, tp) and
  ``cache_tree`` of the three archs give the JAX package's shapes and
  specs on both meshes.

This module imports no JAX at its top: the spawned ranks import it.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
MESHES = {"dm": ((2, 2), ("data", "model")),
          "pdm": ((2, 2, 2), ("pod", "data", "model"))}
LINE = ((1, 4), ("data", "model"))
TRAIN_ARCHS = ("minicpm3-4b", "qwen3-moe-30b-a3b", "arctic-480b")
SERVE_ARCHS = ("minicpm3-4b", "qwen3-moe-30b-a3b")
# capacity factor (None: the config's) and whether the aux losses count
VARIANTS = {"exact": (4.0, False), "serve": (4.0, True), "own": (None, True),
            "tight": (0.5, True)}
MESH_VARIANTS = ("own", "tight")     # the MoE archs' mesh semantics
TRAIN_CELLS = [(a, m, v) for a in TRAIN_ARCHS for m in MESHES
               for v in (("exact",) + MESH_VARIANTS if a != "minicpm3-4b" else ("exact",))]
# moe_ffn alone: name -> (arch, phase, quant_ring)
MOE_CELLS = {"model": ("qwen3-moe-30b-a3b", "train", False),
             "model_decode": ("qwen3-moe-30b-a3b", "decode", False),
             "grid": ("jamba-1.5-large-398b", "train", False),
             "grid_quant": ("jamba-1.5-large-398b", "train", True),
             "grid_decode": ("jamba-1.5-large-398b", "decode", False),
             "subgrid": ("arctic-480b", "train", False),
             "subgrid_decode": ("arctic-480b", "decode", False)}
MOE_B, MOE_S = 8, 32                 # moe_ffn alone: (B, S) train tokens, (B, 1) decode
S, B = 32, 8                         # the steps
LENGTHS = np.array([0, 3, 14, 15, 16, 20, 30, 31], np.int32)   # decode: rows' context
W_KEYS = ("router", "w1", "w3", "w2")


def _cfg(arch, variant="exact"):
    """Reduced ``arch`` in the port; an MoE arch at the ``VARIANTS`` entry's
    capacity factor, its aux weights at 0 where the entry says so."""
    from repro_torch.configs.base import get_config
    from repro_torch.configs.reduce import reduced_config
    return _variant(reduced_config(get_config(arch)), variant)


def _variant(cfg, variant):
    cf, aux = VARIANTS[variant]
    if cfg.moe is None:
        return cfg
    kw = {} if cf is None else {"capacity_factor": cf}
    if not aux:
        kw.update(load_balance_loss=0.0, router_z_loss=0.0)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))


def _fl():
    from repro_torch.configs.base import FLConfig
    return FLConfig(strategy="fedavg", local_epochs=1, client_lr=1e-2)


def _params(arch):
    """The port's init_params draw, f32, as flat numpy."""
    from repro_torch.core import determinism
    from repro_torch.models.transformer import flatten_params, init_params
    p = init_params(determinism.generator(27, "cpu"), _cfg(arch))
    return {k: v.numpy() for k, v in flatten_params(p).items()}


def _data(arch):
    """Train tokens and labels (1, 1, B, S), the prompt (B, S), the decode
    tokens (B,) and a cache of 32 slots, rows zero from their length on."""
    cfg = _cfg(arch)
    rng = np.random.RandomState(8)
    out = {"tokens": rng.randint(0, cfg.vocab_size, (1, 1, B, S)),
           "labels": rng.randint(0, cfg.vocab_size, (1, 1, B, S)),
           "prompt": rng.randint(0, cfg.vocab_size, (B, S)),
           "step_tokens": rng.randint(0, cfg.vocab_size, (B,))}
    live = np.arange(S)[None, :] < LENGTHS[:, None]
    if cfg.attn_type == "mla":
        dims = {"ckv": cfg.mla.kv_lora_rank, "krope": cfg.mla.qk_rope_head_dim}
        for f, d in dims.items():
            out[f] = (rng.randn(cfg.n_layers, B, S, d) * live[None, :, :, None]
                      ).astype(np.float32)
    else:
        shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.resolved_head_dim)
        for f in ("k", "v"):
            out[f] = (rng.randn(*shape) * live[None, :, :, None, None]).astype(np.float32)
    return out


def _cache(d):
    from repro_torch.models.attention import KVCache, LatentCache
    if "ckv" in d:
        return LatentCache(_t(d["ckv"]).clone(), _t(d["krope"]).clone())
    return KVCache(_t(d["k"]).clone(), _t(d["v"]).clone())


def _shapes():
    from repro_torch.configs.base import ShapeConfig
    return {kind: ShapeConfig(kind, S, B, kind) for kind in ("train", "prefill", "decode")}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return type(t)(*(_np_tree(v) for v in t)) if hasattr(t, "_fields") \
            else type(t)(_np_tree(v) for v in t)
    return t.detach().numpy() if isinstance(t, torch.Tensor) else t


# ---------------------------------------------------------------------------
# moe_ffn alone
# ---------------------------------------------------------------------------

def _moe_cfg(cell):
    return _cfg(MOE_CELLS[cell][0], "tight")


def _moe_arrays(cell):
    """Global f32 inputs of a moe_ffn cell: x and the cotangent (B, S, D)
    (decode: (B, 1, D)) and the config's expert weights, from one seed."""
    from repro_torch.models import moe
    cfg = _moe_cfg(cell)
    rng = np.random.RandomState(9)
    seq = 1 if MOE_CELLS[cell][1] == "decode" else MOE_S
    x = rng.randn(MOE_B, seq, cfg.d_model).astype(np.float32)
    ct = rng.randn(MOE_B, seq, cfg.d_model).astype(np.float32)
    w = moe.init_moe_params(torch.Generator().manual_seed(10), cfg)
    return x, ct, {k: v.numpy() for k, v in w.items()}


def _moe_specs(cell, axes):
    """(x spec, {weight: spec}): tokens over the batch axes (and the
    sequence over ``model`` in training), the router whole, the experts as
    ``specs._moe_expert_spec`` places them."""
    from repro_torch.sharding import specs
    cfg = _moe_cfg(cell)
    batch = tuple(a for a in ("pod", "data") if a in axes)
    seq = "model" if MOE_CELLS[cell][1] == "train" else None
    x = (batch if len(batch) > 1 else batch[0], seq, None)
    w = dict(specs._moe_expert_spec(cfg, 0), router=(None, None))
    return x, w


def _cut(t, spec, ctx):
    """This rank's block of the global ``t`` under ``spec``."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n, i = ctx.size(entry), ctx.index(entry)
        per = t.shape[dim] // n
        t = t.narrow(dim, i * per, per)
    return t.contiguous()


def _moe_rank(cell, ctx, axes):
    """This rank's moe_ffn: output, (load_balance, z_loss, drop_fraction)
    and the gradients of sum(out * ct) + load_balance + z_loss in x and
    the weights."""
    from repro_torch.models import moe
    _, phase, quant = MOE_CELLS[cell]
    cfg = _moe_cfg(cell)
    x_g, ct_g, w_g = _moe_arrays(cell)
    xs, ws = _moe_specs(cell, axes)
    x = _cut(_t(x_g), xs, ctx).requires_grad_()
    ct = _cut(_t(ct_g), xs, ctx)
    w = {k: _cut(_t(w_g[k]), ws[k], ctx).requires_grad_() for k in W_KEYS}
    out, aux = moe.moe_ffn(w, x, cfg, ctx=ctx, tokens_replicated=phase == "decode",
                           quant_ring=quant)
    J = (out * ct).sum() + aux.load_balance + aux.z_loss
    grads = torch.autograd.grad(J, [x] + [w[k] for k in W_KEYS])
    return {"out": out.detach().numpy(),
            "aux": np.array([aux.load_balance.item(), aux.z_loss.item(),
                             aux.drop_fraction.item()], np.float32),
            **{f"g_{k}": g.numpy() for k, g in zip(("x",) + W_KEYS, grads)}}


# ---------------------------------------------------------------------------
# The port's ranks
# ---------------------------------------------------------------------------

def _train_globals(built, arch):
    state, _, _, _ = built.global_arrays(0)
    d = _data(arch)
    state = dict(state, params={k: _t(v) for k, v in _params(arch).items()})
    return state, {"tokens": _t(d["tokens"]), "labels": _t(d["labels"])}, \
        torch.ones(1), torch.zeros((), dtype=torch.int64)


def rank_body(rank, world):
    """One rank: the train cells, moe_ffn alone, the decode and prefill
    steps on (2, 2), the refusals."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model_zoo
    from repro_torch.models import moe

    torch.set_num_threads(1)
    meshes = {m: make_test_mesh(shape, axes, device="cpu")
              for m, (shape, axes) in MESHES.items()}
    line = make_test_mesh(*LINE, device="cpu")
    for mesh in (*meshes.values(), line):
        steps.mesh_ctx(mesh)           # every rank: the groups are world-collective
    drops = []
    plain_moe = moe.moe_ffn

    def recorded(*args, **kw):
        out, aux = plain_moe(*args, **kw)
        drops.append(aux.drop_fraction.item())
        return out, aux
    moe.moe_ffn = recorded
    out = {}
    shapes = _shapes()
    try:
        for arch, m, variant in TRAIN_CELLS:
            if rank >= meshes[m].size():
                continue
            built = steps.make_train_step(_cfg(arch, variant), shapes["train"], meshes[m],
                                          _fl(), dtype=torch.float32)
            drops.clear()
            new, met = built.fn(*built.shard(_train_globals(built, arch), "cpu"))
            out[(arch, m, variant)] = (met["loss"].item(), _np_tree(new["params"]),
                                       list(drops))
    finally:
        moe.moe_ffn = plain_moe
    for cell in MOE_CELLS:
        for m, mesh in meshes.items():
            if rank < mesh.size():
                out[("moe", cell, m)] = _moe_rank(cell, steps.mesh_ctx(mesh), MESHES[m][1])
    if rank >= 4:
        return out
    mesh = meshes["dm"]
    for arch in SERVE_ARCHS:
        cfg = _cfg(arch, "serve")
        model = model_zoo.build(cfg)
        d = _data(arch)
        params = {k: _t(v) for k, v in _params(arch).items()}
        dec = steps.make_decode_step(cfg, shapes["decode"], mesh, dtype=torch.float32)
        p, tokens, caches, length = dec.shard(
            (params, _t(d["step_tokens"]), _cache(d), _t(LENGTHS)), "cpu")
        logits, caches = dec.fn(p, tokens, caches, length)
        out[("decode", arch)] = (logits.numpy(), _np_tree(caches),
                                 model.greedy_token(logits, ctx=dec.ctx).numpy())
        pre = steps.make_prefill_step(cfg, shapes["prefill"], mesh, dtype=torch.float32)
        p, batch = pre.shard((params, {"tokens": _t(d["prompt"]),
                                       "labels": _t(d["prompt"])}), "cpu")
        caches, logits = pre.fn(p, batch)
        out[("prefill", arch)] = (logits.numpy(), _np_tree(caches))
    refusals = {}
    makers = {"train": steps.make_train_step, "prefill": steps.make_prefill_step,
              "decode": steps.make_decode_step}
    from repro_torch.configs.base import get_config
    for kind in makers:
        refusals[(kind, "arctic-480b")] = _refusal(makers[kind], get_config("arctic-480b"),
                                                   shapes[kind], line)
    out["refusals"] = refusals
    out["make_step"] = {(arch, kind): steps.make_step(arch, shapes[kind], mesh).kind
                        for arch in SERVE_ARCHS for kind in ("train", "prefill", "decode")}
    return out


def _refusal(make, cfg, shape, mesh):
    try:
        make(cfg, shape, mesh)
    except ValueError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# The port's meshless twins
# ---------------------------------------------------------------------------

def _meshless():
    from repro_torch.core.rounds import build_temporal_round
    from repro_torch.core.strategies import get_strategy
    from repro_torch.models import model_zoo
    from repro_torch.models.transformer import FlatModel, unflatten_params

    out = {}
    for arch in TRAIN_ARCHS:
        model = model_zoo.build(_cfg(arch))
        d = _data(arch)
        params = {k: _t(v) for k, v in _params(arch).items()}
        round_fn = build_temporal_round(FlatModel(model), get_strategy(_fl()), _fl())
        new, met = round_fn({"params": params, "server": (), "clients": ()},
                            {"tokens": _t(d["tokens"]), "labels": _t(d["labels"])},
                            torch.ones(1), 0)
        out[("train", arch)] = (met["loss"].item(), _np_tree(new["params"]))
    for arch in SERVE_ARCHS:
        model = model_zoo.build(_cfg(arch, "serve"))
        d = _data(arch)
        nested = unflatten_params({k: _t(v) for k, v in _params(arch).items()})
        with torch.inference_mode():
            logits, caches = model.decode_step(nested, _t(d["step_tokens"]), _cache(d),
                                               _t(LENGTHS))
            pcaches, plogits, _ = model.prefill(nested, {"tokens": _t(d["prompt"])})
        out[("decode", arch)] = (logits.numpy(), _np_tree(caches),
                                 model.greedy_token(logits).numpy())
        out[("prefill", arch)] = (plogits.numpy(), _np_tree(pcaches))
    return out


# ---------------------------------------------------------------------------
# The JAX side (this file as a script)
# ---------------------------------------------------------------------------

def _jax_cfg(arch, variant):
    from repro.configs.base import get_config as j_get_config
    from repro.configs.reduce import reduced_config as j_reduced
    return _variant(j_reduced(j_get_config(arch)), variant)


def _blockwise_moe(mesh_shape, mesh_axes):
    """The JAX package's ``moe_ffn`` applied to each rank's block of a
    meshless (B, S, D) batch (the batch over ``(pod, data)``, the
    sequence over ``model``), the blocks' aux losses averaged: the function
    its mesh step defines, meshless."""
    import jax.numpy as jnp

    from repro.models import moe as jmoe
    plain = jmoe.moe_ffn
    sizes = dict(zip(mesh_axes, mesh_shape))
    nb = sizes.get("pod", 1) * sizes.get("data", 1)
    ns = sizes.get("model", 1)

    def blockwise(ctx, w, x, cfg, *, tokens_replicated=False):
        rows, auxes = [], []
        for xb in jnp.split(x, nb, axis=0):
            cols = []
            for xs in jnp.split(xb, ns, axis=1):
                o, a = plain(ctx, w, xs, cfg, tokens_replicated=tokens_replicated)
                cols.append(o)
                auxes.append(a)
            rows.append(jnp.concatenate(cols, axis=1))
        n = len(auxes)
        aux = jmoe.MoEAux(*(sum(getattr(a, f) for a in auxes) / n
                            for f in ("load_balance", "z_loss", "drop_fraction")))
        return jnp.concatenate(rows, axis=0), aux
    return plain, blockwise


def _jax_moe_cells(res):
    """moe_ffn alone under shard_map: every rank's output, aux losses and
    ``jax.grad`` of sum(out * ct) + load_balance + z_loss, stacked by rank."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.launch.mesh import make_test_mesh
    from repro.launch.steps import mesh_ctx, shard_map
    from repro.models import moe as jmoe

    for cell, (arch, phase, quant) in MOE_CELLS.items():
        cfg = _jax_cfg(arch, "tight")
        x_g, ct_g, w_g = _moe_arrays(cell)
        for m, (shape, axes) in MESHES.items():
            mesh = make_test_mesh(shape, axes)
            ctx = mesh_ctx(mesh)
            xs, ws = _moe_specs(cell, axes)
            every = P(tuple(axes))

            def body(x, ct, w):
                def J(x, w):
                    out, aux = jmoe.moe_ffn(ctx, w, x, cfg,
                                            tokens_replicated=phase == "decode")
                    return (out * ct).sum() + aux.load_balance + aux.z_loss, (out, aux)
                (_, (out, aux)), (gx, gw) = jax.value_and_grad(
                    J, argnums=(0, 1), has_aux=True)(x, w)
                a = jnp.stack([aux.load_balance, aux.z_loss,
                               aux.drop_fraction.astype(jnp.float32)])
                return {"out": out[None], "aux": a[None], "g_x": gx[None],
                        **{f"g_{k}": gw[k][None] for k in W_KEYS}}
            f = shard_map(body, mesh=mesh,
                          in_specs=(P(*xs), P(*xs), {k: P(*ws[k]) for k in W_KEYS}),
                          out_specs=every, check_rep=False)
            if quant:
                os.environ["REPRO_QUANT_RING"] = "1"
            try:
                got = jax.jit(f)(jnp.asarray(x_g), jnp.asarray(ct_g),
                                 {k: jnp.asarray(w_g[k]) for k in W_KEYS})
            finally:
                os.environ.pop("REPRO_QUANT_RING", None)
            for k, v in got.items():
                res[f"moe|{cell}|{m}|{k}"] = np.asarray(v)


def _jax_side(out_path):
    """This file as a script: the JAX package's meshless rounds (plain, and
    with the blockwise MoE at the configs' own capacity), its decode and
    prefill steps meshless and under ``shard_map`` on (2, 2), its mesh
    train step (C10), ``moe_ffn`` alone under ``shard_map``, and its input
    trees."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import FLConfig as JFL
    from repro.configs.base import ShapeConfig as JShape
    from repro.core.rounds import build_temporal_round
    from repro.core.strategies import get_strategy
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_test_mesh, mesh_context
    from repro.models import model_zoo
    from repro.models import moe as jmoe
    from repro.models.attention import KVCache, LatentCache
    from repro.sharding.axes import AxisCtx
    from repro_torch.models.transformer import unflatten_params

    fl = JFL(strategy="fedavg", local_epochs=1, client_lr=1e-2)
    ctx0 = AxisCtx()
    rng = jnp.zeros((2,), jnp.uint32)
    res = {}

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[prefix + k] = np.asarray(v)
        return out

    for arch in TRAIN_ARCHS:
        d = _data(arch)
        params = jax.tree.map(jnp.asarray, unflatten_params(_params(arch)))
        batch = {"tokens": jnp.asarray(d["tokens"], jnp.int32),
                 "labels": jnp.asarray(d["labels"], jnp.int32)}
        state = {"params": params, "server": (), "clients": ()}
        variants = ("exact",) + MESH_VARIANTS if arch != "minicpm3-4b" else ("exact",)
        for variant in variants:
            cfg = _jax_cfg(arch, variant)
            model = model_zoo.build(cfg)
            for m, (shape, axes) in MESHES.items():
                if variant == "exact" and m == "pdm":
                    continue            # exact rounds do not depend on the mesh
                plain, blockwise = _blockwise_moe(shape, axes)
                jmoe.moe_ffn = plain if variant == "exact" else blockwise
                try:
                    rf = build_temporal_round(model, get_strategy(fl), fl, cfg)
                    new, met = jax.jit(lambda s, b, w, r: rf(ctx0, s, b, w, r))(
                        state, batch, jnp.ones((1,), jnp.float32), rng)
                finally:
                    jmoe.moe_ffn = plain
                key = f"train|{arch}|{variant}|{'any' if variant == 'exact' else m}"
                res[f"{key}|loss"] = np.asarray(float(met["loss"]))
                for k, v in flat(new["params"]).items():
                    res[f"{key}|params|{k}"] = v
            if variant == "tight":
                mesh = make_test_mesh(*MESHES["dm"])
                with mesh_context(mesh):
                    tr = jsteps.make_train_step(cfg, JShape("t", S, B, "train"), mesh, fl)
                    _, met = jax.jit(tr.fn)(state, batch, jnp.ones((1,), jnp.float32), rng)
                res[f"mesh_train|{arch}|loss"] = np.asarray(float(met["loss"]))

    for arch in SERVE_ARCHS:
        cfg = _jax_cfg(arch, "serve")
        model = model_zoo.build(cfg)
        d = _data(arch)
        params = jax.tree.map(jnp.asarray, unflatten_params(_params(arch)))
        if "ckv" in d:
            cache = LatentCache(jnp.asarray(d["ckv"]), jnp.asarray(d["krope"]))
        else:
            cache = KVCache(jnp.asarray(d["k"]), jnp.asarray(d["v"]))
        toks, length = jnp.asarray(d["step_tokens"], jnp.int32), jnp.asarray(LENGTHS)
        lo, new_c = jax.jit(lambda p, t, c, ln: model.decode_step(ctx0, p, t, c, ln, tp=False))(
            params, toks, cache, length)
        res[f"decode|{arch}|logits"] = np.asarray(lo)
        res[f"decode|{arch}|cache0"] = np.asarray(new_c[0])
        _, plogits, _ = jax.jit(lambda p, b: model.prefill(ctx0, p, b))(
            params, {"tokens": jnp.asarray(d["prompt"], jnp.int32)})
        res[f"prefill|{arch}|logits"] = np.asarray(plogits)
        mesh = make_test_mesh(*MESHES["dm"])
        with mesh_context(mesh):
            dec = jsteps.make_decode_step(cfg, JShape("d", S, B, "decode"), mesh)
            lo, new_c = jax.jit(dec.fn)(params, toks, cache, length)
        res[f"mesh_decode|{arch}|logits"] = np.asarray(lo)
        res[f"mesh_decode|{arch}|cache0"] = np.asarray(new_c[0])

    _jax_moe_cells(res)
    res["structs"] = np.asarray(_jax_structs())
    np.savez(out_path, **res)


def _flat_structs(tree, spec_of, is_leaf):
    """{"/"-joined path: spec_of(leaf)} over dicts and NamedTuples."""
    if is_leaf(tree):
        return {"": spec_of(tree)}
    items = tree.items() if isinstance(tree, dict) else zip(tree._fields, tree)
    out = {}
    for k, v in items:
        for kk, vv in _flat_structs(v, spec_of, is_leaf).items():
            out[f"{k}/{kk}" if kk else k] = vv
    return out


def _norm_spec(spec):
    """A spec as JSON lists, a 1-tuple entry as its name."""
    out = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            e = e[0] if len(e) == 1 else list(e)
        out.append(e)
    return out


STRUCTS = ("train", "prefill", "decode", "fsdp", "tp", "cache")


def _jax_structs():
    """The JAX package's input trees of the three reduced archs on both
    meshes, as ``_port_structs`` gives the port's, as JSON."""
    from repro.configs.base import ShapeConfig as JShape
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_test_mesh

    shapes = {kind: JShape(kind, S, B, kind) for kind in ("train", "prefill", "decode")}

    def spec_of(sds):
        spec = [tuple(e) if isinstance(e, (tuple, list)) else e for e in sds.sharding.spec]
        spec += [None] * (len(sds.shape) - len(spec))
        return (list(sds.shape), _norm_spec(spec))
    res = {}

    def leaf(t):
        return not isinstance(t, dict) and not hasattr(t, "_fields")
    for arch in TRAIN_ARCHS:
        cfg = _jax_cfg(arch, "own")
        for m, (shape, axes) in MESHES.items():
            mesh = make_test_mesh(shape, axes)
            trees = {"train": jsteps.batch_struct(cfg, shapes["train"], mesh, lead=(1, 1)),
                     "prefill": jsteps.batch_struct(cfg, shapes["prefill"], mesh),
                     "decode": jsteps.batch_struct(cfg, shapes["decode"], mesh),
                     "fsdp": jsteps.param_structs(cfg, mesh, "fsdp"),
                     "tp": jsteps.param_structs(cfg, mesh, "tp"),
                     "cache": jsteps.cache_tree(cfg, shapes["decode"], mesh)[0]}
            res[f"{arch}|{m}"] = {k: _flat_structs(t, spec_of, leaf) for k, t in trees.items()}
    return json.dumps(res)


def _port_structs(arch, sizes):
    from repro_torch.launch import steps

    cfg, shapes = _cfg(arch, "own"), _shapes()

    def spec_of(sp):
        return (list(sp.shape), _norm_spec(sp.spec))

    def flat(tree):
        return _flat_structs(tree, spec_of, lambda t: isinstance(t, steps.InputSpec))
    return {"train": flat(steps.batch_struct(cfg, shapes["train"], sizes, lead=(1, 1))),
            "prefill": flat(steps.batch_struct(cfg, shapes["prefill"], sizes)),
            "decode": flat(steps.batch_struct(cfg, shapes["decode"], sizes)),
            "fsdp": flat(_nest(steps.param_structs(cfg, sizes, "fsdp"))),
            "tp": flat(_nest(steps.param_structs(cfg, sizes, "tp"))),
            "cache": flat(steps.cache_tree(cfg, shapes["decode"], sizes))}


def _nest(flat_specs):
    from repro_torch.models.transformer import unflatten_params
    return unflatten_params(flat_specs)


# ---------------------------------------------------------------------------
# Fixture and helpers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks, the JAX side and the port's meshless steps."""
    from repro_torch.launch.mesh import spawn

    out = str(tmp_path_factory.mktemp("sharded_mla_moe") / "jax.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", REPRO_KERNEL_IMPL="jnp",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    env.pop("REPRO_QUANT_RING", None)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), out], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = spawn(rank_body, 8, "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        meshless = _meshless()
    finally:
        torch.set_num_threads(threads)
    _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    with np.load(out) as z:
        return ranks, meshless, dict(z)


def _coords(mesh):
    return list(np.ndindex(*MESHES[mesh][0]))


def _assemble(ranks, mesh, key, arch):
    """The mesh run's params as global arrays: each rank's shards placed by
    the step's specs (every rank must agree where the specs replicate)."""
    from repro_torch.launch import steps

    shape, axes = MESHES[mesh]
    specs = steps.param_structs(_cfg(arch), dict(zip(axes, shape)), "fsdp", torch.float32)
    out = {}
    for k, sp in specs.items():
        full = np.full(sp.shape, np.nan, np.float32)
        for r, c in enumerate(_coords(mesh)):
            block = ranks[r][key][1][k]
            idx = []
            for dim, entry in enumerate(sp.spec):
                if entry is None:
                    idx.append(slice(None))
                    continue
                i = 0
                for a in (entry if isinstance(entry, tuple) else (entry,)):
                    i = i * shape[axes.index(a)] + c[axes.index(a)]
                n = block.shape[dim]
                idx.append(slice(i * n, (i + 1) * n))
            region = full[tuple(idx)]
            if not np.isnan(region).all():
                np.testing.assert_array_equal(region, block, err_msg=f"{k}: replicas differ")
            full[tuple(idx)] = block
        assert not np.isnan(full).any(), k
        out[k] = full
    return out


def _close_params(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4,
                                   err_msg=f"{what}: {k}")


def _jax_params(jx, key):
    pre = f"{key}|params|"
    return {k[len(pre):]: v for k, v in jx.items() if k.startswith(pre)}


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", TRAIN_ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_train_step_without_drops_matches_meshless(runs, arch, mesh):
    ranks, meshless, jx = runs
    key = (arch, mesh, "exact")
    n = len(_coords(mesh))
    loss = ranks[0][key][0]
    assert all(ranks[r][key][0] == loss for r in range(n))     # the grid's loss
    if arch != "minicpm3-4b":   # every MoE layer ran on every rank, no pair dropped
        assert all(ranks[r][key][2] and max(ranks[r][key][2]) == 0.0 for r in range(n))
    params = _assemble(ranks, mesh, key, arch)
    m_loss, m_params = meshless[("train", arch)]
    np.testing.assert_allclose(loss, m_loss, rtol=1e-5)
    np.testing.assert_allclose(loss, float(jx[f"train|{arch}|exact|any|loss"]), rtol=1e-5)
    _close_params(params, m_params, "port meshless")
    _close_params(params, _jax_params(jx, f"train|{arch}|exact|any"), "JAX meshless")
    start = _params(arch)
    assert all(not np.array_equal(params[k], start[k]) for k in start)


@pytest.mark.parametrize("variant", MESH_VARIANTS)
@pytest.mark.parametrize("arch", TRAIN_ARCHS[1:])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_train_step_with_per_rank_capacity_is_the_jax_mesh_function(runs, arch, mesh,
                                                                    variant):
    """Per-rank capacity and the grid's mean of per-rank aux losses, at the
    config's capacity factor and at 0.5 (ranks drop pairs): the JAX
    package's blockwise function and its gradient."""
    ranks, _, jx = runs
    key = (arch, mesh, variant)
    n = len(_coords(mesh))
    loss = ranks[0][key][0]
    assert all(ranks[r][key][0] == loss for r in range(n))
    want = f"train|{arch}|{variant}|{mesh}"
    np.testing.assert_allclose(loss, float(jx[f"{want}|loss"]), rtol=1e-5)
    _close_params(_assemble(ranks, mesh, key, arch), _jax_params(jx, want),
                  "JAX blockwise meshless")


def test_tight_capacity_drops_pairs_on_every_rank(runs):
    """At capacity factor 0.5 every rank drops pairs (so the cells above
    hold the per-rank capacity where it matters)."""
    ranks, _, _ = runs
    for arch in TRAIN_ARCHS[1:]:
        for mesh in MESHES:
            for r in range(len(_coords(mesh))):
                assert max(ranks[r][(arch, mesh, "tight")][2]) > 0, (arch, mesh, r)


@pytest.mark.xfail(strict=True, reason="ROADMAP C10: the JAX package's mesh step mixes "
                                       "ranks' rows in its embedding and loss")
@pytest.mark.parametrize("arch", TRAIN_ARCHS[1:])
def test_c10_jax_mesh_moe_train_loss_is_its_blockwise_loss(runs, arch):
    _, _, jx = runs
    np.testing.assert_allclose(float(jx[f"mesh_train|{arch}|loss"]),
                               float(jx[f"train|{arch}|tight|dm|loss"]), rtol=1e-5)


def _moe_close(got, want, what):
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4, err_msg=what)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("cell", sorted(MOE_CELLS))
def test_moe_ffn_on_a_mesh_matches_jax_shard_map(runs, cell, mesh):
    ranks, _, jx = runs
    for r in range(len(_coords(mesh))):
        got = ranks[r][("moe", cell, mesh)]
        for f in ("out", "aux", "g_x") + tuple(f"g_{k}" for k in W_KEYS):
            _moe_close(got[f], jx[f"moe|{cell}|{mesh}|{f}"][r], f"rank {r} {f}")


def test_moe_ffn_cells_drop_pairs(runs):
    """The training cells drop pairs on some rank (capacity factor 0.5)."""
    ranks, _, _ = runs
    for cell in ("model", "grid", "subgrid"):
        assert max(ranks[r][("moe", cell, "dm")]["aux"][2] for r in range(4)) > 0, cell


def test_quant_ring_stays_near_the_plain_ring(runs):
    """int8 payloads move the output, within 5 % of each row's largest
    value of the plain ring's (3.3 % measured: the visit's int8 rounding
    through the SwiGLU, then the accumulator's, about 0.4 % of its row's
    largest value, at each of the M = 2 hops)."""
    ranks, _, _ = runs
    for mesh in MESHES:
        for r in range(len(_coords(mesh))):
            q = ranks[r][("moe", "grid_quant", mesh)]["out"]
            p = ranks[r][("moe", "grid", mesh)]["out"]
            rowmax = np.abs(p).max(axis=-1, keepdims=True)
            assert not np.array_equal(q, p)
            assert (np.abs(q - p) <= 0.05 * rowmax + 1e-6).all()


def _synced_expert_grads(per_rank, mesh, split):
    """One subgrid expert leaf's rank gradients (``per_rank[r]``) synced as
    the temporal round syncs them: block ``d * M + m`` of the leaf lives on
    ranks (*, d, m), the mean over ``pod`` (which does not shard it), and,
    with ``split``, the division by the ``data`` axis's size."""
    shape, axes = MESHES[mesh]
    M, R = shape[axes.index("model")], shape[axes.index("data")]
    blocks = {}
    for r, c in enumerate(_coords(mesh)):
        i = c[axes.index("data")] * M + c[axes.index("model")]
        blocks.setdefault(i, []).append(per_rank[r])
    out = np.concatenate([np.mean(blocks[i], axis=0) for i in sorted(blocks)])
    return out / R if split else out


def _blockwise_expert_grad(leaf, mesh):
    """The meshless gradient, in one expert leaf, of the batch shards' mean
    of each shard's sum over its ranks of sum(out * ct) + aux (the LM
    step's objective: a data row's loss is one, the rows averaged), with
    moe_ffn on each rank's block: the port's meshless moe_ffn."""
    from repro_torch.models import moe
    cfg = _moe_cfg("subgrid")
    x_g, ct_g, w_g = _moe_arrays("subgrid")
    shape, axes = MESHES[mesh]
    nb = int(np.prod([s for s, a in zip(shape, axes) if a != "model"]))
    ns = shape[axes.index("model")]
    w = {k: _t(w_g[k]).requires_grad_() for k in W_KEYS}
    total = 0.0
    for xb, cb in zip(np.split(x_g, nb), np.split(ct_g, nb)):
        for xs, cs in zip(np.split(xb, ns, axis=1), np.split(cb, ns, axis=1)):
            out, aux = moe.moe_ffn(w, _t(xs), cfg)
            total = total + ((out * _t(cs)).sum() + aux.load_balance + aux.z_loss) / nb
    return torch.autograd.grad(total, [w[leaf]])[0].numpy()


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_grad_split_makes_data_resident_experts_meshless(runs, mesh):
    ranks, _, jx = runs
    for leaf in ("w1", "w2"):
        per_rank = [ranks[r][("moe", "subgrid", mesh)][f"g_{leaf}"]
                    for r in range(len(_coords(mesh)))]
        np.testing.assert_allclose(_synced_expert_grads(per_rank, mesh, True),
                                   _blockwise_expert_grad(leaf, mesh), atol=1e-5, rtol=1e-4)


@pytest.mark.xfail(strict=True, reason="ROADMAP C11: the JAX package's make_grad_sync "
                                       "leaves a data-resident expert's gradient the sum "
                                       "over the data rows")
def test_c11_jax_sync_of_data_resident_experts_is_meshless(runs):
    _, _, jx = runs
    np.testing.assert_allclose(_synced_expert_grads(jx["moe|subgrid|dm|g_w1"], "dm", False),
                               _blockwise_expert_grad("w1", "dm"), atol=1e-5, rtol=1e-4)


def _cache_fields(arch):
    return ("ckv", "krope") if _cfg(arch).attn_type == "mla" else ("k", "v")


def _decode_view(ranks, arch):
    """Rank (d, m)'s logits (B/2, V/2) and cache shard placed globally."""
    res = [ranks[r][("decode", arch)] for r in range(4)]
    logits = np.concatenate([np.concatenate([res[2 * d + m][0] for m in (0, 1)], axis=1)
                             for d in (0, 1)], axis=0)
    caches = {f: np.concatenate([np.concatenate([getattr(res[2 * d + m][1], f)
                                                 for m in (0, 1)], axis=2)
                                 for d in (0, 1)], axis=1)
              for f in _cache_fields(arch)}
    for d in (0, 1):
        np.testing.assert_array_equal(res[2 * d][2], res[2 * d + 1][2])
    return logits, caches, np.concatenate([res[2 * d][2] for d in (0, 1)])


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_decode_step_matches_meshless_and_jax(runs, arch):
    ranks, meshless, jx = runs
    logits, caches, tokens = _decode_view(ranks, arch)
    m_logits, m_caches, m_tokens = meshless[("decode", arch)]
    first = _cache_fields(arch)[0]
    for want, what in ((m_logits, "port meshless"), (jx[f"decode|{arch}|logits"], "JAX meshless"),
                       (jx[f"mesh_decode|{arch}|logits"], "JAX shard_map")):
        np.testing.assert_allclose(logits, want, atol=1e-5, rtol=1e-4, err_msg=what)
    for f in _cache_fields(arch):
        np.testing.assert_allclose(caches[f], getattr(m_caches, f), atol=1e-5, rtol=1e-4)
    for want, what in ((jx[f"decode|{arch}|cache0"], "JAX meshless"),
                       (jx[f"mesh_decode|{arch}|cache0"], "JAX shard_map")):
        np.testing.assert_allclose(caches[first], want, atol=1e-5, rtol=1e-4, err_msg=what)
    np.testing.assert_array_equal(tokens, m_tokens)
    # the new row went to position length, in the shard that owns it
    c = caches[first]
    assert (np.abs(c[:, np.arange(B), LENGTHS]).reshape(c.shape[0], B, -1).sum(axis=(0, 2))
            > 0).all()


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_step_gives_the_whole_vocab_as_meshless(runs, arch):
    ranks, meshless, jx = runs
    m_logits, m_caches = meshless[("prefill", arch)]
    V = _cfg(arch).padded_vocab
    res = [ranks[r][("prefill", arch)] for r in range(4)]
    for r in range(4):
        assert res[r][0].shape == (B // 2, V)
        np.testing.assert_array_equal(res[r][0], res[r ^ 1][0])
    logits = np.concatenate([res[0][0], res[2][0]])
    np.testing.assert_allclose(logits, m_logits, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(logits, jx[f"prefill|{arch}|logits"], atol=1e-5, rtol=1e-4)
    for f in _cache_fields(arch):
        got = np.concatenate([np.concatenate([getattr(res[2 * d + m][1], f) for m in (0, 1)],
                                             axis=2) for d in (0, 1)], axis=1)
        np.testing.assert_allclose(got, getattr(m_caches, f), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
@pytest.mark.parametrize("name", STRUCTS)
def test_input_structs_match_jax(runs, name, arch, mesh):
    shape, axes = MESHES[mesh]
    want = json.loads(str(runs[2]["structs"]))[f"{arch}|{mesh}"][name]
    got = json.loads(json.dumps(_port_structs(arch, dict(zip(axes, shape)))[name]))
    assert got == want


def test_make_step_builds_each_kind(runs):
    assert set(runs[0][0]["make_step"].values()) == {"train", "prefill", "decode"}
    assert all(v == k[1] for k, v in runs[0][0]["make_step"].items())


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
def test_subgrid_refuses_a_mesh_its_experts_cannot_tile(runs, kind):
    msg = runs[0][0]["refusals"][(kind, "arctic-480b")]
    assert msg is not None and "E/data*f_sub == model" in msg, msg


def test_moe_ffn_refuses_a_shard_without_the_mesh():
    from repro_torch.models import moe
    cfg = _moe_cfg("model")
    w = moe.init_moe_params(torch.Generator().manual_seed(0), cfg)
    half = {k: (v if k == "router" else v[:4]) for k, v in w.items()}
    with pytest.raises(ValueError, match="ROADMAP A16.3a"):
        moe.moe_ffn(half, torch.zeros(1, 4, cfg.d_model), cfg)


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    _jax_side(sys.argv[1])
