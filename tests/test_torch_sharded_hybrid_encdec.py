"""jamba's period (the Mamba cross-shard handoff and its tensor-parallel
decode), whisper-base's sequence-sharded encoder and cross decode, and
xlstm-125m's serve steps on a device mesh
(``launch/steps.make_{train,prefill,decode}_step``, reduced configs) against
the port's meshless steps and the JAX package's, at tight f32 tolerances.

The port runs on 8 ``gloo`` ranks (``launch/mesh.spawn``, once for the
file), each building a (2, 2, 2) ``("pod", "data", "model")`` mesh over all
8, a (2, 2) ``("data", "model")`` mesh and a (1, 4) one over ranks 0-3. The
JAX side runs this file as a script on 8 forced host devices
(``REPRO_KERNEL_IMPL=jnp``). Inputs are f32: params drawn by the port's
``init_params`` (carried to JAX through ``interop``), tokens and labels
over the whole vocab.

- jamba train: one FedAvg round of one local step of 8 x 32 tokens on
  (2, 2) and (2, 2, 2), the batch over ``(data, model, pod)`` with whole
  sequences. At capacity factor 4.0 with the aux weights at 0 no rank drops
  a pair and the round is the port's meshless one (loss rtol 1e-5, params
  atol 1e-5 / rtol 1e-4); at the config's capacity with the aux losses on
  it is the JAX package's meshless round with its ``moe_ffn`` applied to
  each rank's block of rows, the blocks' aux losses averaged (the function
  the JAX mesh step defines); with ``Model(quant_ring=True)`` its loss
  stays within ``quant_ring``'s bound of the plain ring's (the one
  ``tests/test_torch_sharded_mla_moe.py`` holds ``moe_ffn`` to).
- ``mamba_forward`` alone: the sequence-sharded branch (a prefill's) on
  (2, 2) and (2, 2, 2), 4 scan chunks a shard, with weights as drawn
  (the shard's decay underflows to 0) and with a small dt (the decay
  near 0.3, so the handoff moves the output), against the meshless port
  and JAX's under ``shard_map``; the tensor-parallel decode (the rank's
  channels) against JAX's ``mamba_decode(tp=True)``; within 1e-5.
- jamba, whisper-base and xlstm-125m on (2, 2): the prefill's whole-vocab
  logits and every cache leaf against the meshless prefill's, cut to the
  rank's ``cache_tree`` block; one decode step at per-row lengths that
  leave the second model shard empty in some rows (logits, written caches,
  greedy tokens) against the port's and the JAX meshless steps and the JAX
  ``shard_map`` decode; a prefill, the caches grown by
  ``steps.grow_caches``, then 3 greedy decode steps against the same chain
  meshless (tokens equal, logits within 1e-5).
- ROADMAP C12 on the JAX side (strict xfails): its mesh prefill's cross
  K/V and Mamba ``h`` are not the shapes its own ``cache_tree`` gives the
  decode.
- The input trees: ``batch_struct``, ``param_structs`` (fsdp, tp, spatial)
  and ``cache_tree`` of the three archs on both meshes against the JAX
  package's shapes and specs, but for the cross K/V's spec, which the port
  shards over ``model`` on purpose (C12).
- Refusals that remain: arctic-480b on (1, 4), whisper's decoder length
  not dividing the model axis, a Mamba channel shard with no model axis.

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
JAMBA, WHISPER, XLSTM = "jamba-1.5-large-398b", "whisper-base", "xlstm-125m"
SERVE_ARCHS = (JAMBA, WHISPER, XLSTM)
# capacity factor (None: the config's) and whether the aux losses count
VARIANTS = {"exact": (4.0, False), "own": (None, True)}
TRAIN_CELLS = [(m, v, q) for m in MESHES for v, q in (("exact", False), ("own", False),
                                                      ("exact", True))]
S, B = 32, 8                          # the steps' tokens; whisper's decoder length
FRAMES = S * 8                        # whisper's encoder length (dec_len_ratio 8)
LENGTHS = np.array([0, 3, 14, 15, 16, 20, 30, 31], np.int32)   # decode: rows' context
GROW, CHAIN = 4, 3                    # the chain: slots added after the prefill, steps
# mamba_forward alone: cell -> (sequence length, dt_bias)
MAMBA_CELLS = {"drawn": (256, 0.0), "small_dt": (128, -6.0)}
MAMBA_B = 4
MAMBA_KEYS = ("in_proj_x", "in_proj_z", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
              "A_log", "D_skip", "out_proj")
QUANT_BOUND = 0.05        # test_torch_sharded_mla_moe's: 5 % of the plain ring's largest value


def _cfg(arch, variant="exact"):
    """Reduced ``arch`` in the port; jamba at the ``VARIANTS`` entry's
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


def _shape(arch, kind):
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig(kind, FRAMES if arch == WHISPER else S, B, kind)


def _params(arch):
    """The port's init_params draw, f32, as flat numpy."""
    from repro_torch.core import determinism
    from repro_torch.models.transformer import flatten_params, init_params
    p = init_params(determinism.generator(28, "cpu"), _cfg(arch))
    return {k: v.numpy() for k, v in flatten_params(p).items()}


def _tree_map(fn, tree, path=()):
    """``fn(path, leaf)`` over dicts, lists and NamedTuples (their field
    names in the path); a ``steps.InputSpec`` is a leaf."""
    if type(tree).__name__ == "InputSpec":
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], path + (k,)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _retype(tree, types):
    """The tree with each NamedTuple rebuilt as ``types[its name]``."""
    if isinstance(tree, dict):
        return {k: _retype(v, types) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return types[type(tree).__name__](*(_retype(v, types) for v in tree))
    if isinstance(tree, list):
        return [_retype(v, types) for v in tree]
    return tree


def _leaves(tree):
    out = []
    _tree_map(lambda p, t: out.append((p, t)), tree)
    return out


def _data(arch):
    """Train tokens and labels (1, 1, B, S), the prompt (B, S) (and whisper's
    frames (B, FRAMES, D)), the decode tokens (B,) and the decode caches of
    ``cache_tree``'s global shapes: attention rows zero from each row's
    length on, the rest drawn (an sLSTM normaliser kept positive)."""
    from repro_torch.launch import steps
    cfg = _cfg(arch)
    rng = np.random.RandomState(8)
    out = {"tokens": rng.randint(0, cfg.vocab_size, (1, 1, B, S)),
           "labels": rng.randint(0, cfg.vocab_size, (1, 1, B, S)),
           "prompt": rng.randint(0, cfg.vocab_size, (B, S)),
           "step_tokens": rng.randint(0, cfg.vocab_size, (B,))}
    if arch == WHISPER:
        out["frames"] = rng.randn(B, FRAMES, cfg.d_model).astype(np.float32)
    live = np.arange(S)[None, :] < LENGTHS[:, None]
    tree = steps.cache_tree(cfg, _shape(arch, "decode"), {}, torch.float32)

    def draw(path, sp):
        a = rng.randn(*sp.shape).astype(np.float32)
        name = path[-1]
        if name in ("k", "v"):
            a = a * live[None, :, :, None, None]
        if name == "n" and path[0] == "slstm":
            a = np.abs(a) + 0.5
        return a
    out["caches"] = _tree_map(draw, tree)
    return out


def _batch(arch, d, prompt=False):
    tok = d["prompt"] if prompt else d["tokens"]
    b = {"tokens": tok, "labels": tok if prompt else d["labels"]}
    if arch == WHISPER:
        b["frames"] = d["frames"] if prompt else d["frames"][None, None]
    return b


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _port_caches(np_tree):
    from repro_torch.interop import _port_cache_types
    return _tree_map(lambda p, a: _t(a).clone(), _retype(np_tree, _port_cache_types()))


def _np_tree(t):
    return _tree_map(lambda p, x: x.detach().numpy() if isinstance(x, torch.Tensor) else x, t)


# ---------------------------------------------------------------------------
# mamba_forward alone
# ---------------------------------------------------------------------------

def _mamba_arrays(cell):
    """Global f32 inputs of a mamba cell: x (B, S, D), the weights (dt_bias
    set to the cell's), a decode token x1 (B, 1, D) and a decode state."""
    from repro_torch.models import ssm
    from repro_torch.models.transformer import init_tree
    cfg = _cfg(JAMBA)
    seq, dt_bias = MAMBA_CELLS[cell]
    d_inner, _, N, d_conv = ssm.mamba_dims(cfg)
    rng = np.random.RandomState(12)
    w = {k: v.numpy() for k, v in init_tree(torch.Generator().manual_seed(13),
                                            ssm.mamba_param_shapes(cfg)).items()}
    w["dt_bias"] = np.full_like(w["dt_bias"], dt_bias)
    return {"x": rng.randn(MAMBA_B, seq, cfg.d_model).astype(np.float32),
            "x1": rng.randn(MAMBA_B, 1, cfg.d_model).astype(np.float32),
            "h": rng.randn(MAMBA_B, d_inner, N).astype(np.float32),
            "conv": rng.randn(MAMBA_B, d_conv - 1, d_inner).astype(np.float32), "w": w}


def _mamba_specs(axes):
    """{name: spec} of the mamba cells' inputs on a mesh of ``axes``: x over
    the batch axes and the sequence over ``model``; at decode the weights
    and the state's channels as the ``tp`` table shards them."""
    from repro_torch.sharding import specs
    batch = tuple(a for a in ("pod", "data") if a in axes)
    b = batch if len(batch) > 1 else batch[0]
    out = {"x": (b, "model", None), "x1": (b, None, None), "h": (b, "model", None),
           "conv": (b, None, "model")}
    shapes = _mamba_arrays("drawn")["w"]
    for k in MAMBA_KEYS:
        sp = [None] * shapes[k].ndim
        sp[specs._TP_DIM[k]] = "model"
        out[f"w_{k}"] = tuple(sp)
    return out


def _cut(t, spec, ctx):
    """This rank's block of the global ``t`` under ``spec``."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n, i = ctx.size(entry), ctx.index(entry)
        per = t.shape[dim] // n
        t = t.narrow(dim, i * per, per)
    return t.contiguous()


def _pad_rows(t, n):
    """``t`` (B, r, d) with zero rows in front up to ``n`` rows."""
    return torch.cat([t.new_zeros((t.shape[0], n - t.shape[1], t.shape[2])), t], dim=1)


def _mamba_rank(cell, ctx, axes):
    """This rank's sequence-sharded mixer (y, h, conv; and how far y is from
    the same rows scanned from a zero state with the true conv boundary:
    the handoff's reach, at every row and at the shard's last) and its
    tensor-parallel decode step (y, h, conv)."""
    from repro_torch.models import ssm
    cfg = _cfg(JAMBA)
    a, sp = _mamba_arrays(cell), _mamba_specs(axes)
    w = {k: _t(v) for k, v in a["w"].items()}
    x = _cut(_t(a["x"]), sp["x"], ctx)
    y, st = ssm.mamba_forward(w, x, cfg, ctx=ctx)
    d_inner, _, N, d_conv = ssm.mamba_dims(cfg)
    lo = ctx.index(ctx.model) * x.shape[1]
    rows = _cut(_t(a["x"]), (sp["x"][0], None, None), ctx)[:, max(lo - d_conv + 1, 0):lo]
    prev = _pad_rows(rows @ w["in_proj_x"], d_conv - 1)
    y_ref, _ = ssm.mamba_forward(w, x, cfg, state=ssm.MambaState(
        torch.zeros(x.shape[0], d_inner, N), prev))
    wt = {k: _cut(w[k], sp[f"w_{k}"], ctx) for k in MAMBA_KEYS}
    state = ssm.MambaState(_cut(_t(a["h"]), sp["h"], ctx), _cut(_t(a["conv"]), sp["conv"], ctx))
    y1, st1 = ssm.mamba_decode(wt, _cut(_t(a["x1"]), sp["x1"], ctx), cfg, state, ctx=ctx,
                               tp=True)
    return {"y": y.numpy(), "h": st.h.numpy(), "conv": st.conv.numpy(),
            "handoff": float((y - y_ref).abs().max()),
            "handoff_last": float((y - y_ref)[:, -1].abs().max()),
            "dec_y": y1.numpy(), "dec_h": st1.h.numpy(), "dec_conv": st1.conv.numpy()}


# ---------------------------------------------------------------------------
# The port's ranks
# ---------------------------------------------------------------------------

def _train_globals(built, arch):
    state, _, _, _ = built.global_arrays(0)
    d = _data(arch)
    state = dict(state, params={k: _t(v) for k, v in _params(arch).items()})
    return state, {k: _t(v) for k, v in _batch(arch, d).items()}, \
        torch.ones(1), torch.zeros((), dtype=torch.int64)


def _serve_rank(arch, mesh):
    """This rank's prefill, one decode step over the drawn caches and the
    prefill -> grow -> CHAIN decode steps chain."""
    from repro_torch.launch import steps
    from repro_torch.models import model_zoo
    cfg = _cfg(arch)
    model = model_zoo.build(cfg)
    d = _data(arch)
    params = {k: _t(v) for k, v in _params(arch).items()}
    dec = steps.make_decode_step(cfg, _shape(arch, "decode"), mesh, dtype=torch.float32)
    p, tokens, caches, length = dec.shard(
        (params, _t(d["step_tokens"]), _port_caches(d["caches"]), _t(LENGTHS)), "cpu")
    logits, caches = dec.fn(p, tokens, caches, length)
    out = {"decode": (logits.numpy(), _np_tree(caches),
                      model.greedy_token(logits, ctx=dec.ctx).numpy())}
    pre = steps.make_prefill_step(cfg, _shape(arch, "prefill"), mesh, dtype=torch.float32)
    pp, batch = pre.shard((params, {k: _t(v) for k, v in _batch(arch, d, True).items()}), "cpu")
    caches, logits = pre.fn(pp, batch)
    out["prefill"] = (logits.numpy(), _np_tree(caches))
    caches = steps.grow_caches(caches, dec.ctx, GROW)
    length = torch.full((logits.shape[0],), S, dtype=torch.int32)
    tok, chain = model.greedy_token(logits), []
    for _ in range(CHAIN):
        lg, caches = dec.fn(p, tok, caches, length)
        tok = model.greedy_token(lg, ctx=dec.ctx)
        chain.append((lg.numpy(), tok.numpy()))
        length = length + 1
    out["chain"] = chain
    return out


def rank_body(rank, world):
    """One rank: jamba's train cells, mamba_forward alone, the three archs'
    serve steps on (2, 2), whisper's loss on (2, 2), the refusals."""
    from repro_torch.configs.base import ShapeConfig, get_config
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
    try:
        for m, variant, quant in TRAIN_CELLS:
            if rank >= meshes[m].size():
                continue
            built = steps.make_train_step(_cfg(JAMBA, variant), _shape(JAMBA, "train"),
                                          meshes[m], _fl(), dtype=torch.float32,
                                          quant_ring=quant)
            drops.clear()
            new, met = built.fn(*built.shard(_train_globals(built, JAMBA), "cpu"))
            out[(m, variant, quant)] = (met["loss"].item(), _np_tree(new["params"]),
                                        list(drops))
    finally:
        moe.moe_ffn = plain_moe
    for cell in MAMBA_CELLS:
        for m, mesh in meshes.items():
            if rank < mesh.size():
                out[("mamba", cell, m)] = _mamba_rank(cell, steps.mesh_ctx(mesh),
                                                      MESHES[m][1])
    if rank >= 4:
        return out
    mesh = meshes["dm"]
    for arch in SERVE_ARCHS:
        out[arch] = _serve_rank(arch, mesh)
    # whisper's loss with its sequences sharded over model (the spatial
    # round runs it meshless; this is the function on the mesh)
    ctx = steps.mesh_ctx(mesh)
    d = _data(WHISPER)
    blocks = {"frames": ("data", "model", None), "tokens": ("data", "model"),
              "labels": ("data", "model")}
    batch = {k: _cut(_t(v), blocks[k], ctx) for k, v in _batch(WHISPER, d, True).items()}
    from repro_torch.models.transformer import unflatten_params
    params = unflatten_params({k: _t(v) for k, v in _params(WHISPER).items()})
    out["whisper_loss"] = model_zoo.build(_cfg(WHISPER)).loss(
        params, batch, ctx=dataclasses.replace(ctx, vocab=None)).item()
    refusals = {}
    for kind, make in (("prefill", steps.make_prefill_step),
                       ("decode", steps.make_decode_step)):
        refusals[("whisper", kind)] = _refusal(make, _cfg(WHISPER),
                                               ShapeConfig(kind, 24, B, kind), mesh)
    refusals[("arctic", "train")] = _refusal(steps.make_train_step, get_config("arctic-480b"),
                                             ShapeConfig("train", S, B, "train"), line)
    out["refusals"] = refusals
    out["make_step"] = {(arch, kind): steps.make_step(arch, _shape(arch, kind), mesh).kind
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
    from repro_torch.models import model_zoo, ssm
    from repro_torch.models.transformer import FlatModel, pad_caches, unflatten_params

    out = {}
    model = model_zoo.build(_cfg(JAMBA))
    d = _data(JAMBA)
    round_fn = build_temporal_round(FlatModel(model), get_strategy(_fl()), _fl())
    new, met = round_fn({"params": {k: _t(v) for k, v in _params(JAMBA).items()},
                         "server": (), "clients": ()},
                        {k: _t(v) for k, v in _batch(JAMBA, d).items()}, torch.ones(1), 0)
    out["train"] = (met["loss"].item(), _np_tree(new["params"]))
    for arch in SERVE_ARCHS:
        model = model_zoo.build(_cfg(arch))
        d = _data(arch)
        nested = unflatten_params({k: _t(v) for k, v in _params(arch).items()})
        with torch.inference_mode():
            logits, caches = model.decode_step(nested, _t(d["step_tokens"]),
                                               _port_caches(d["caches"]), _t(LENGTHS))
            pbatch = {k: _t(v) for k, v in _batch(arch, d, True).items()}
            pcaches, plogits, _ = model.prefill(nested, pbatch)
            out[arch] = {"decode": (logits.numpy(), _np_tree(caches),
                                    model.greedy_token(logits).numpy()),
                         "prefill": (plogits.numpy(), _np_tree(pcaches))}
            caches = pad_caches(pcaches, GROW)
            length = torch.full((B,), S, dtype=torch.int32)
            tok, chain = model.greedy_token(plogits), []
            for _ in range(CHAIN):
                lg, caches = model.decode_step(nested, tok, caches, length)
                tok = model.greedy_token(lg)
                chain.append((lg.numpy(), tok.numpy()))
                length = length + 1
            out[arch]["chain"] = chain
    whisper = model_zoo.build(_cfg(WHISPER))
    d = _data(WHISPER)
    out["whisper_loss"] = whisper.loss(
        unflatten_params({k: _t(v) for k, v in _params(WHISPER).items()}),
        {k: _t(v) for k, v in _batch(WHISPER, d, True).items()}).item()
    cfg = _cfg(JAMBA)
    for cell in MAMBA_CELLS:
        a = _mamba_arrays(cell)
        w = {k: _t(v) for k, v in a["w"].items()}
        y, st = ssm.mamba_forward(w, _t(a["x"]), cfg)
        y1, st1 = ssm.mamba_decode(w, _t(a["x1"]), cfg, ssm.MambaState(_t(a["h"]),
                                                                       _t(a["conv"])))
        out[("mamba", cell)] = {"y": y.numpy(), "h": st.h.numpy(), "conv": st.conv.numpy(),
                                "dec_y": y1.numpy(), "dec_h": st1.h.numpy(),
                                "dec_conv": st1.conv.numpy()}
    return out


# ---------------------------------------------------------------------------
# The JAX side (this file as a script)
# ---------------------------------------------------------------------------

def _jax_cfg(arch, variant="exact"):
    from repro.configs.base import get_config as j_get_config
    from repro.configs.reduce import reduced_config as j_reduced
    return _variant(j_reduced(j_get_config(arch)), variant)


def _jax_types():
    from repro.models.attention import KVCache, LatentCache
    from repro.models.ssm import MambaState, MLSTMState, SLSTMState
    from repro.models.transformer import EncDecCaches
    return {t.__name__: t for t in (KVCache, LatentCache, EncDecCaches, MambaState,
                                    MLSTMState, SLSTMState)}


def _blockwise_rows(n):
    """The JAX package's ``moe_ffn`` applied to each of ``n`` contiguous
    row blocks of a meshless (B, S, D) batch (jamba's training batch over
    ``(data, model, pod)``, whole sequences), the blocks' aux losses
    averaged: the function its mesh step defines, meshless."""
    import jax.numpy as jnp

    from repro.models import moe as jmoe
    plain = jmoe.moe_ffn

    def blockwise(ctx, w, x, cfg, *, tokens_replicated=False):
        outs, auxes = [], []
        for xb in jnp.split(x, n, axis=0):
            o, a = plain(ctx, w, xb, cfg, tokens_replicated=tokens_replicated)
            outs.append(o)
            auxes.append(a)
        aux = jmoe.MoEAux(*(sum(getattr(a, f) for a in auxes) / n
                            for f in ("load_balance", "z_loss", "drop_fraction")))
        return jnp.concatenate(outs, axis=0), aux
    return plain, blockwise


def _jax_mamba(res):
    """mamba_forward's sequence-sharded branch and its tp decode under
    shard_map: every rank's outputs, stacked by rank."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.launch.mesh import make_test_mesh
    from repro.launch.steps import mesh_ctx, shard_map
    from repro.models import ssm as jssm

    cfg = _jax_cfg(JAMBA)
    for cell in MAMBA_CELLS:
        a = _mamba_arrays(cell)
        w = {k: jnp.asarray(v) for k, v in a["w"].items()}
        y, st = jax.jit(lambda w, x: jssm.mamba_forward(w, x, cfg))(w, jnp.asarray(a["x"]))
        res[f"mamba|{cell}|meshless|y"] = np.asarray(y)
        for m, (shape, axes) in MESHES.items():
            mesh = make_test_mesh(shape, axes)
            ctx = mesh_ctx(mesh)
            sp = _mamba_specs(axes)
            every = P(tuple(axes))

            def seq(w, x):
                y, st = jssm.mamba_forward(w, x, cfg, ctx=ctx)
                return {"y": y[None], "h": st.h[None], "conv": st.conv[None]}

            def dec(w, x1, h, conv):
                y, st = jssm.mamba_decode(w, x1, cfg, jssm.MambaState(h, conv), ctx=ctx,
                                          tp=True)
                return {"dec_y": y[None], "dec_h": st.h[None], "dec_conv": st.conv[None]}
            f = shard_map(seq, mesh=mesh, in_specs=({k: P() for k in w}, P(*sp["x"])),
                          out_specs=every, check_rep=False)
            g = shard_map(dec, mesh=mesh,
                          in_specs=({k: P(*sp[f"w_{k}"]) for k in w}, P(*sp["x1"]),
                                    P(*sp["h"]), P(*sp["conv"])),
                          out_specs=every, check_rep=False)
            got = dict(jax.jit(f)(w, jnp.asarray(a["x"])))
            got.update(jax.jit(g)(w, jnp.asarray(a["x1"]), jnp.asarray(a["h"]),
                                  jnp.asarray(a["conv"])))
            for k, v in got.items():
                res[f"mamba|{cell}|{m}|{k}"] = np.asarray(v)


def _jax_side(out_path):
    """This file as a script: the JAX package's jamba rounds (meshless, and
    blockwise at the config's capacity), the three archs' decode and
    prefill meshless and their decode under ``shard_map`` on (2, 2), its
    mesh prefill's cache shapes (C12), mamba_forward under ``shard_map``,
    and its input trees."""
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

    def jtree(np_tree):
        return jax.tree.map(jnp.asarray, _retype(np_tree, _jax_types()))

    d = _data(JAMBA)
    params = jax.tree.map(jnp.asarray, unflatten_params(_params(JAMBA)))
    batch = {k: jnp.asarray(v, jnp.int32) for k, v in _batch(JAMBA, d).items()}
    state = {"params": params, "server": (), "clients": ()}
    for variant, meshes in (("exact", ("any",)), ("own", tuple(MESHES))):
        cfg = _jax_cfg(JAMBA, variant)
        model = model_zoo.build(cfg)
        for m in meshes:
            n = 1 if m == "any" else int(np.prod(MESHES[m][0]))
            plain, blockwise = _blockwise_rows(n)
            jmoe.moe_ffn = plain if variant == "exact" else blockwise
            try:
                rf = build_temporal_round(model, get_strategy(fl), fl, cfg)
                new, met = jax.jit(lambda s, b, w, r: rf(ctx0, s, b, w, r))(
                    state, batch, jnp.ones((1,), jnp.float32), rng)
            finally:
                jmoe.moe_ffn = plain
            key = f"train|{variant}|{m}"
            res[f"{key}|loss"] = np.asarray(float(met["loss"]))
            for k, v in flat(new["params"]).items():
                res[f"{key}|params|{k}"] = v

    mesh = make_test_mesh(*MESHES["dm"])
    for arch in SERVE_ARCHS:
        cfg = _jax_cfg(arch)
        model = model_zoo.build(cfg)
        d = _data(arch)
        params = jax.tree.map(jnp.asarray, unflatten_params(_params(arch)))
        toks, length = jnp.asarray(d["step_tokens"], jnp.int32), jnp.asarray(LENGTHS)
        lo, new_c = jax.jit(lambda p, t, c, ln: model.decode_step(ctx0, p, t, c, ln, tp=False))(
            params, toks, jtree(d["caches"]), length)
        res[f"decode|{arch}|logits"] = np.asarray(lo)
        for path, v in _leaves(new_c):
            res[f"decode|{arch}|cache|{'/'.join(map(str, path))}"] = np.asarray(v)
        pbatch = {k: jnp.asarray(v, jnp.float32 if k == "frames" else jnp.int32)
                  for k, v in _batch(arch, d, True).items()}
        _, plogits, _ = jax.jit(lambda p, b: model.prefill(ctx0, p, b))(params, pbatch)
        res[f"prefill|{arch}|logits"] = np.asarray(plogits)
        with mesh_context(mesh):
            dec = jsteps.make_decode_step(cfg, JShape("d", FRAMES if arch == WHISPER else S, B,
                                                      "decode"), mesh)
            lo, new_c = jax.jit(dec.fn)(params, toks, jtree(d["caches"]), length)
            res[f"mesh_decode|{arch}|logits"] = np.asarray(lo)
            for path, v in _leaves(new_c):
                res[f"mesh_decode|{arch}|cache|{'/'.join(map(str, path))}"] = np.asarray(v)
            if arch != XLSTM:
                shape = JShape("p", FRAMES if arch == WHISPER else S, B, "prefill")
                pre = jsteps.make_prefill_step(cfg, shape, mesh)
                caches, _ = jax.jit(pre.fn)(params, pbatch)
                want = jsteps.cache_tree(cfg, shape, mesh)[0]
                got_want = (caches.cross_k, want.cross_k) if arch == WHISPER else \
                    (caches["mamba"][0].h, want["mamba"][0].h)
                res[f"c12|{arch}|got"] = np.asarray(got_want[0].shape)
                res[f"c12|{arch}|want"] = np.asarray(got_want[1].shape)
    _jax_mamba(res)
    res["structs"] = np.asarray(_jax_structs())
    np.savez(out_path, **res)


def _flat_structs(tree, spec_of, is_leaf):
    """{"/"-joined path: spec_of(leaf)} over dicts, lists and NamedTuples."""
    if is_leaf(tree):
        return {"": spec_of(tree)}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        for kk, vv in _flat_structs(v, spec_of, is_leaf).items():
            out[f"{k}/{kk}" if kk else str(k)] = vv
    return out


def _norm_spec(spec):
    """A spec as JSON lists, a 1-tuple entry as its name."""
    out = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            e = e[0] if len(e) == 1 else list(e)
        out.append(e)
    return out


STRUCTS = ("train", "prefill", "decode", "fsdp", "tp", "spatial", "cache")
CROSS = ("cross_k", "cross_v")


def _jax_structs():
    """The JAX package's input trees of the three reduced archs on both
    meshes, as ``_port_structs`` gives the port's, as JSON."""
    from repro.configs.base import ShapeConfig as JShape
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_test_mesh

    def spec_of(sds):
        spec = [tuple(e) if isinstance(e, (tuple, list)) else e for e in sds.sharding.spec]
        spec += [None] * (len(sds.shape) - len(spec))
        return (list(sds.shape), _norm_spec(spec))
    res = {}

    def leaf(t):
        return not isinstance(t, (dict, list)) and not hasattr(t, "_fields")
    for arch in SERVE_ARCHS:
        cfg = _jax_cfg(arch, "own")
        n = FRAMES if arch == WHISPER else S
        shapes = {kind: JShape(kind, n, B, kind) for kind in ("train", "prefill", "decode")}
        for m, (shape, axes) in MESHES.items():
            mesh = make_test_mesh(shape, axes)
            trees = {"train": jsteps.batch_struct(cfg, shapes["train"], mesh, lead=(1, 1)),
                     "prefill": jsteps.batch_struct(cfg, shapes["prefill"], mesh),
                     "decode": jsteps.batch_struct(cfg, shapes["decode"], mesh),
                     "fsdp": jsteps.param_structs(cfg, mesh, "fsdp"),
                     "tp": jsteps.param_structs(cfg, mesh, "tp"),
                     "spatial": jsteps.param_structs(cfg, mesh, "spatial"),
                     "cache": jsteps.cache_tree(cfg, shapes["decode"], mesh)[0]}
            res[f"{arch}|{m}"] = {k: _flat_structs(t, spec_of, leaf) for k, t in trees.items()}
    return json.dumps(res)


def _port_structs(arch, sizes):
    from repro_torch.launch import steps
    from repro_torch.models.transformer import unflatten_params

    cfg = _cfg(arch, "own")

    def spec_of(sp):
        return (list(sp.shape), _norm_spec(tuple(sp.spec) + (None,) * (len(sp.shape)
                                                                      - len(sp.spec))))

    def flat(tree):
        return _flat_structs(tree, spec_of, lambda t: isinstance(t, steps.InputSpec))
    return {"train": flat(steps.batch_struct(cfg, _shape(arch, "train"), sizes, lead=(1, 1))),
            "prefill": flat(steps.batch_struct(cfg, _shape(arch, "prefill"), sizes)),
            "decode": flat(steps.batch_struct(cfg, _shape(arch, "decode"), sizes)),
            **{ph: flat(unflatten_params(steps.param_structs(cfg, sizes, ph)))
               for ph in ("fsdp", "tp", "spatial")},
            "cache": flat(steps.cache_tree(cfg, _shape(arch, "decode"), sizes))}


# ---------------------------------------------------------------------------
# Fixture and helpers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks, the JAX side and the port's meshless steps."""
    from repro_torch.launch.mesh import spawn

    out = str(tmp_path_factory.mktemp("sharded_hybrid_encdec") / "jax.npz")
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


def _block_index(spec_entry, coord, shape, axes):
    """The row-major index of ``coord`` over the axes of a spec entry."""
    i = 0
    for a in (spec_entry if isinstance(spec_entry, tuple) else (spec_entry,)):
        i = i * shape[axes.index(a)] + coord[axes.index(a)]
    return i


def _place(blocks, spec, full_shape, mesh):
    """One global array from every rank's block under ``spec`` (the ranks
    that hold the same block must agree bitwise)."""
    shape, axes = MESHES[mesh]
    full = np.full(full_shape, np.nan, np.float32)
    for c, block in zip(_coords(mesh), blocks):
        idx = []
        for dim, entry in enumerate(spec):
            if entry is None:
                idx.append(slice(None))
                continue
            i, n = _block_index(entry, c, shape, axes), block.shape[dim]
            idx.append(slice(i * n, (i + 1) * n))
        region = full[tuple(idx)]
        if not np.isnan(region).all():
            np.testing.assert_array_equal(region, block, err_msg="replicas differ")
        full[tuple(idx)] = block
    assert not np.isnan(full).any()
    return full


def _assemble(ranks, mesh, key):
    """The mesh run's params as global arrays, placed by the step's specs."""
    from repro_torch.launch import steps

    shape, axes = MESHES[mesh]
    specs = steps.param_structs(_cfg(JAMBA), dict(zip(axes, shape)), "fsdp", torch.float32)
    return {k: _place([ranks[r][key][1][k] for r in range(len(_coords(mesh)))], sp.spec,
                      sp.shape, mesh) for k, sp in specs.items()}


def _close_params(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4,
                                   err_msg=f"{what}: {k}")


def _jax_params(jx, key):
    pre = f"{key}|params|"
    return {k[len(pre):]: v for k, v in jx.items() if k.startswith(pre)}


def _cache_specs(arch):
    """{path: InputSpec} of ``cache_tree`` on (2, 2)."""
    from repro_torch.launch import steps
    shape, axes = MESHES["dm"]
    tree = steps.cache_tree(_cfg(arch), _shape(arch, "decode"), dict(zip(axes, shape)),
                            torch.float32)
    return dict(_leaves(tree))


def _cut_np(a, spec, coord, mesh="dm"):
    shape, axes = MESHES[mesh]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n = a.shape[dim] // int(np.prod([shape[axes.index(x)] for x in
                                         (entry if isinstance(entry, tuple) else (entry,))]))
        i = _block_index(entry, coord, shape, axes)
        a = np.take(a, np.arange(i * n, (i + 1) * n), axis=dim)
    return a


def _gathered_logits(blocks, arch):
    """The (2, 2) ranks' logits (B/2, V_loc) placed globally: the vocab over
    ``model`` for jamba, whole (replicated over it) for the spatial archs."""
    spec = ("data", "model") if arch == JAMBA else ("data", None)
    full = (B, blocks[0].shape[1] * (2 if arch == JAMBA else 1))
    return _place(blocks, spec, full, "dm")


# ---------------------------------------------------------------------------
# Tests: jamba's train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_jamba_train_without_drops_matches_meshless(runs, mesh):
    ranks, meshless, jx = runs
    key = (mesh, "exact", False)
    n = len(_coords(mesh))
    loss = ranks[0][key][0]
    assert all(ranks[r][key][0] == loss for r in range(n))     # the grid's loss
    # every MoE FFN ran on every rank (forward and recompute), no pair dropped
    assert all(ranks[r][key][2] and max(ranks[r][key][2]) == 0.0 for r in range(n))
    params = _assemble(ranks, mesh, key)
    m_loss, m_params = meshless["train"]
    np.testing.assert_allclose(loss, m_loss, rtol=1e-5)
    np.testing.assert_allclose(loss, float(jx["train|exact|any|loss"]), rtol=1e-5)
    _close_params(params, m_params, "port meshless")
    _close_params(params, _jax_params(jx, "train|exact|any"), "JAX meshless")
    start = _params(JAMBA)
    assert all(not np.array_equal(params[k], start[k]) for k in start)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_jamba_train_at_its_capacity_is_the_jax_mesh_function(runs, mesh):
    """Per-rank capacity and the grid's mean of per-rank aux losses, at the
    config's capacity factor: the JAX package's blockwise function and its
    gradient."""
    ranks, _, jx = runs
    key = (mesh, "own", False)
    n = len(_coords(mesh))
    loss = ranks[0][key][0]
    assert all(ranks[r][key][0] == loss for r in range(n))
    want = f"train|own|{mesh}"
    np.testing.assert_allclose(loss, float(jx[f"{want}|loss"]), rtol=1e-5)
    _close_params(_assemble(ranks, mesh, key), _jax_params(jx, want), "JAX blockwise meshless")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_jamba_quant_ring_stays_near_the_plain_ring(runs, mesh):
    """``Model(quant_ring=True)`` reaches the period's MoE FFNs: the int8
    ring moves the round, and its loss stays within moe_ffn's bound (5 % of
    the plain ring's; 5.1e-5 of it measured on (2, 2)). The updates are
    not held near the plain ring's: the int8 rounding has no gradient in
    either package (``jnp.round``'s derivative is 0, and so is
    ``torch.round``'s), so only the scales carry the ring's gradient."""
    ranks, _, _ = runs
    q, p = ranks[0][(mesh, "exact", True)][0], ranks[0][(mesh, "exact", False)][0]
    assert q != p and abs(q - p) <= QUANT_BOUND * abs(p)
    qp = _assemble(ranks, mesh, (mesh, "exact", True))
    pp = _assemble(ranks, mesh, (mesh, "exact", False))
    assert any(not np.array_equal(qp[k], pp[k]) for k in pp)
    assert all(np.isfinite(v).all() for v in qp.values())


# ---------------------------------------------------------------------------
# Tests: mamba_forward alone
# ---------------------------------------------------------------------------

def _mamba_view(ranks, cell, mesh, f, spec, full):
    return _place([ranks[r][("mamba", cell, mesh)][f] for r in range(len(_coords(mesh)))],
                  spec, full, mesh)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("cell", sorted(MAMBA_CELLS))
def test_mamba_sequence_sharded_matches_meshless_and_jax(runs, cell, mesh):
    ranks, meshless, jx = runs
    shape, axes = MESHES[mesh]
    sp = _mamba_specs(axes)
    want = meshless[("mamba", cell)]
    y = _mamba_view(ranks, cell, mesh, "y", sp["x"], want["y"].shape)
    np.testing.assert_allclose(y, want["y"], atol=1e-5, rtol=1e-5, err_msg="port meshless")
    np.testing.assert_allclose(y, jx[f"mamba|{cell}|meshless|y"], atol=1e-5, rtol=1e-5)
    # h: the global final state on every rank; conv: the rank's own rows
    b = sp["x"][0]
    h = _mamba_view(ranks, cell, mesh, "h", (b, None, None), want["h"].shape)
    np.testing.assert_allclose(h, want["h"], atol=1e-5, rtol=1e-5)
    for r, c in enumerate(_coords(mesh)):
        got = ranks[r][("mamba", cell, mesh)]
        for f in ("y", "h", "conv"):
            np.testing.assert_allclose(got[f], jx[f"mamba|{cell}|{mesh}|{f}"][r], atol=1e-5,
                                       rtol=1e-5, err_msg=f"JAX shard_map rank {r} {f}")
        if c[axes.index("model")] == shape[axes.index("model")] - 1:
            np.testing.assert_allclose(got["conv"], _cut_np(want["conv"], (b, None, None), c,
                                                            mesh), atol=1e-6, rtol=1e-6)
        assert np.isfinite(got["y"]).all() and np.isfinite(got["h"]).all()


def test_mamba_handoff_reaches_the_second_shard_as_far_as_its_decay(runs):
    """The second shard's start state reaches its rows (the handoff's
    correction is not ~0 at its first rows, in both cells); with the drawn
    weights the decay over the shard has underflowed, so nothing of it is
    left at the shard's last row, and with a small dt it still is. The
    first shard is its scan from zero, exactly."""
    ranks, _, _ = runs
    for mesh in MESHES:
        axes = MESHES[mesh][1]
        for r, c in enumerate(_coords(mesh)):
            small, drawn = (ranks[r][("mamba", cell, mesh)] for cell in ("small_dt", "drawn"))
            if c[axes.index("model")] == 0:
                assert small["handoff"] == drawn["handoff"] == 0.0, (mesh, r)
                continue
            assert small["handoff"] > 1e-3 and drawn["handoff"] > 1e-3, (mesh, r)
            assert drawn["handoff_last"] < 1e-7 < 1e-4 < small["handoff_last"], \
                (mesh, r, drawn["handoff_last"], small["handoff_last"])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mamba_tensor_parallel_decode_matches_jax(runs, mesh):
    ranks, meshless, jx = runs
    sp = _mamba_specs(MESHES[mesh][1])
    cell = "drawn"
    want = meshless[("mamba", cell)]
    for f, spec in (("dec_y", sp["x1"]), ("dec_h", sp["h"]), ("dec_conv", sp["conv"])):
        got = _mamba_view(ranks, cell, mesh, f, spec, want[f].shape)
        np.testing.assert_allclose(got, want[f], atol=1e-5, rtol=1e-5, err_msg=f)
    for r in range(len(_coords(mesh))):
        for f in ("dec_y", "dec_h", "dec_conv"):
            np.testing.assert_allclose(ranks[r][("mamba", cell, mesh)][f],
                                       jx[f"mamba|{cell}|{mesh}|{f}"][r], atol=1e-5, rtol=1e-5,
                                       err_msg=f"JAX shard_map rank {r} {f}")


# ---------------------------------------------------------------------------
# Tests: the serve steps on (2, 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_gives_the_whole_vocab_and_the_decode_layout(runs, arch):
    ranks, meshless, jx = runs
    m_logits, m_caches = meshless[arch]["prefill"]
    V = _cfg(arch).padded_vocab
    for r in range(4):
        assert ranks[r][arch]["prefill"][0].shape == (B // 2, V)
        np.testing.assert_array_equal(ranks[r][arch]["prefill"][0],
                                      ranks[r ^ 1][arch]["prefill"][0])
    logits = np.concatenate([ranks[0][arch]["prefill"][0], ranks[2][arch]["prefill"][0]])
    np.testing.assert_allclose(logits, m_logits, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(logits, jx[f"prefill|{arch}|logits"], atol=1e-5, rtol=1e-4)
    specs = _cache_specs(arch)
    want = dict(_leaves(m_caches))
    for r, c in enumerate(_coords("dm")):
        got = dict(_leaves(ranks[r][arch]["prefill"][1]))
        assert sorted(got) == sorted(specs)
        for path, sp in specs.items():
            block = _cut_np(want[path], sp.spec, c)
            assert got[path].shape == block.shape, path
            np.testing.assert_allclose(got[path], block, atol=1e-5, rtol=1e-4,
                                       err_msg=f"rank {r} {path}")


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_decode_step_matches_meshless_and_jax(runs, arch):
    ranks, meshless, jx = runs
    logits = _gathered_logits([ranks[r][arch]["decode"][0] for r in range(4)], arch)
    m_logits, m_caches, m_tokens = meshless[arch]["decode"]
    for want, what in ((m_logits, "port meshless"), (jx[f"decode|{arch}|logits"], "JAX meshless"),
                       (jx[f"mesh_decode|{arch}|logits"], "JAX shard_map")):
        np.testing.assert_allclose(logits, want, atol=1e-5, rtol=1e-4, err_msg=what)
    specs = _cache_specs(arch)
    for path, sp in specs.items():
        got = _place([dict(_leaves(ranks[r][arch]["decode"][1]))[path] for r in range(4)],
                     sp.spec, sp.shape, "dm")
        key = "/".join(map(str, path))
        for want, what in ((dict(_leaves(m_caches))[path], "port meshless"),
                           (jx[f"decode|{arch}|cache|{key}"], "JAX meshless"),
                           (jx[f"mesh_decode|{arch}|cache|{key}"], "JAX shard_map")):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4, err_msg=f"{what} {key}")
    tokens = np.concatenate([ranks[2 * d][arch]["decode"][2] for d in (0, 1)])
    for d in (0, 1):
        np.testing.assert_array_equal(ranks[2 * d][arch]["decode"][2],
                                      ranks[2 * d + 1][arch]["decode"][2])
    np.testing.assert_array_equal(tokens, m_tokens)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_then_decode_chain_matches_meshless(runs, arch):
    """A prefill on (2, 2), its caches grown by ``steps.grow_caches``, then
    3 greedy decode steps: meshless's tokens, logits within 1e-5."""
    ranks, meshless, _ = runs
    want = meshless[arch]["chain"]
    for step in range(CHAIN):
        logits = _gathered_logits([ranks[r][arch]["chain"][step][0] for r in range(4)], arch)
        np.testing.assert_allclose(logits, want[step][0], atol=1e-5, rtol=1e-5,
                                   err_msg=f"step {step}")
        tokens = np.concatenate([ranks[2 * d][arch]["chain"][step][1] for d in (0, 1)])
        np.testing.assert_array_equal(tokens, want[step][1])


def test_whisper_loss_with_sharded_sequences_is_the_meshless_loss(runs):
    ranks, meshless, _ = runs
    assert all(ranks[r]["whisper_loss"] == ranks[0]["whisper_loss"] for r in range(4))
    np.testing.assert_allclose(ranks[0]["whisper_loss"], meshless["whisper_loss"], rtol=1e-5)


@pytest.mark.xfail(strict=True, reason="ROADMAP C12: the JAX package's mesh prefill returns "
                                       "each rank's slice of the cross K/V, which its "
                                       "cache_tree replicates over model")
def test_c12_jax_mesh_prefill_cross_cache_is_its_cache_tree(runs):
    _, _, jx = runs
    np.testing.assert_array_equal(jx[f"c12|{WHISPER}|got"], jx[f"c12|{WHISPER}|want"])


@pytest.mark.xfail(strict=True, reason="ROADMAP C12: the JAX package's mesh prefill holds the "
                                       "whole d_inner of a Mamba state, which its cache_tree "
                                       "shards over model")
def test_c12_jax_mesh_prefill_mamba_state_is_its_cache_tree(runs):
    _, _, jx = runs
    np.testing.assert_array_equal(jx[f"c12|{JAMBA}|got"], jx[f"c12|{JAMBA}|want"])


# ---------------------------------------------------------------------------
# Tests: the input trees and the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", SERVE_ARCHS)
@pytest.mark.parametrize("name", STRUCTS)
def test_input_structs_match_jax(runs, name, arch, mesh):
    shape, axes = MESHES[mesh]
    want = json.loads(str(runs[2]["structs"]))[f"{arch}|{mesh}"][name]
    got = json.loads(json.dumps(_port_structs(arch, dict(zip(axes, shape)))[name]))
    if name == "cache" and arch == WHISPER:
        for k in CROSS:            # the deliberate difference (C12), asserted below
            got.pop(k), want.pop(k)
    assert got == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cross_cache_is_sequence_sharded_where_jax_replicates_it(runs, mesh):
    """C12: the port shards the cross K/V's encoder rows over ``model`` (the
    layout its decode's combine reads and its prefill writes); the JAX
    package's ``cache_tree`` replicates them."""
    shape, axes = MESHES[mesh]
    want = json.loads(str(runs[2]["structs"]))[f"{WHISPER}|{mesh}"]["cache"]
    got = _port_structs(WHISPER, dict(zip(axes, shape)))["cache"]
    for k in CROSS:
        assert got[k][0] == want[k][0]
        assert got[k][1][2] == "model" and want[k][1][2] is None
        assert got[k][1][:2] == want[k][1][:2] and got[k][1][3:] == want[k][1][3:]


def test_make_step_builds_each_kind(runs):
    got = runs[0][0]["make_step"]
    assert len(got) == 3 * len(SERVE_ARCHS) and all(v == k[1] for k, v in got.items())


@pytest.mark.parametrize("kind", ("prefill", "decode"))
def test_whisper_refuses_a_decoder_length_the_model_axis_does_not_divide(runs, kind):
    msg = runs[0][0]["refusals"][("whisper", kind)]
    assert msg is not None and "3 rows" in msg and "'model'" in msg, msg


def test_subgrid_still_refuses_a_mesh_its_experts_cannot_tile(runs):
    msg = runs[0][0]["refusals"][("arctic", "train")]
    assert msg is not None and "E/data*f_sub == model" in msg, msg


@pytest.mark.parametrize("tp", [False, True], ids=["plain", "tp"])
def test_mamba_refuses_a_channel_shard_without_a_model_axis(tp):
    from repro_torch.models import ssm
    cfg = _cfg(JAMBA)
    w = {k: _t(v) for k, v in _mamba_arrays("drawn")["w"].items()}
    half = dict(w, in_proj_x=w["in_proj_x"][:, :64])
    with pytest.raises(ValueError, match="tp=True"):
        ssm.mamba_forward(half, torch.zeros(1, 4, cfg.d_model), cfg, tp=tp)


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    _jax_side(sys.argv[1])
