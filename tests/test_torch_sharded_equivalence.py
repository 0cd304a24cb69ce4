"""The temporal placement on a device mesh for dense GQA
(``launch/steps.make_{train,prefill,decode}_step``), reduced yi-34b, against
the port's meshless steps and the JAX package's: the port of the dense group
of ``tests/sharded_eq_impl.py``, at tight f32 tolerances.

The port runs on 8 ``gloo`` ranks (``launch/mesh.spawn``, once for the
file), each building a (2, 2, 2) ``("pod", "data", "model")`` mesh over all
8 and a (2, 2) ``("data", "model")`` mesh over ranks 0-3. The JAX side runs
this file as a script on 8 forced host devices (``REPRO_KERNEL_IMPL=jnp``).
Inputs are f32: params drawn by the port's ``init_params`` (carried to JAX
through ``interop``), tokens and labels over the whole vocab (the JAX test
draws them from {0, 1}, where any row's logits give nearly the same loss).

- Train: one FedAvg round of one local step of 8 x 32 tokens on (2, 2) and
  (2, 2, 2) (sequence over ``model``) and with ``layout="dp2d"`` on (2, 2)
  (batch over ``data x model``): loss rtol 1e-5, params atol 1e-5 / rtol
  1e-4 against the port's meshless ``build_temporal_round`` and the JAX
  package's.
- Decode on (2, 2): one step over a 32-slot cache with per-row lengths
  that leave the second model shard empty in some rows; the gathered
  vocab slices' logits, the written cache and the greedy tokens against
  the port's meshless ``decode_step``, the JAX meshless one and the JAX
  ``shard_map`` decode step (same tolerances).
- Prefill on (2, 2): the (B, V) logits and the caches against meshless.
- ROADMAP C10 on the JAX side (strict xfails): the JAX mesh step's loss
  and prefill logits depart from its meshless ones at these inputs.
- The other families run on a mesh too: MLA and MoE since A16.3a
  (``tests/test_torch_sharded_mla_moe.py``), jamba, whisper-base and
  xlstm-125m since A16.3b (``tests/test_torch_sharded_hybrid_encdec.py``).
- The input trees: ``batch_struct`` (train with lead (1, 1), sequence- or
  batch-sharded, prefill, decode), ``param_structs`` (fsdp, tp) and
  ``cache_tree`` give the JAX package's shapes and specs on both meshes;
  ``make_step`` builds each kind.

This module imports no JAX at its top: the spawned ranks import it.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
ARCH = "yi-34b"
MESHES = {"dm": ((2, 2), ("data", "model")),
          "pdm": ((2, 2, 2), ("pod", "data", "model"))}
TRAIN_CELLS = (("dm", "sp"), ("pdm", "sp"), ("dm", "dp2d"))
S, B = 32, 8                         # sharded_eq_impl's check_train / check_decode
LENGTHS = np.array([0, 3, 14, 15, 16, 20, 30, 31], np.int32)   # decode: rows' context


def _cfg(arch=ARCH):
    from repro_torch.configs.base import get_config
    from repro_torch.configs.reduce import reduced_config
    return reduced_config(get_config(arch))


def _fl():
    from repro_torch.configs.base import FLConfig
    return FLConfig(strategy="fedavg", local_epochs=1, client_lr=1e-2)


def _params():
    """The port's init_params draw, f32, as flat numpy."""
    from repro_torch.core import determinism
    from repro_torch.models.transformer import flatten_params, init_params
    p = init_params(determinism.generator(26, "cpu"), _cfg())
    return {k: v.numpy() for k, v in flatten_params(p).items()}


def _data():
    """Train tokens and labels (1, 1, B, S), the prompt (B, S), the decode
    tokens (B,) and a cache of 32 slots, rows zero from their length on."""
    cfg = _cfg()
    rng = np.random.RandomState(7)
    tokens = rng.randint(0, cfg.vocab_size, (1, 1, B, S))
    labels = rng.randint(0, cfg.vocab_size, (1, 1, B, S))
    prompt = rng.randint(0, cfg.vocab_size, (B, S))
    step_tokens = rng.randint(0, cfg.vocab_size, (B,))
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    live = (np.arange(S)[None, :] < LENGTHS[:, None])[None, :, :, None, None]
    k = (rng.randn(*shape) * live).astype(np.float32)
    v = (rng.randn(*shape) * live).astype(np.float32)
    return {"tokens": tokens, "labels": labels, "prompt": prompt, "step_tokens": step_tokens,
            "k": k, "v": v}


def _shapes():
    from repro_torch.configs.base import ShapeConfig
    return {kind: ShapeConfig(kind, S, B, kind) for kind in ("train", "prefill", "decode")}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _train_globals(built):
    """The temporal step's global inputs: the test's params, tokens and
    labels, weight 1 and key 0 (the server state of FedAvg is empty)."""
    state, _, _, _ = built.global_arrays(0)
    d = _data()
    state = dict(state, params={k: _t(v) for k, v in _params().items()})
    return state, {"tokens": _t(d["tokens"]), "labels": _t(d["labels"])}, \
        torch.ones(1), torch.zeros((), dtype=torch.int64)


def _decode_globals():
    from repro_torch.models.attention import KVCache
    d = _data()
    return ({k: _t(v) for k, v in _params().items()}, _t(d["step_tokens"]),
            KVCache(_t(d["k"]).clone(), _t(d["v"]).clone()), _t(LENGTHS))


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return type(t)(*(_np_tree(v) for v in t)) if hasattr(t, "_fields") \
            else type(t)(_np_tree(v) for v in t)
    return t.detach().numpy() if isinstance(t, torch.Tensor) else t


def rank_body(rank, world):
    """One rank: the train cells, the decode and prefill steps on (2, 2)."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model_zoo

    torch.set_num_threads(1)
    meshes = {m: make_test_mesh(shape, axes, device="cpu")
              for m, (shape, axes) in MESHES.items()}
    for mesh in meshes.values():
        steps.mesh_ctx(mesh)           # every rank: the groups are world-collective
    out = {}
    shapes = _shapes()
    for m, layout in TRAIN_CELLS:
        if rank >= meshes[m].size():
            continue
        built = steps.make_train_step(_cfg(), shapes["train"], meshes[m], _fl(),
                                      dtype=torch.float32, layout=layout)
        new, met = built.fn(*built.shard(_train_globals(built), "cpu"))
        out[(m, layout)] = (met["loss"].item(), _np_tree(new["params"]))
    if rank >= 4:
        return out
    mesh = meshes["dm"]
    dec = steps.make_decode_step(_cfg(), shapes["decode"], mesh, dtype=torch.float32)
    params, tokens, caches, length = dec.shard(_decode_globals(), "cpu")
    logits, caches = dec.fn(params, tokens, caches, length)
    model = model_zoo.build(_cfg())
    out["decode"] = (logits.numpy(), _np_tree(caches),
                     model.greedy_token(logits, ctx=dec.ctx).numpy())
    pre = steps.make_prefill_step(_cfg(), shapes["prefill"], mesh, dtype=torch.float32)
    d = _data()
    params, batch = pre.shard(({k: _t(v) for k, v in _params().items()},
                               {"tokens": _t(d["prompt"]), "labels": _t(d["prompt"])}), "cpu")
    caches, logits = pre.fn(params, batch)
    out["prefill"] = (logits.numpy(), _np_tree(caches))
    out["make_step"] = {kind: steps.make_step(ARCH, shapes[kind], mesh).kind
                        for kind in ("train", "prefill", "decode")}
    return out


STRUCTS = ("train", "train_dp2d", "prefill", "decode", "fsdp", "tp", "cache")


def _port_structs(sizes):
    """The port's input trees of reduced yi-34b on a mesh of axis
    ``sizes``: {name: {flat key: (shape, spec)}}."""
    from repro_torch.launch import steps

    cfg, shapes = _cfg(), _shapes()

    def flat(tree, prefix=""):
        if isinstance(tree, steps.InputSpec):
            return {prefix: (list(tree.shape), _norm_spec(tree.spec))}
        items = tree.items() if isinstance(tree, dict) else zip(tree._fields, tree)
        out = {}
        for k, v in items:
            out.update(flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {"train": flat(steps.batch_struct(cfg, shapes["train"], sizes, lead=(1, 1))),
            "train_dp2d": flat(steps.batch_struct(cfg, shapes["train"], sizes, lead=(1, 1),
                                                  layout="dp2d")),
            "prefill": flat(steps.batch_struct(cfg, shapes["prefill"], sizes)),
            "decode": flat(steps.batch_struct(cfg, shapes["decode"], sizes)),
            "fsdp": flat(steps.param_structs(cfg, sizes, "fsdp")),
            "tp": flat(steps.param_structs(cfg, sizes, "tp")),
            "cache": flat(steps.cache_tree(cfg, shapes["decode"], sizes))}


def _norm_spec(spec):
    """A spec as JSON lists, a 1-tuple entry as its name."""
    out = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            e = e[0] if len(e) == 1 else list(e)
        out.append(e)
    return out


def _meshless():
    """The port's meshless twins: the temporal round, decode and prefill."""
    from repro_torch.core.rounds import build_temporal_round
    from repro_torch.core.strategies import get_strategy
    from repro_torch.models import model_zoo
    from repro_torch.models.transformer import FlatModel, unflatten_params

    cfg = _cfg()
    model = model_zoo.build(cfg)
    d = _data()
    params = {k: _t(v) for k, v in _params().items()}
    round_fn = build_temporal_round(FlatModel(model), get_strategy(_fl()), _fl())
    new, met = round_fn({"params": params, "server": (), "clients": ()},
                        {"tokens": _t(d["tokens"]), "labels": _t(d["labels"])},
                        torch.ones(1), 0)
    nested, tokens, caches, length = _decode_globals()
    with torch.inference_mode():
        logits, caches = model.decode_step(unflatten_params(nested), tokens, caches, length)
        pcaches, plogits, _ = model.prefill(unflatten_params(nested),
                                            {"tokens": _t(d["prompt"])})
    return {"train": (met["loss"].item(), _np_tree(new["params"])),
            "decode": (logits.numpy(), _np_tree(caches), model.greedy_token(logits).numpy()),
            "prefill": (plogits.numpy(), _np_tree(pcaches))}


def _jax_side(out_path):
    """This file as a script: the JAX package's meshless temporal round,
    decode step and prefill, its ``shard_map`` decode step on (2, 2), and
    its mesh train step and prefill (for C10)."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import FLConfig as JFL
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import get_config as j_get_config
    from repro.configs.reduce import reduced_config as j_reduced
    from repro.core.rounds import build_temporal_round
    from repro.core.strategies import get_strategy
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_test_mesh, mesh_context
    from repro.models import model_zoo
    from repro.models.attention import KVCache
    from repro.sharding.axes import AxisCtx
    from repro_torch.models.transformer import unflatten_params

    cfg = j_reduced(j_get_config(ARCH))
    model = model_zoo.build(cfg)
    fl = JFL(strategy="fedavg", local_epochs=1, client_lr=1e-2)
    params = jax.tree.map(jnp.asarray, unflatten_params(_params()))
    d = _data()
    batch = {"tokens": jnp.asarray(d["tokens"], jnp.int32),
             "labels": jnp.asarray(d["labels"], jnp.int32)}
    state = {"params": params, "server": (), "clients": ()}
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

    rf = build_temporal_round(model, get_strategy(fl), fl, cfg)
    new, met = jax.jit(lambda s, b, w, r: rf(ctx0, s, b, w, r))(
        state, batch, jnp.ones((1,), jnp.float32), rng)
    res["train|loss"] = np.asarray(float(met["loss"]))
    for k, v in flat(new["params"]).items():
        res[f"train|params|{k}"] = v
    cache = KVCache(jnp.asarray(d["k"]), jnp.asarray(d["v"]))
    toks, length = jnp.asarray(d["step_tokens"], jnp.int32), jnp.asarray(LENGTHS)
    lo, new_c = jax.jit(lambda p, t, c, ln: model.decode_step(ctx0, p, t, c, ln, tp=False))(
        params, toks, cache, length)
    res["decode|logits"] = np.asarray(lo)
    res["decode|k"], res["decode|v"] = np.asarray(new_c.k), np.asarray(new_c.v)
    _, plogits, _ = jax.jit(lambda p, b: model.prefill(ctx0, p, b))(
        params, {"tokens": jnp.asarray(d["prompt"], jnp.int32)})
    res["prefill|logits"] = np.asarray(plogits)

    mesh = make_test_mesh((2, 2), ("data", "model"))
    with mesh_context(mesh):
        dec = jsteps.make_decode_step(cfg, JShape("d", S, B, "decode"), mesh)
        lo, new_c = jax.jit(dec.fn)(params, toks, cache, length)
        res["mesh_decode|logits"] = np.asarray(lo)
        res["mesh_decode|k"] = np.asarray(new_c.k)
        tr = jsteps.make_train_step(cfg, JShape("t", S, B, "train"), mesh, fl)
        _, met = jax.jit(tr.fn)(state, batch, jnp.ones((1,), jnp.float32), rng)
        res["mesh_train|loss"] = np.asarray(float(met["loss"]))
        pre = jsteps.make_prefill_step(cfg, JShape("p", S, B, "prefill"), mesh)
        _, plogits = jax.jit(pre.fn)(params, {"tokens": jnp.asarray(d["prompt"], jnp.int32),
                                              "labels": jnp.asarray(d["prompt"], jnp.int32)})
        res["mesh_prefill|logits"] = np.asarray(plogits)
    res["structs"] = np.asarray(_jax_structs())
    np.savez(out_path, **res)


def _jax_structs():
    """The JAX package's input trees of reduced yi-34b on both meshes, as
    ``_port_structs`` gives the port's, as JSON (``REPRO_TRAIN_LAYOUT=dp2d``
    set for its dp2d batch only, in this subprocess)."""
    import json

    import jax

    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import get_config as j_get_config
    from repro.configs.reduce import reduced_config as j_reduced
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_test_mesh

    cfg = j_reduced(j_get_config(ARCH))
    shapes = {kind: JShape(kind, S, B, kind) for kind in ("train", "prefill", "decode")}

    def flat(tree):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        out = {}
        for path, sds in leaves:
            key = "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)
            spec = [tuple(e) if isinstance(e, (tuple, list)) else e for e in sds.sharding.spec]
            spec += [None] * (len(sds.shape) - len(spec))
            out[key] = (list(sds.shape), _norm_spec(spec))
        return out
    res = {}
    for m, (shape, axes) in MESHES.items():
        mesh = make_test_mesh(shape, axes)
        got = {"train": flat(jsteps.batch_struct(cfg, shapes["train"], mesh, lead=(1, 1))),
               "prefill": flat(jsteps.batch_struct(cfg, shapes["prefill"], mesh)),
               "decode": flat(jsteps.batch_struct(cfg, shapes["decode"], mesh)),
               "fsdp": flat(jsteps.param_structs(cfg, mesh, "fsdp")),
               "tp": flat(jsteps.param_structs(cfg, mesh, "tp")),
               "cache": flat(jsteps.cache_tree(cfg, shapes["decode"], mesh)[0])}
        os.environ["REPRO_TRAIN_LAYOUT"] = "dp2d"
        got["train_dp2d"] = flat(jsteps.batch_struct(cfg, shapes["train"], mesh, lead=(1, 1)))
        del os.environ["REPRO_TRAIN_LAYOUT"]
        res[m] = got
    return json.dumps(res)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks, the JAX side and the port's meshless steps."""
    from repro_torch.launch.mesh import spawn

    out = str(tmp_path_factory.mktemp("sharded_eq") / "jax.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", REPRO_KERNEL_IMPL="jnp",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
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


def _assemble(ranks, mesh, cell):
    """The mesh run's params as global arrays: each rank's shards placed by
    the step's specs (every rank must agree where the specs replicate)."""
    from repro_torch.launch import steps

    cfg, (shape, axes) = _cfg(), MESHES[mesh]
    sizes = dict(zip(axes, shape))
    specs = steps.param_structs(cfg, sizes, "fsdp", torch.float32)
    coords = list(np.ndindex(*shape))           # rank r's place on the mesh
    out = {}
    for k, sp in specs.items():
        full = np.full(sp.shape, np.nan, np.float32)
        for r, c in enumerate(coords):
            block = ranks[r][cell][1][k]
            idx = []
            for dim, entry in enumerate(sp.spec):
                if entry is None:
                    idx.append(slice(None))
                    continue
                i = c[axes.index(entry)]
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


@pytest.mark.parametrize("cell", TRAIN_CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_train_step_matches_meshless_and_jax(runs, cell):
    ranks, meshless, jx = runs
    mesh, _ = cell
    n = int(np.prod(MESHES[mesh][0]))
    loss = ranks[0][cell][0]
    assert all(ranks[r][cell][0] == loss for r in range(n))     # the grid's loss
    params = _assemble(ranks, mesh, cell)
    m_loss, m_params = meshless["train"]
    np.testing.assert_allclose(loss, m_loss, rtol=1e-5)
    np.testing.assert_allclose(loss, float(jx["train|loss"]), rtol=1e-5)
    _close_params(params, m_params, "port meshless")
    _close_params(params, {k[len("train|params|"):]: v for k, v in jx.items()
                           if k.startswith("train|params|")}, "JAX meshless")
    # the round moved every leaf
    start = _params()
    assert all(not np.array_equal(params[k], start[k]) for k in start)


def _decode_view(ranks):
    """Rank (d, m)'s logits (B/2, V/2) and cache shard placed globally."""
    logits = np.concatenate([np.concatenate([ranks[2 * d + m]["decode"][0] for m in (0, 1)],
                                            axis=1) for d in (0, 1)], axis=0)
    k = np.concatenate([np.concatenate([ranks[2 * d + m]["decode"][1].k for m in (0, 1)],
                                       axis=2) for d in (0, 1)], axis=1)
    tokens = np.concatenate([ranks[2 * d]["decode"][2] for d in (0, 1)])
    for d in (0, 1):
        np.testing.assert_array_equal(ranks[2 * d]["decode"][2], ranks[2 * d + 1]["decode"][2])
    return logits, k, tokens


def test_decode_step_matches_meshless_and_jax(runs):
    ranks, meshless, jx = runs
    logits, k, tokens = _decode_view(ranks)
    m_logits, m_caches, m_tokens = meshless["decode"]
    for want, what in ((m_logits, "port meshless"), (jx["decode|logits"], "JAX meshless"),
                       (jx["mesh_decode|logits"], "JAX shard_map")):
        np.testing.assert_allclose(logits, want, atol=1e-5, rtol=1e-4, err_msg=what)
    for want, what in ((m_caches.k, "port meshless"), (jx["decode|k"], "JAX meshless"),
                       (jx["mesh_decode|k"], "JAX shard_map")):
        np.testing.assert_allclose(k, want, atol=1e-5, rtol=1e-4, err_msg=what)
    np.testing.assert_array_equal(tokens, m_tokens)
    # the new row went to position length, in the shard that owns it
    assert (np.abs(k[:, np.arange(B), LENGTHS]).sum(axis=(0, 2, 3)) > 0).all()


def test_prefill_step_gives_the_whole_vocab_as_meshless(runs):
    ranks, meshless, jx = runs
    m_logits, m_caches = meshless["prefill"]
    V = _cfg().padded_vocab
    for r in range(4):
        assert ranks[r]["prefill"][0].shape == (B // 2, V)
        np.testing.assert_array_equal(ranks[r]["prefill"][0], ranks[r ^ 1]["prefill"][0])
    logits = np.concatenate([ranks[0]["prefill"][0], ranks[2]["prefill"][0]])
    np.testing.assert_allclose(logits, m_logits, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(logits, jx["prefill|logits"], atol=1e-5, rtol=1e-4)
    for f in ("k", "v"):
        got = np.concatenate([np.concatenate([getattr(ranks[2 * d + m]["prefill"][1], f)
                                              for m in (0, 1)], axis=2) for d in (0, 1)],
                             axis=1)
        np.testing.assert_allclose(got, getattr(m_caches, f), atol=1e-5, rtol=1e-4)


@pytest.mark.xfail(strict=True, reason="ROADMAP C10: the JAX package's mesh step mixes "
                                       "ranks' rows in its embedding and loss")
def test_c10_jax_mesh_train_loss_is_its_meshless_loss(runs):
    _, _, jx = runs
    np.testing.assert_allclose(float(jx["mesh_train|loss"]), float(jx["train|loss"]),
                               rtol=1e-5)


@pytest.mark.xfail(strict=True, reason="ROADMAP C10: the JAX package's mesh prefill keeps "
                                       "one vocab slice of the last logits")
def test_c10_jax_mesh_prefill_logits_are_its_meshless_logits(runs):
    _, _, jx = runs
    np.testing.assert_allclose(jx["mesh_prefill|logits"], jx["prefill|logits"],
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", STRUCTS)
def test_input_structs_match_jax(runs, mesh, name):
    import json

    shape, axes = MESHES[mesh]
    want = json.loads(str(runs[2]["structs"]))[mesh][name]
    got = json.loads(json.dumps(_port_structs(dict(zip(axes, shape)))[name]))
    assert got == want


def test_make_step_builds_each_kind(runs):
    assert runs[0][0]["make_step"] == {"train": "train", "prefill": "prefill",
                                       "decode": "decode"}


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    _jax_side(sys.argv[1])
