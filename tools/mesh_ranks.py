"""The mesh steps on several ranks, one card each (NCCL), against their
meshless twins on each rank's card.

    python3 tools/mesh_ranks.py [--ranks 4] [--device cuda|cpu] [--reduced]
                                [--arch ARCH]

``chip_smoke.py`` runs the mesh steps at world 1 (bitwise meshless); this
runs them where the collectives really cross ranks, for ``--arch``: dense
GQA yi-34b (the default), minicpm3-4b's MLA with tied embeddings, the MoE
qwen3-moe-30b-a3b (its experts' all-to-alls cross the cards), the hybrid
jamba-1.5-large-398b (the Mamba handoff, the grid ring), and the spatial
whisper-base and xlstm-125m (their serve steps):

1. exact: the reduced arch in f32 on a ``(ranks // 2, 2)`` ``("data",
   "model")`` mesh: a temporal arch's train step (one FedAvg round, one
   local step of 8 x 32 tokens over the whole vocab), a prefill, a decode
   step over a drawn cache at per-row lengths that leave shards empty, and
   a prefill grown by ``steps.grow_caches`` into 3 greedy decode steps.
   Every rank runs the meshless steps on its own card too and holds its
   shards to their blocks: loss rtol 1e-5, params and logits atol 1e-5 /
   rtol 1e-4 (the CPU tests'), tokens equal. An MoE arch runs at capacity
   factor 4.0 with its aux weights at 0, where no rank drops a pair and the
   mesh step is the meshless function.
2. at width: the arch at published width in bf16 (``--reduced``: the
   reduced config, for a rehearsal on CPU ranks) on a ``(1, ranks)`` mesh.
   A dense or MoE arch: the temporal step (``LAYERS``' train depth, 2 x
   2,048 tokens) and a prefill (its serve depth, 8 x 2,048) with 16 decode
   steps, beside the meshless twin on each rank's card. jamba: one whole
   period (8 sublayers; grid EP, each card a quarter of every expert's
   d_ff, ~19.3 GB) as a prefill of 8 x 2,048 and 16 decode steps (no
   meshless twin: a period's four MoE layers exceed a card; its train step
   does not fit either, ~90 GB a card with the gradient, the update and
   the gathered period), beside one card's sublayer times (the attention,
   a Mamba mixer, an MoE layer, an MLP). whisper-base (8 x 2,048 frames,
   decoder 256: 187 does not divide 4) and xlstm-125m (8 x 2,048) at full
   depth: a prefill and 16 decode steps beside meshless. The serve steps
   run twice, the second timed (the first's times printed beside:
   they pay the first uses). Seconds, decode ms a step, peak memory, and
   the share of greedy tokens that agree (bf16 sums in another order, and
   for MoE each rank's capacity: not bitwise).

Prints one JSON line per phase and exits non-zero if a check fails.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

EXACT = {"seq": 32, "batch": 8, "lengths": [0, 3, 14, 15, 16, 20, 30, 31], "grow": 4,
         "chain": 3}
WIDTH = {"train_batch": 2, "seq": 2048, "serve_batch": 8, "new": 16}
ARCHS = ("yi-34b", "minicpm3-4b", "qwen3-moe-30b-a3b", "jamba-1.5-large-398b",
         "whisper-base", "xlstm-125m")
LAYERS = {"yi-34b": (4, 8), "minicpm3-4b": (8, 16),    # arch: (train, serve) depth,
          "qwen3-moe-30b-a3b": (2, 4),                  # as chip_smoke.py's phases
          "jamba-1.5-large-398b": (None, 8)}            # one period; no train at width


def _exact_cfg(arch):
    """The reduced arch; an MoE one at capacity factor 4.0, aux weights 0."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.configs.reduce import reduced_config
    cfg = reduced_config(get_config(arch))
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=4.0,
                                                  load_balance_loss=0.0, router_z_loss=0.0))
    return cfg


def _seq(cfg, S: int) -> int:
    """A shape's ``seq_len``: the encoder's frames for encdec (``S`` decoder
    tokens), else ``S``."""
    return S * cfg.dec_len_ratio if cfg.family == "encdec" else S


def _tree_map(fn, tree):
    """``fn`` over the leaves of dicts, lists and NamedTuples (a
    ``steps.InputSpec`` is a leaf)."""
    from repro_torch.launch.steps import InputSpec
    if isinstance(tree, InputSpec) or not isinstance(tree, (dict, list, tuple)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    return type(tree)(_tree_map(fn, v) for v in tree)


def _flat(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _cache(torch, cfg, rng, S, B):
    """A global decode cache of ``cache_tree``'s shapes at ``S`` tokens:
    every leaf drawn (what lies past a row's length is never read), an
    sLSTM normaliser kept positive."""
    import numpy as np
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    tree = steps.cache_tree(cfg, ShapeConfig("d", _seq(cfg, S), B, "decode"), {}, torch.float32)

    def draw(sp):
        a = rng.randn(*sp.shape).astype(np.float32)
        return torch.from_numpy(np.abs(a) + 0.5 if sp.shape[-1] == cfg.d_model
                                and cfg.family == "ssm" else a)
    return _tree_map(draw, tree)


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _global_params(torch, cfg, model, dev, dtype, seed):
    """Every param drawn on ``dev`` from a seed, flat: each rank the same."""
    from repro_torch.models.transformer import flatten_params
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return flatten_params(model.init(g, dtype=dtype)), g


def _shard_params(torch, cfg, structs, ctx, dev, dtype, seed):
    """This rank's shard of every param of ``structs`` (``param_structs``),
    drawn at its shard's shape on ``dev`` as ``transformer.init_tree``
    draws the whole leaf (the fan-in of the whole), from a generator seeded
    by the leaf and the block: ranks holding the same block draw the same
    values. For an arch whose whole params exceed a card."""
    import math
    from repro_torch.models.transformer import init_tree
    out = {}
    for i, (key, sp) in enumerate(sorted(structs.items())):
        shape, block = list(sp.shape), 0
        for dim, entry in enumerate(sp.spec):
            if entry is not None:
                shape[dim] //= ctx.size(entry)
                block = block * ctx.size(entry) + ctx.index(entry)
        g = torch.Generator(device=dev)
        g.manual_seed(seed * 1_000_003 + i * 4_099 + block)
        *parents, name = key.split("/")
        leaf = init_tree(g, {"x": {name: tuple(shape)}} if parents else {name: tuple(shape)},
                         dtype)
        t = leaf["x"][name] if parents else leaf[name]
        fan_whole, fan_shard = (sp.shape[-2], shape[-2]) if len(shape) >= 2 else (1, 1)
        if t.is_floating_point() and fan_whole != fan_shard and name not in ("A_log",):
            t = t * math.sqrt(fan_shard / fan_whole)
        out[key] = t
    return out


def _block(t, ctx, dims):
    """This rank's block of the global ``t``: ``dims`` maps a dim to the
    axis (or axes) it is split over."""
    for dim, axis in dims.items():
        n = t.shape[dim] // ctx.size(axis)
        t = t.narrow(dim, ctx.index(axis) * n, n)
    return t


def _worst(dist, value, combine=max):
    """``combine`` of every rank's ``value`` (host objects)."""
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, value)
    return combine(every)


def _batch(cfg, tokens, g, dev, dtype):
    """A step's batch over ``tokens`` (labels the same), with an encoder-
    decoder's frames drawn from ``g`` in ``dtype``."""
    import torch
    b = {"tokens": tokens, "labels": tokens}
    if cfg.family == "encdec":
        B, S = tokens.shape
        b["frames"] = torch.randn((B, S * cfg.dec_len_ratio, cfg.d_model), generator=g,
                                  device=dev).to(dtype)
    return b


def _exact(torch, dist, dev, mesh, arch):
    """Phase 1 on this rank; rank 0 returns its checks."""
    import numpy as np
    from repro_torch.configs.base import FLConfig, ShapeConfig
    from repro_torch.core.rounds import build_temporal_round
    from repro_torch.core.strategies import get_strategy
    from repro_torch.launch import steps
    from repro_torch.models import model_zoo
    from repro_torch.models.transformer import FlatModel, pad_caches, unflatten_params
    from repro_torch.sharding import specs

    cfg = _exact_cfg(arch)
    model = model_zoo.build(cfg)
    S, B = EXACT["seq"], EXACT["batch"]
    seq = _seq(cfg, S)
    params, g = _global_params(torch, cfg, model, dev, torch.float32, 26)
    res, ok = {}, True
    if specs.placement_for(cfg) == "temporal":       # the spatial round is A16.1's
        fl = FLConfig(strategy="fedavg", local_epochs=1, client_lr=1e-2)
        tokens = torch.randint(0, cfg.vocab_size, (2, 1, 1, B, S), generator=g, device=dev)
        batch = {"tokens": tokens[0], "labels": tokens[1]}
        built = steps.make_train_step(cfg, ShapeConfig("t", S, B, "train"), mesh, fl,
                                      dtype=torch.float32)
        state = {"params": params, "server": (), "clients": ()}
        new, met = built.fn(*built.shard((state, batch, torch.ones(1),
                                          torch.zeros((), dtype=torch.int64)), dev))
        want, wmet = build_temporal_round(FlatModel(model), get_strategy(fl), fl)(
            state, batch, torch.ones(1, device=dev), 0)
        want = built.shard(({"params": want["params"], "server": (), "clients": ()}, batch,
                            torch.ones(1), torch.zeros((), dtype=torch.int64)), dev)[0]["params"]
        loss, w_loss = met["loss"].item(), wmet["loss"].item()
        res.update(loss=loss, meshless_loss=w_loss, loss_rel_diff=abs(loss - w_loss) / abs(w_loss),
                   params_max_abs_diff=_worst(dist, max(
                       (new["params"][k] - want[k]).abs().max().item() for k in want)))
        ok = res["loss_rel_diff"] <= 1e-5 and _worst(dist, bool(all(
            torch.allclose(new["params"][k], want[k], atol=1e-5, rtol=1e-4) for k in want)), all)
    # decode over a drawn cache, a prefill, and the prefill grown into a chain
    rng = np.random.RandomState(7)
    length = torch.tensor(EXACT["lengths"], dtype=torch.int32)
    cache = _cache(torch, cfg, rng, S, B)
    w_cache = _tree_map(lambda t: t.clone().to(dev), cache)   # the decode writes in place
    step_tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B,)))
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).to(dev)
    pbatch = _batch(cfg, prompt, g, dev, torch.float32)
    dec = steps.make_decode_step(cfg, ShapeConfig("d", seq, B, "decode"), mesh,
                                 dtype=torch.float32)
    dparams, dtok, dcache, dlen = dec.shard((params, step_tokens, cache, length), dev)
    logits, _ = dec.fn(dparams, dtok, dcache, dlen)
    tok = model.greedy_token(logits, ctx=dec.ctx)
    pre = steps.make_prefill_step(cfg, ShapeConfig("p", seq, B, "prefill"), mesh,
                                  dtype=torch.float32)
    caches, plogits = pre.fn(*pre.shard((params, pbatch), dev))
    ctx, E = dec.ctx, EXACT
    caches = steps.grow_caches(caches, ctx, E["grow"])
    clen = torch.full((plogits.shape[0],), S, dtype=torch.int32, device=dev)
    ctok, chain = model.greedy_token(plogits), []
    for _ in range(E["chain"]):
        lg, caches = dec.fn(dparams, ctok, caches, clen)
        ctok = model.greedy_token(lg, ctx=ctx)
        chain.append((lg, ctok))
        clen = clen + 1
    # the meshless twins on this rank's card, each output cut to its block
    nested = unflatten_params(params)
    vocab = {1: "model"} if ctx.vaxis is not None else {}
    with torch.inference_mode():
        w_logits, _ = model.decode_step(nested, step_tokens.to(dev), w_cache, length.to(dev))
        w_caches, w_plog, _ = model.prefill(nested, pbatch)
        w_caches = pad_caches(w_caches, E["grow"])
        wlen = torch.full((B,), S, dtype=torch.int32, device=dev)
        wtok, w_chain = model.greedy_token(w_plog), []
        for _ in range(E["chain"]):
            lg, w_caches = model.decode_step(nested, wtok, w_caches, wlen)
            wtok = model.greedy_token(lg)
            w_chain.append((_block(lg, ctx, {0: "data", **vocab}), _block(wtok, ctx, {0: "data"})))
            wlen = wlen + 1
    w_tok = _block(model.greedy_token(w_logits), ctx, {0: "data"})
    w_logits = _block(w_logits, ctx, {0: "data", **vocab})
    w_plog = _block(w_plog, ctx, {0: "data"})
    chain_diff = max((a[0] - b[0]).abs().max().item() for a, b in zip(chain, w_chain))
    chain_close = all(torch.allclose(a[0], b[0], atol=1e-5, rtol=1e-4)
                      for a, b in zip(chain, w_chain))
    res.update(decode_logits_max_abs_diff=_worst(dist, (logits - w_logits).abs().max().item()),
               prefill_logits_max_abs_diff=_worst(dist, (plogits - w_plog).abs().max().item()),
               chain_logits_max_abs_diff=_worst(dist, chain_diff),
               tokens_equal=_worst(dist, bool(torch.equal(tok, w_tok) and all(
                   torch.equal(a[1], b[1]) for a, b in zip(chain, w_chain))), all))
    ok = ok and _worst(dist, bool(
        torch.allclose(logits, w_logits, atol=1e-5, rtol=1e-4)
        and torch.allclose(plogits, w_plog, atol=1e-5, rtol=1e-4)
        and chain_close), all)
    res["ok"] = bool(ok and res["tokens_equal"])
    return res if dist.get_rank() == 0 else None


def _serve(torch, dev, prefill, grow, decode, greedy_first, greedy, S, new):
    """A prefill, ``grow`` of its caches, ``new`` greedy decode steps ->
    (prefill s, median decode ms, the tokens (B, new) on the host)."""
    t0 = time.perf_counter()
    caches, logits = prefill()
    _sync(torch, dev)
    prefill_s = time.perf_counter() - t0
    with torch.inference_mode():
        caches = grow(caches)
    length = torch.full((logits.shape[0],), S, dtype=torch.int32, device=dev)
    tok, toks, step_ms = greedy_first(logits), [], []
    for _ in range(new):
        toks.append(tok)
        t0 = time.perf_counter()
        logits, caches = decode(tok, caches, length)
        tok = greedy(logits)
        _sync(torch, dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        length = length + 1
    return prefill_s, sorted(step_ms)[new // 2], torch.stack(toks, 1).cpu()


def _width_train(torch, dist, dev, mesh, base, W, arch):
    """The temporal step at width beside its meshless twin."""
    from repro_torch.configs.base import FLConfig, ShapeConfig
    from repro_torch.core.rounds import build_temporal_round
    from repro_torch.core.strategies import get_strategy
    from repro_torch.launch import steps
    from repro_torch.models import model_zoo
    from repro_torch.models.transformer import FlatModel

    S = W["seq"]
    fl = FLConfig(strategy="fedavg", local_epochs=1, client_lr=1e-2)
    cfg = base.replace(n_layers=LAYERS[arch][0])
    model = model_zoo.build(cfg)
    params, g = _global_params(torch, cfg, model, dev, torch.bfloat16, 150)
    B = W["train_batch"]
    tokens = torch.randint(0, cfg.vocab_size, (2, 1, 1, B, S), generator=g, device=dev)
    batch = {"tokens": tokens[0], "labels": tokens[1]}
    state = {"params": params, "server": (), "clients": ()}
    built = steps.make_train_step(cfg, ShapeConfig("t", S, B, "train"), mesh, fl)
    shards = built.shard((state, batch, torch.ones(1), torch.zeros((), dtype=torch.int64)), dev)
    plain = build_temporal_round(FlatModel(model), get_strategy(fl), fl)
    times = {"mesh": [], "meshless": []}
    for name, fn, args in (("mesh", built.fn, shards),
                           ("meshless", plain, (state, batch, torch.ones(1, device=dev), 0))):
        for _ in range(2):                       # the first pays the first uses
            dist.barrier()
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            out, met = fn(*args)
            loss = met["loss"].item()
            _sync(torch, dev)
            times[name].append(time.perf_counter() - t0)
            if name == "mesh":
                peak = torch.cuda.max_memory_allocated(dev) / 2**30 \
                    if dev.type == "cuda" else None
        if name == "mesh":
            got, mesh_loss = out["params"], loss
        else:
            want = built.shard(({"params": out["params"], "server": (), "clients": ()}, batch,
                                torch.ones(1), torch.zeros((), dtype=torch.int64)),
                               dev)[0]["params"]
        del out
    diff = {k: (got[k].float() - want[k].float()).abs() for k in got}
    worst = _worst(dist, max(d.max().item() for d in diff.values()))
    differing = _worst(dist, (sum(int((d > 0).sum()) for d in diff.values()),
                              sum(d.numel() for d in diff.values())),
                       lambda v: sum(a for a, _ in v) / sum(b for _, b in v))
    return {"layers": cfg.n_layers, "batch": B, "seq": S, "loss": mesh_loss,
            "meshless_loss": loss, "step_s": times["mesh"],
            "meshless_step_s": times["meshless"], "peak_mem_gb_rank0": peak,
            "params_max_abs_diff": worst, "params_share_differing": differing}


def _sublayer_times(torch, dev, cfg, B, S, seed):
    """One card's times of a period's sublayers at width (bf16, after the
    RMSNorm, prefill over B x S and one decode step, no mesh): the
    attention, a Mamba mixer, an MoE FFN, an MLP. Seconds a call, warm."""
    import torch.nn.functional as F
    from repro_torch.models import attention as attn
    from repro_torch.models import moe, ssm
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.transformer import init_tree, mlp_forward, mlp_param_shapes
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    D = cfg.d_model
    w = init_tree(g, {"ln": {"w": (D,)}, "attn": attn.attn_param_shapes(cfg),
                      "mamba": ssm.mamba_param_shapes(cfg), "mlp": mlp_param_shapes(cfg),
                      "moe": moe.moe_param_shapes(cfg)}, torch.bfloat16)
    x = torch.randn((B, S, D), generator=g, device=dev).to(torch.bfloat16)
    xd = torch.randn((B, 1, D), generator=g, device=dev).to(torch.bfloat16)
    length = torch.full((B,), S, dtype=torch.int32, device=dev)
    ln, eps = w["ln"]["w"], cfg.norm_eps
    with torch.inference_mode():
        h, hd = rms_norm(x, ln, eps), rms_norm(xd, ln, eps)
        o, cache = attn.gqa_seqsharded(w["attn"], h, cfg, return_cache=True)
        cache = attn.KVCache(*(F.pad(t, (0, 0, 0, 0, 0, 1)) for t in cache))
        _, st = ssm.mamba_forward(w["mamba"], h, cfg)
        calls = {"attention_prefill": lambda: attn.gqa_seqsharded(w["attn"], h, cfg),
                 "attention_decode": lambda: attn.gqa_decode(w["attn"], hd, cache, length, cfg),
                 "mamba_prefill": lambda: ssm.mamba_forward(w["mamba"], h, cfg),
                 "mamba_decode": lambda: ssm.mamba_decode(w["mamba"], hd, cfg, st),
                 "moe_prefill": lambda: moe.moe_ffn(w["moe"], h, cfg),
                 "moe_decode": lambda: moe.moe_ffn(w["moe"], hd, cfg, tokens_replicated=True),
                 "mlp_prefill": lambda: mlp_forward(w["mlp"], h, cfg),
                 "mlp_decode": lambda: mlp_forward(w["mlp"], hd, cfg)}
        out = {}
        for name, fn in calls.items():
            fn()
            ts = []
            for _ in range(3):
                _sync(torch, dev)
                t0 = time.perf_counter()
                fn()
                _sync(torch, dev)
                ts.append(time.perf_counter() - t0)
            out[name] = sorted(ts)[1]
    del w, x, xd, cache, st
    return out


def _width(torch, dist, dev, mesh, reduced, arch):
    """Phase 2 on this rank; rank 0 returns the timings and differences."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.configs.reduce import reduced_config
    from repro_torch.launch import steps
    from repro_torch.models import model_zoo
    from repro_torch.models.transformer import pad_caches, unflatten_params

    base = get_config(arch)
    if reduced:
        base = reduced_config(base)
    W = WIDTH if not reduced else dict(WIDTH, seq=32, new=4)
    S, new = W["seq"], W["new"]
    res = {}
    train_layers, serve_layers = LAYERS.get(arch, (None, None))
    if train_layers:
        res["train"] = _width_train(torch, dist, dev, mesh, base, W, arch)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    # the serve steps: a period for jamba, full depth for the spatial archs
    cfg = base.replace(n_layers=serve_layers) if serve_layers else base
    model = model_zoo.build(cfg)
    B = W["serve_batch"]
    S_tok = S // cfg.dec_len_ratio if cfg.family == "encdec" else S
    seq = _seq(cfg, S_tok)
    pre = steps.make_prefill_step(cfg, ShapeConfig("p", seq, B, "prefill"), mesh)
    dec = steps.make_decode_step(cfg, ShapeConfig("d", seq, B, "decode"), mesh)
    ctx = dec.ctx
    whole = cfg.family != "hybrid" or reduced          # the whole params fit a card
    g = torch.Generator(device=dev)
    g.manual_seed(151)
    if whole:
        params, _ = _global_params(torch, cfg, model, dev, torch.bfloat16, 151)
        pparams = steps.BuiltStep(None, pre.inputs[:1], "p", ctx).shard((params,), dev)[0]
        dparams = steps.BuiltStep(None, dec.inputs[:1], "d", ctx).shard((params,), dev)[0]
    else:
        pparams = _shard_params(torch, cfg, pre.inputs[0], ctx, dev, torch.bfloat16, 151)
        dparams = _shard_params(torch, cfg, dec.inputs[0], ctx, dev, torch.bfloat16, 151)
    prompt = torch.randint(0, cfg.vocab_size, (B, S_tok), generator=g, device=dev)
    batch = _batch(cfg, prompt, g, dev, torch.bfloat16)
    pbatch = steps.BuiltStep(None, pre.inputs[1:], "p", ctx).shard((batch,), dev)[0]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    for _ in range(2):                                  # the first pays the first uses
        dist.barrier()
        runs.append(_serve(torch, dev, lambda: pre.fn(pparams, pbatch),
                           lambda c: steps.grow_caches(c, ctx, new),
                           lambda t, c, ln: dec.fn(dparams, t, c, ln), model.greedy_token,
                           lambda lg: model.greedy_token(lg, ctx=ctx), S_tok, new))
    mesh_run = runs[1]
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None
    res["serve"] = {"layers": cfg.n_layers, "batch": B, "prompt": S_tok, "new": new,
                    **({"frames": seq} if cfg.family == "encdec" else {}),
                    "prefill_s": mesh_run[0], "decode_step_ms": mesh_run[1],
                    "first_prefill_s": runs[0][0], "first_decode_step_ms": runs[0][1],
                    "peak_mem_gb_rank0": peak}
    del pparams, dparams
    if whole:
        nested = unflatten_params(params)
        with torch.inference_mode():
            plain = [_serve(torch, dev, lambda: model.prefill(nested, batch)[:2],
                            lambda c: pad_caches(c, new),
                            lambda t, c, ln: model.decode_step(nested, t, c, ln),
                            model.greedy_token, model.greedy_token, S_tok, new)
                     for _ in range(2)][1]
        res["serve"].update(meshless_prefill_s=plain[0], meshless_decode_step_ms=plain[1],
                            tokens_agreeing=float((mesh_run[2] == plain[2]).float().mean()))
        del params, nested
    else:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        res["serve"]["one_card_sublayer_s"] = _sublayer_times(torch, dev, base, B, S, 152)
    return res if dist.get_rank() == 0 else None


def rank_main(rank, world, device, reduced, arch="yi-34b"):
    """One rank: both phases on the ``(world // 2, 2)`` and ``(1, world)``
    meshes; rank 0 returns the results."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import mesh_ctx
    from repro_torch.runtime.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        torch.set_num_threads(2)
    square = make_test_mesh((world // 2, 2), ("data", "model"), device=device)
    line = make_test_mesh((1, world), ("data", "model"), device=device)
    for m in (square, line):
        mesh_ctx(m)                       # every rank builds every group
    out = {"exact": _exact(torch, dist, dev, square, arch)}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out.update(_width(torch, dist, dev, line, reduced, arch) or {})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (one card a rank) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="phase 2 at the reduced config (a rehearsal on CPU ranks)")
    ap.add_argument("--arch", default="yi-34b", choices=ARCHS)
    args = ap.parse_args(argv)
    import torch
    from repro_torch.launch.mesh import spawn
    if args.device == "cuda" and torch.cuda.device_count() < args.ranks:
        print(f"mesh_ranks: {args.ranks} ranks want {args.ranks} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    res = spawn(rank_main, args.ranks, args.device, args.device, args.reduced, args.arch)[0]
    res["arch"], res["ranks"], res["device"], res["seconds"] = \
        args.arch, args.ranks, args.device, time.perf_counter() - t0
    if args.device == "cuda":
        res["cards"] = [torch.cuda.get_device_name(i) for i in range(args.ranks)]
    for phase in ("exact", "train", "serve"):
        if phase in res:
            print(json.dumps({phase: res[phase]}))
    print(json.dumps({k: res[k] for k in res if k not in ("exact", "train", "serve")}))
    return 0 if res["exact"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
