"""The temporal placement's steps on several ranks, one card each (NCCL),
against their meshless twins on rank 0's card.

    python3 tools/mesh_ranks.py [--ranks 4] [--device cuda|cpu] [--reduced]
                                [--arch yi-34b|minicpm3-4b|qwen3-moe-30b-a3b]

``chip_smoke.py`` runs the mesh steps at world 1 (bitwise meshless); this
runs them where the collectives really cross ranks, for ``--arch`` (dense
GQA yi-34b by default; minicpm3-4b's MLA with tied embeddings; the MoE
qwen3-moe-30b-a3b, whose experts' all-to-alls cross the cards):

1. exact: the reduced arch in f32 on a ``(ranks // 2, 2)`` ``("data",
   "model")`` mesh (sequence over ``model``): the temporal train step (one
   FedAvg round, one local step of 8 x 32 tokens over the whole vocab), a
   prefill, and a decode step over a 32-slot cache at per-row lengths that
   leave shards empty. Every rank runs the meshless steps on its own card
   too and holds its shards to their blocks: loss rtol 1e-5, params and
   logits atol 1e-5 / rtol 1e-4 (``tests/test_torch_sharded_equivalence.py``'s).
   An MoE arch runs at capacity factor 4.0 with its aux weights at 0, where
   no rank drops a pair and the mesh step is the meshless function (each
   rank buckets its own tokens and keeps its own aux losses, as the JAX
   package's mesh step does).
2. at width: the arch at published width in bf16 (``--reduced``: the
   reduced config, for a rehearsal on CPU ranks) on a ``(1, ranks)`` mesh
   (the sequence over every rank; qwen3-moe's 128 experts 128 / ranks a
   card): the temporal step (``LAYERS``' train depth, 2 x 2,048 tokens)
   and a prefill (its serve depth, 8 x 2,048) with 16 decode steps; step
   and prefill seconds, decode ms a step and peak memory beside the
   meshless twin's (each rank's card runs it too); the loss, the largest
   param difference and the share of param entries that differ, and the
   share of greedy tokens that agree (bf16 sums in another order, and for
   MoE each rank's capacity and aux losses: not bitwise).

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

EXACT = {"seq": 32, "batch": 8, "lengths": [0, 3, 14, 15, 16, 20, 30, 31]}
WIDTH = {"train_batch": 2, "seq": 2048, "serve_batch": 8, "new": 16}
ARCHS = ("yi-34b", "minicpm3-4b", "qwen3-moe-30b-a3b")
LAYERS = {"yi-34b": (4, 8), "minicpm3-4b": (8, 16),    # arch: (train, serve) depth,
          "qwen3-moe-30b-a3b": (2, 4)}                  # as chip_smoke.py's phases


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


def _cache(torch, cfg, rng, S, B, length):
    """A decode cache of ``S`` slots (a KVCache, or MLA's LatentCache),
    rows zero from their length on."""
    import numpy as np
    from repro_torch.models.attention import KVCache, LatentCache
    live = (torch.arange(S)[None, :] < length[:, None])
    if cfg.attn_type == "mla":
        dims = (cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim)
        return LatentCache(*(torch.from_numpy(rng.randn(cfg.n_layers, B, S, d)
                                              .astype(np.float32)) * live[None, :, :, None]
                             for d in dims))
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    live = live[None, :, :, None, None]
    return KVCache(torch.from_numpy(rng.randn(*shape).astype(np.float32)) * live,
                   torch.from_numpy(rng.randn(*shape).astype(np.float32)) * live)


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _global_params(torch, cfg, model, dev, dtype, seed):
    """Every param drawn on ``dev`` from a seed, flat: each rank the same."""
    from repro_torch.models.transformer import flatten_params
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return flatten_params(model.init(g, dtype=dtype)), g


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


def _exact(torch, dist, dev, mesh, arch):
    """Phase 1 on this rank; rank 0 returns its checks."""
    import numpy as np
    from repro_torch.configs.base import FLConfig, ShapeConfig
    from repro_torch.core.rounds import build_temporal_round
    from repro_torch.core.strategies import get_strategy
    from repro_torch.launch import steps
    from repro_torch.models import model_zoo
    from repro_torch.models.transformer import FlatModel, unflatten_params

    cfg = _exact_cfg(arch)
    model = model_zoo.build(cfg)
    S, B = EXACT["seq"], EXACT["batch"]
    fl = FLConfig(strategy="fedavg", local_epochs=1, client_lr=1e-2)
    params, g = _global_params(torch, cfg, model, dev, torch.float32, 26)
    tokens = torch.randint(0, cfg.vocab_size, (2, 1, 1, B, S), generator=g, device=dev)
    batch = {"tokens": tokens[0], "labels": tokens[1]}
    built = steps.make_train_step(cfg, ShapeConfig("t", S, B, "train"), mesh, fl,
                                  dtype=torch.float32)
    new, met = built.fn(*built.shard(({"params": params, "server": (), "clients": ()},
                                      batch, torch.ones(1), torch.zeros((), dtype=torch.int64)),
                                     dev))
    # decode over a cache zero from each row's length on, and a prefill
    rng = np.random.RandomState(7)
    length = torch.tensor(EXACT["lengths"], dtype=torch.int32)
    cache = _cache(torch, cfg, rng, S, B, length)
    step_tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B,)))
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S)))
    dec = steps.make_decode_step(cfg, ShapeConfig("d", S, B, "decode"), mesh, dtype=torch.float32)
    logits, _ = dec.fn(*dec.shard((params, step_tokens, cache, length), dev))
    tok = model.greedy_token(logits, ctx=dec.ctx)
    pre = steps.make_prefill_step(cfg, ShapeConfig("p", S, B, "prefill"), mesh,
                                  dtype=torch.float32)
    _, plogits = pre.fn(*pre.shard((params, {"tokens": prompt, "labels": prompt}), dev))
    # the meshless twins on this rank's card, each output cut to its block
    want, wmet = build_temporal_round(FlatModel(model), get_strategy(fl), fl)(
        {"params": params, "server": (), "clients": ()}, batch,
        torch.ones(1, device=dev), 0)
    want = built.shard(({"params": want["params"], "server": (), "clients": ()}, batch,
                        torch.ones(1), torch.zeros((), dtype=torch.int64)), dev)[0]["params"]
    nested = unflatten_params(params)
    with torch.inference_mode():
        w_logits, _ = model.decode_step(nested, step_tokens.to(dev),
                                        type(cache)(*(t.to(dev) for t in cache)),
                                        length.to(dev))
        _, w_plog, _ = model.prefill(nested, {"tokens": prompt.to(dev)})
    ctx = dec.ctx
    w_tok = _block(model.greedy_token(w_logits), ctx, {0: "data"})
    w_logits = _block(w_logits, ctx, {0: "data", 1: "model"})
    w_plog = _block(w_plog, ctx, {0: "data"})
    loss, w_loss = met["loss"].item(), wmet["loss"].item()
    res = {"loss": loss, "meshless_loss": w_loss,
           "loss_rel_diff": abs(loss - w_loss) / abs(w_loss),
           "params_max_abs_diff": _worst(dist, max((new["params"][k] - want[k]).abs().max().item()
                                                   for k in want)),
           "decode_logits_max_abs_diff": _worst(dist, (logits - w_logits).abs().max().item()),
           "prefill_logits_max_abs_diff": _worst(dist, (plogits - w_plog).abs().max().item()),
           "tokens_equal": _worst(dist, bool(torch.equal(tok, w_tok)), all)}
    ok = _worst(dist, bool(
        all(torch.allclose(new["params"][k], want[k], atol=1e-5, rtol=1e-4) for k in want)
        and torch.allclose(logits, w_logits, atol=1e-5, rtol=1e-4)
        and torch.allclose(plogits, w_plog, atol=1e-5, rtol=1e-4)), all)
    res["ok"] = bool(ok and res["loss_rel_diff"] <= 1e-5 and res["tokens_equal"])
    return res if dist.get_rank() == 0 else None


def _width(torch, dist, dev, mesh, reduced, arch):
    """Phase 2 on this rank; rank 0 returns the timings and differences."""
    from repro_torch.configs.base import FLConfig, ShapeConfig, get_config
    from repro_torch.configs.reduce import reduced_config
    from repro_torch.core.rounds import build_temporal_round
    from repro_torch.core.strategies import get_strategy
    from repro_torch.launch import steps
    from repro_torch.models import model_zoo
    from repro_torch.models.transformer import FlatModel, pad_caches, unflatten_params

    base = get_config(arch)
    if reduced:
        base = reduced_config(base)
    W = WIDTH if not reduced else dict(WIDTH, seq=32, new=4)
    S, new = W["seq"], W["new"]
    train_layers, serve_layers = LAYERS[arch]
    fl = FLConfig(strategy="fedavg", local_epochs=1, client_lr=1e-2)
    res = {}
    # the temporal train step
    cfg = base.replace(n_layers=train_layers)
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
    res["train"] = {"layers": cfg.n_layers, "batch": B, "seq": S, "loss": mesh_loss,
                    "meshless_loss": loss, "step_s": times["mesh"],
                    "meshless_step_s": times["meshless"], "peak_mem_gb_rank0": peak,
                    "params_max_abs_diff": worst, "params_share_differing": differing}
    del params, state, got, want, diff, built, shards
    # the serve steps
    cfg = base.replace(n_layers=serve_layers)
    model = model_zoo.build(cfg)
    params, g = _global_params(torch, cfg, model, dev, torch.bfloat16, 151)
    B = W["serve_batch"]
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
    pre = steps.make_prefill_step(cfg, ShapeConfig("p", S, B, "prefill"), mesh)
    dec = steps.make_decode_step(cfg, ShapeConfig("d", S + new, B, "decode"), mesh)
    pparams, pbatch = pre.shard((params, {"tokens": prompt, "labels": prompt}), dev)
    dparams = steps.BuiltStep(dec.fn, dec.inputs[:1], dec.kind, dec.ctx).shard((params,),
                                                                               dev)[0]
    ctx = dec.ctx

    def relayout(caches):
        """The prefill's sequence shards of S / M slots -> the decode's of
        (S + new) / M: a shard holds a contiguous block of positions, so
        the cache is gathered, grown and cut again."""
        whole = pad_caches(type(caches)(*(ctx.all_gather(t, "model", axis=2)
                                          for t in caches)), new)
        n = (S + new) // ctx.size("model")
        return type(caches)(*(t.narrow(2, ctx.index("model") * n, n).contiguous()
                              for t in whole))

    def serve(prefill, grow, decode, greedy_first, greedy):
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
    dist.barrier()
    mesh_run = serve(lambda: pre.fn(pparams, pbatch), relayout,
                     lambda t, c, ln: dec.fn(dparams, t, c, ln), model.greedy_token,
                     lambda lg: model.greedy_token(lg, ctx=ctx))
    del pparams, dparams
    nested = unflatten_params(params)
    with torch.inference_mode():
        plain = serve(lambda: model.prefill(nested, {"tokens": prompt})[:2],
                      lambda c: pad_caches(c, new),
                      lambda t, c, ln: model.decode_step(nested, t, c, ln),
                      model.greedy_token, model.greedy_token)
    res["serve"] = {"layers": cfg.n_layers, "batch": B, "prompt": S, "new": new,
                    "prefill_s": mesh_run[0], "meshless_prefill_s": plain[0],
                    "decode_step_ms": mesh_run[1], "meshless_decode_step_ms": plain[1],
                    "tokens_agreeing": float((mesh_run[2] == plain[2]).float().mean())}
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
