#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. device  — a CUDA card must be present; prints its name, count and power
   limit, and the TF32 flags the entry points set.
2. build   — compiles every kernel under ``src/repro_torch/csrc/`` with nvcc
   (all at once) into ``build/repro_torch/``; prints the build seconds and
   the compiler's register/spill report.
3. kernels — each kernel against its plain PyTorch version on the card,
   bitwise, at the shapes the main path and the aggregation benchmark use,
   plus a ragged tail and a single client; times both with CUDA events
   (L2 flushed before every launch) beside the memory-traffic bound: device
   time with the host queued ahead, and the kernel's time per call with
   the host's launch overhead in it.
4. main path — the FL round loop at the full width of flsim-cnn through
   ``load_job`` -> ``Executor(...).scaffold().run()``, once with fedavg and
   once with int8 compression; losses finite and falling, the int8 kernel
   launched once per round on the int8 job and never on the fedavg job.
   Then one int8 round on the card against the same round on the CPU.
5. determinism — the int8 job again with one round per launch: bitwise the
   losses and params of the 3+3 chunking. Then one warm int8 round under
   ``torch.profiler``: device time by kernel and the device's idle share.
6. summary — a ``kernels`` JSON line, a ``slice`` line, the card's
   ``name, power.limit`` line, and last the ``ok`` JSON line.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, at the 700 W limit
F32_FLOPS_PER_S = 67e12        # H100 SXM data sheet, f32 outside tensor cores
KERNEL_SHAPES = [(100, 189_952, 256),     # main path: C=100 clients, flsim-cnn packed
                 (16, 1_048_576, 256),    # BENCH_agg shape
                 (7, 4_224, 128),         # ragged tail
                 (1, 189_952, 256)]       # single client
MAIN_JOB = {
    "name": "chip_smoke",
    "model": {"arch": "flsim-cnn"},              # config width: d_model 64, d_ff 128
    "dataset": {"dataset": "synthetic_vision", "n_items": 50_000,
                "distribution": {"partition": "dirichlet",
                                 "dirichlet_alpha": 0.5}},
    "strategy": {"strategy": "fedavg",
                 "train_params": {"n_clients": 100, "cohort": 20,
                                  "local_steps": 5, "batch_size": 32,
                                  "client_lr": 0.05, "rounds": 6,
                                  "rounds_per_launch": 3, "seed": 0}},
    "runtime": {"straggler_prob": 0.1, "straggler_overprovision": 1.25},
}


def log(*a):
    """Print and flush, so a cut run keeps what it printed."""
    print(*a, flush=True)


def job_dict(strategy: str, compression: str, rounds_per_launch: int) -> dict:
    """The main-path job with one strategy, compression and chunking."""
    raw = json.loads(json.dumps(MAIN_JOB))
    raw["strategy"]["strategy"] = strategy
    tp = raw["strategy"]["train_params"]
    tp["compression"] = compression
    tp["rounds_per_launch"] = rounds_per_launch
    return raw


def agg_inputs(C, N, qblock, seed, device):
    """Random int8 deltas, block scales and normalized client weights."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    q = torch.randint(-127, 128, (C, N), generator=g, device=device,
                      dtype=torch.int8)
    s = torch.rand((C, N // qblock), generator=g, device=device) * (1e-2 - 1e-4) + 1e-4
    w = torch.rand((C,), generator=g, device=device)
    return q, s, w / w.sum()


def _events(n):
    import torch
    return [(torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True)) for _ in range(n)]


def _median(pairs) -> float:
    import torch
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in pairs)
    return ms[len(ms) // 2]


def time_call(fn, args, iters: int, flush) -> float:
    """Median ms per call as the caller sees it: each launch timed alone
    with CUDA events after overwriting a buffer larger than L2. The device
    idles while the host enqueues the call, so this includes the host's
    launch overhead."""
    for _ in range(5):
        fn(*args)
    pairs = _events(iters)
    for t0, t1 in pairs:
        flush.zero_()
        t0.record()
        fn(*args)
        t1.record()
    return _median(pairs)


def time_device(fn, args, iters: int, flush, batch: int = 20) -> float:
    """Median device ms per call: as ``time_call``, but each batch of calls
    is queued behind a device-side sleep long enough for the host to
    enqueue the whole batch, so the events bracket device work only."""
    import torch
    for _ in range(5):
        fn(*args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
    (s0, s1), = _events(1)
    s0.record()
    torch.cuda._sleep(10_000_000)
    s1.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10_000_000 / s0.elapsed_time(s1)
    pairs = []
    for _ in range(0, iters, batch):
        torch.cuda._sleep(int(cycles_per_ms * (2 * batch * host_ms + 1)))
        for t0, t1 in _events(batch):
            flush.zero_()
            t0.record()
            fn(*args)
            t1.record()
            pairs.append((t0, t1))
    return _median(pairs)


def phase_kernels(torch, qa):
    """Kernel vs plain version, bitwise, and both timed, at every shape."""
    dev = torch.device("cuda")
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    rows = []
    for i, (C, N, qblock) in enumerate(KERNEL_SHAPES):
        q, s, w = agg_inputs(C, N, qblock, seed=i, device=dev)
        got = qa.quant_aggregate(q, s, w)
        want = qa.plain(q, s, w)
        torch.cuda.synchronize()
        if got.shape != (N,) or not torch.isfinite(got).all():
            raise AssertionError(f"quant_aggregate {C}x{N}: bad output")
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"quant_aggregate {C}x{N}/{qblock}: not bitwise "
                                 f"equal to its plain version (max |diff| {err})")
        nbytes = C * N + 4 * C * (N // qblock) + 4 * C + 4 * N
        flops = 3 * C * N
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S
                    else "operations")
        kernel_ms = time_device(qa.quant_aggregate, (q, s, w), 200, flush)
        plain_ms = time_device(qa.plain, (q, s, w), 100, flush, batch=5)
        call_ms = time_call(qa.quant_aggregate, (q, s, w), 200, flush)
        row = {"C": C, "N": N, "qblock": qblock, "bitwise": True,
               "max_abs_err": err, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "kernel_call_ms": call_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
               "library_ms": None}
        log("kernel quant_aggregate", json.dumps(row))
        rows.append(row)
    return rows


def run_job(torch, qa, load_job, Executor, strategy, compression, rpl):
    """One main-path job through the entry points; checks its losses."""
    job = load_job(job_dict(strategy, compression, rpl))
    torch.cuda.reset_peak_memory_stats()
    before = qa.quant_aggregate.launches
    t0 = time.perf_counter()
    ex = Executor(job).scaffold()
    scaffold_s = time.perf_counter() - t0
    state, logger = ex.run()
    launches = qa.quant_aggregate.launches - before
    losses = [r["loss"] for r in logger.rows]
    out = {"strategy": strategy, "compression": compression,
           "rounds_per_launch": rpl, "losses": losses,
           "round_s": [r["round_s"] for r in logger.rows],
           "scaffold_s": scaffold_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "agg_launches": launches}
    log("job", json.dumps(out))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{strategy}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{strategy}: loss did not fall {losses}")
    params = {k: v.detach().clone() for k, v in state["params"].items()}
    del ex, state
    torch.cuda.empty_cache()
    return out, params


def phase_card_vs_cpu(torch):
    """One int8 round of the port on the card against the same round on
    the CPU, from the same numpy weights, batches and client weights."""
    import numpy as np
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.rounds import build_spatial_round, init_state
    from repro_torch.core.strategies import get_strategy
    from repro_torch.models import model_zoo

    fl = FLConfig(strategy="compressed", compression="int8", n_clients=8,
                  local_steps=2, client_lr=0.05)
    model = model_zoo.build("flsim-cnn")
    strategy = get_strategy(fl)
    rng = np.random.RandomState(7)
    x = rng.randn(8, 2, 16, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, (8, 2, 16))
    w = rng.rand(8).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        state = init_state(model, strategy, fl, 123, 8, device=dev)
        batch = {"x": torch.tensor(x, device=dev), "y": torch.tensor(y, device=dev)}
        new, m = build_spatial_round(model, strategy, fl)(
            state, batch, torch.tensor(w, device=dev), 0)
        out[dev] = (m["loss"].item(), {k: v.cpu() for k, v in new["params"].items()})
    dl = abs(out["cuda"][0] - out["cpu"][0])
    dp = max((out["cuda"][1][k] - out["cpu"][1][k]).abs().max().item()
             for k in out["cpu"][1])
    log(f"card vs cpu, one int8 round: |dloss| {dl:.3e}  max |dparam| {dp:.3e}")
    # tolerance: f32 convs/matmuls sum in another order on the card (~1e-6
    # relative); a delta that lands on an int8 rounding boundary can move by
    # one quantum (amax/127 of its block, ~1e-5 here) -> 1e-4 on params
    if dl > 1e-4 * abs(out["cpu"][0]) or dp > 1e-4:
        raise AssertionError(f"card and CPU rounds disagree: {dl} {dp}")
    return {"dloss": dl, "dparam": dp}


def phase_profile(torch, load_job, Executor):
    """One warm int8 round of the main path under ``torch.profiler``: device
    time by kernel name, the streams the kernels ran on, and the device's
    idle share of the round's wall time (the profiler's own host cost
    inflates the wall, so the idle share is an upper bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    raw = job_dict("compressed", "int8", 1)
    raw["strategy"]["train_params"]["rounds"] = 2
    ex = Executor(load_job(raw)).scaffold()
    ex.run(1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ex.run(2)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # busy time is the union of the kernel intervals: kernels on several
    # streams can overlap, so it can be less than the sum of kernel times
    spans = {(e.name, e.time_range.start, e.time_range.end, e.device_resource_id)
             for e in prof.events() if e.device_type == DeviceType.CUDA}
    by_name = {}
    for name, a, b, _ in spans:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (b - a) / 1e3, n + 1)
    busy_us, end = 0.0, float("-inf")
    for _, a, b, _ in sorted(spans, key=lambda sp: sp[1]):
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    busy_ms = busy_us / 1e3
    kernel_sum_ms = sum(ms for ms, _ in by_name.values())
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "kernel_sum_ms": kernel_sum_ms,
           "device_idle_share": 1 - busy_ms / wall_ms if by_name else None,
           "kernel_launches": len(spans),
           "streams": sorted({str(sp[3]) for sp in spans})}
    log("profile one int8 round", json.dumps(out))
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  {ms:9.3f} ms {100 * ms / max(kernel_sum_ms, 1e-9):5.1f}% of kernel time"
            f"  x{n:<5d} {name[:90]}")
    qa_ms, qa_n = by_name.get(next((k for k in by_name if "quant_aggregate" in k), ""),
                              (0.0, 0))
    log(f"  quant_aggregate in this round: {qa_ms:.4f} ms x{qa_n}")
    if not by_name:
        log("  the profiler saw no device time")
    del ex
    torch.cuda.empty_cache()
    return out


def main() -> int:
    """Run every phase; 0 only when all of them pass."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from repro_torch.core.jobs import load_job
    from repro_torch.kernels import build
    from repro_torch.kernels import quant_aggregate as qa
    from repro_torch.runtime.device import resolve_device
    from repro_torch.runtime.executor import Executor

    # 1. device
    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    log(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32} "
        f"cudnn.deterministic={torch.backends.cudnn.deterministic}")

    # 2. build
    t0 = time.perf_counter()
    libs = build.build(build.sources())
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f}s")
    for name in sorted(libs):
        for line in build.PTXAS.get(name, "cached build\n").splitlines():
            if "registers" in line or "spill" in line or "cached" in line:
                log(f"ptxas {name}: {line.strip()}")

    # 3. kernels vs plain versions
    rows = phase_kernels(torch, qa)

    # 4. main path; counts zeroed just before it, read just after
    qa.quant_aggregate.launches = 0
    job_a, _ = run_job(torch, qa, load_job, Executor, "fedavg", "none", 3)
    job_b, params_b = run_job(torch, qa, load_job, Executor, "compressed", "int8", 3)
    main_launches = qa.quant_aggregate.launches
    if job_a["agg_launches"] != 0:
        raise AssertionError(f"fedavg launched quant_aggregate {job_a['agg_launches']}x")
    if job_b["agg_launches"] != len(job_b["losses"]):
        raise AssertionError(f"int8 job: {job_b['agg_launches']} launches for "
                             f"{len(job_b['losses'])} rounds")
    card_cpu = phase_card_vs_cpu(torch)

    # 5. determinism: 1+1+1+1+1+1 == 3+3, bitwise
    job_c, params_c = run_job(torch, qa, load_job, Executor, "compressed", "int8", 1)
    if job_c["losses"] != job_b["losses"] or not all(
            torch.equal(params_b[k], params_c[k]) for k in params_b):
        raise AssertionError(f"chunked != unchunked: {job_b['losses']} vs "
                             f"{job_c['losses']}")
    log("determinism: rounds_per_launch 1 == 3, bitwise (losses and params)")
    phase_profile(torch, load_job, Executor)

    # 6. summary
    main = rows[0]
    log(json.dumps({"kernels": [{
        "name": "quant_aggregate", "route": "cuda",
        "source": "src/repro_torch/csrc/quant_aggregate.cu",
        "replaces": "src/repro/kernels/quant_aggregate.py:22",
        "launches": main_launches, "max_abs_err": main["max_abs_err"],
        "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "call_ms": main["kernel_call_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None, "bitwise": True,
        "shape": [main["C"], main["N"], main["qblock"]]}]}))
    log(json.dumps({"slice": "1: FL round loop (fedavg + int8 compressed) on "
                    "flsim-cnn, quant_aggregate on CUDA",
                    "card_vs_cpu": card_cpu}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
