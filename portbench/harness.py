"""The benchmark's harness: it finds a cell's files by name, runs the
cell's driver through set-up, the measured window and the traced
sub-window, reads the metrics that ``BENCHMARK.json`` names for the cell,
decides ``correct`` and prints the result line.

Everything that belongs to one configuration, one cell or one metric sits
in a file of its own, found by its name:

- ``configs/<config>.json``: the configuration as it is run;
- ``workloads/<cell>.json``: the cell's configuration, driver, chips,
  traffic parameters and comparison limits;
- ``drivers/<driver>.py``: a kind of entry into the program (``setup`` ->
  a run with ``span``, ``step`` and ``check``);
- ``metrics/<metric>.py``: a reader, ``read(ctx)`` -> a number or None.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")      # top-level module names


def load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: pathlib.Path):
    """A module from a file whose name may hold dots (``idle_share.cnn``)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location("portbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(name: str) -> tuple:
    """(cell, config, driver module) of the cell ``name``."""
    cell = load_json(BENCH / "workloads" / f"{name}.json")
    cfg = load_json(BENCH / "configs" / f"{cell['config']}.json")
    return cell, cfg, load_module(BENCH / "drivers" / f"{cell['driver']}.py")


def cell_metrics(bench: dict, name: str) -> tuple:
    """(end-to-end, per-layer) metric entries that the cell reports: those
    that list it, or, without a list, every cell that reports what they
    move."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in names else [])]
    return e2e, layer


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def power_limit_w():
    """The card's power limit in W, as nvidia-smi reads it (None without)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


class Context:
    """What a metric reader reads: the cell, its configuration, the
    window's seconds and counters, the set-up seconds, the peak memory, the
    traced sub-window (``trace``: ``yardstick.trace.Trace`` or None) and
    the card's chips and power limit."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: dict, cfg: dict, driver, seed: int, seconds: float, trace: bool,
             device, t_start: float, bench: dict, name: str) -> dict:
    """One run of a cell on ``device``; returns the result dict."""
    import torch

    from portbench.yardstick import trace as tracemod

    e2e, layer = cell_metrics(bench, name)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    run = driver.setup(cell, cfg, seed, device)
    _sync(torch, device)
    setup_s = time.perf_counter() - t_start

    # the window: whole steps back to back until `seconds` have passed; it
    # closes when the last of them has ended, so every step counts
    work, steps = {}, 0
    t0 = time.perf_counter()
    while True:
        with torch.profiler.record_function(f"portbench.{run.span}"):
            for k, v in run.step().items():
                work[k] = work.get(k, 0) + v
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0

    traced = None
    if trace:
        traced = tracemod.record(torch, run, cell.get("trace_steps", 2), device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    checks = run.check()           # frees the program's state, then the reference
    del run
    gc.collect()
    ctx = Context(cell=cell, cfg=cfg, setup_s=setup_s, window_s=window_s, work=work,
                  peak_bytes=peak, trace=traced, chips=cell["chips"],
                  power_limit_w=power_limit_w() if cuda else None)
    metrics = {}
    for m in (layer if trace else e2e):
        value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = bool(checks) and all(c["limit"] is not None and math.isfinite(c["value"])
                  and c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": steps, "failed": 0, "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                      "count": cell["chips"], "memory_peak_bytes": peak,
                      "power_limit_w": ctx.power_limit_w}}
    if traced is not None:
        out["device"].update(busy_s=traced.busy_s, window_s=traced.window_s)
        out["breakdown"] = traced.breakdown()
    out["checks"] = checks
    return out


def main(argv=None, t_start: float | None = None) -> int:
    """``run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``;
    ``t_start``: the process's start on the host clock."""
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = benchmark()
    cell, cfg, driver = cell_files(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = run_cell(cell, cfg, driver, args.seed, args.seconds, bool(args.trace), device,
                   t_start, bench, args.workload)
    bad = forbidden_modules()
    if bad:
        print("portbench: the process loaded " + ", ".join(bad), file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
