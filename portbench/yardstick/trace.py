"""The traced sub-window: a few steps of a cell under ``torch.profiler``,
reduced to what the per-layer metrics read.

- ``busy_s``: the union of the device's kernel, copy and set intervals
  inside the window; ``window_s``: the window's length (the benchmark's
  ``portbench.trace`` span, which ends after a synchronize);
- ``kernel_s``: device seconds by kernel name;
- ``launches``: each hand-written kernel's launches by shape in the
  window, from the program's ``launches_by_shape`` counters;
- ``breakdown()``: the device operations that took most time, and the
  idle gaps summed by what the host was doing when each began (the
  innermost host span or operation open then, under the benchmark's own
  span).
"""
from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def counters() -> dict:
    """The program's launch counters of B1, B2 and B3, by kernel."""
    from repro_torch.kernels import flash_attention, quant_aggregate, rmsnorm
    return {"quant_aggregate": quant_aggregate.quant_aggregate.launches_by_shape,
            "rmsnorm": rmsnorm.rmsnorm.launches_by_shape,
            "flash_attention": flash_attention.flash_attention_fwd.launches_by_shape}


class Trace:
    """``events``: (category, name, start ns, end ns) of every profiled
    event; ``launches``: the counters' launches by kernel and shape."""

    def __init__(self, events: list, launches: dict):
        win = [e for e in events if e[1] == "portbench.trace" and e[0] == "user_annotation"]
        if not win:
            raise RuntimeError("the trace holds no portbench.trace span")
        self.t0, self.t1 = win[0][2], win[0][3]
        self.window_s = (self.t1 - self.t0) * 1e-9
        self.launches = launches
        dev = sorted((a, b, n) for c, n, a, b in events if c in DEVICE_CATS)
        self.kernel_s = {}
        for a, b, n in dev:
            self.kernel_s[n] = self.kernel_s.get(n, 0.0) + (b - a) * 1e-9
        # union of the device intervals, clipped to the window
        busy, gaps, cur = 0.0, [], self.t0
        for a, b, _ in dev:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= cur:
                continue
            if a > cur:
                gaps.append((cur, a))
            busy += b - max(a, cur)
            cur = b
        if cur < self.t1:
            gaps.append((cur, self.t1))
        self.busy_s = busy * 1e-9
        host = sorted((a, b, n) for c, n, a, b in events if c in HOST_CATS)
        self.gap_s = {}
        i, open_ = 0, []
        for a, b in gaps:              # in time order: a sweep over the host events
            while i < len(host) and host[i][0] <= a:
                open_.append(host[i])
                i += 1
            open_ = [h for h in open_ if h[1] > a]
            label = _label(open_)
            self.gap_s[label] = self.gap_s.get(label, 0.0) + (b - a) * 1e-9

    def device_s(self, *names: str) -> float:
        """Device seconds of the kernels whose name holds one of ``names``."""
        return sum(s for n, s in self.kernel_s.items() if any(k in n for k in names))

    def breakdown(self) -> dict:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gap_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in top],
                "idle_gaps": [[n[:120], s] for n, s in gaps]}


def _label(open_: list) -> str:
    """The benchmark's innermost span and the innermost host event among
    the (start, end, name) events open when a gap begins."""
    if not open_:
        return "host idle"
    ours = [h[2] for h in open_ if h[2].startswith("portbench.") and h[2] != "portbench.trace"]
    inner = max(open_, key=lambda h: h[0])[2]
    return f"{ours[-1] if ours else 'portbench.trace'}/{inner}"


def record(torch, run, steps: int, device) -> Trace:
    """``steps`` of ``run`` under the profiler, the counters zeroed before
    and read after; the window ends after a synchronize."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    ctrs = counters()
    for c in ctrs.values():
        c.clear()
    with profile(activities=acts) as prof:
        with record_function("portbench.trace"):
            for _ in range(steps):
                with record_function(f"portbench.{run.span}"):
                    run.step()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    launches = {k: dict(v) for k, v in ctrs.items()}
    # the exported trace is the profiler's stable interface (its events'
    # accessors differ between releases); written to TMPDIR and removed
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    events = [(e["cat"], e["name"], round(float(e["ts"]) * 1e3),
               round((float(e["ts"]) + float(e.get("dur", 0))) * 1e3))
              for e in raw if e.get("ph") == "X" and "cat" in e]
    del raw
    return Trace(events, launches)
