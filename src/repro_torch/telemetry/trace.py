"""Chrome-trace/Perfetto export + terminal time-breakdown report (port of
``repro/telemetry/trace.py``; host Python only).

Usage (run dir = wherever the job's ``telemetry: out_dir`` streamed
``telemetry.jsonl``):

    python -m repro_torch.telemetry.trace <run_dir>            # -> trace.json
    python -m repro_torch.telemetry.trace report <run_dir>     # terminal table

``trace.json`` is Chrome trace-event JSON (the object form Perfetto's
legacy importer loads directly at https://ui.perfetto.dev): one *process*
per recorder track (``run``, ``bucket<i>``, ``plan``) so every planner
bucket / lane shard gets its own named track, complete ("X") events for
spans — same-tid time containment renders the nesting as a flame stack —
and counter ("C") tracks for staged bytes, lane occupancy (with per-shard
series under a lane mesh), host RSS/CPU, and quant-agg routing.

``export`` also merges each ``torch_profile/launch<k>.json`` capture of the
run dir (the recorder's ``profile_chunks``) into ``trace.json``, shifted
onto the recorder's axis: the meta line records the recorder's origin on
the monotonic clock and on the wall clock, and a capture's events (its
``baseTimeNanoseconds`` plus ``ts``) are measured from whichever of the
two its clock is; each of its processes becomes a ``launch<k>`` track, so
the card's kernels and the ``repro_torch.*`` layer ranges line up under the
recorder's ``launch`` spans.

``report`` collates span *self time* (duration minus enclosed children, so
nothing double-counts) into the compile/execute/stage/io breakdown the
paper's dashboard shows, plus a per-track program table. "compile" is the
launches whose jit-cache count grew during the call (their duration
includes the first execution — attribution, not a profiler). In the port a
launch's ``compile_delta`` counts the kernel libraries built or loaded
during it (``kernels/build.py``), and ``program_cost`` carries the flops
``torch.utils.flop_counter.FlopCounterMode`` counted on the first launch of
each key and no ``bytes_accessed`` (its GB column reads 0). Where the run
recorded layer spans (a ``layers`` counter per launch), ``report`` ends
with a per-layer table: by track and span, the count, device seconds, self
device seconds and share of the track's launch seconds, and the counters.
"""
from __future__ import annotations

import json
import pathlib
import sys

from repro_torch.telemetry.recorder import read_events

# span name -> report category; "launch" splits compile/execute on the
# per-span compile_delta attr, anything unlisted lands in "other"
_CATEGORY = {
    "stage_data": "stage", "build_schedule": "stage",
    "init_state": "init",
    "restore": "io", "checkpoint_save": "io", "ledger": "io", "eval": "io",
    "table_flush": "io", "parquet": "io", "scheduler": "io",
    "finish_chunk": "io", "probe_flush": "io", "comms_flush": "io",
    "digest": "io",
    "scaffold": "host", "chunk": "host",
}
_CATEGORY_ORDER = ("compile", "execute", "stage", "io", "init", "host",
                   "other")


def _span_category(ev: dict) -> str:
    if ev["name"] == "launch":
        return "compile" if ev["attrs"].get("compile_delta", 0) > 0 \
            else "execute"
    return _CATEGORY.get(ev["name"], "other")


def _self_times(spans) -> dict:
    """Span id -> duration minus the sum of its direct children (us)."""
    self_us = {ev["id"]: ev["dur_us"] for ev in spans}
    for ev in spans:
        if ev["parent"] is not None and ev["parent"] in self_us:
            self_us[ev["parent"]] -= ev["dur_us"]
    return self_us


def to_chrome_trace(events) -> dict:
    """Event dicts -> Chrome trace-event JSON (object form)."""
    tracks: list = []
    for ev in events:
        t = ev.get("track")
        if t is not None and t not in tracks:
            tracks.append(t)
    pid_of = {t: i + 1 for i, t in enumerate(tracks)}
    out = []
    for t, pid in pid_of.items():
        out.append({"ph": "M", "name": "process_name", "pid": pid,
                    "args": {"name": t}})
        out.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": 1,
                    "args": {"name": "host"}})
    for ev in events:
        if ev["kind"] == "span":
            out.append({"ph": "X", "name": ev["name"], "cat": "span",
                        "pid": pid_of[ev["track"]], "tid": 1,
                        "ts": ev["t0_us"], "dur": ev["dur_us"],
                        "args": dict(ev["attrs"], span_id=ev["id"])})
        elif ev["kind"] == "counter":
            vals = {k: v for k, v in ev["values"].items()
                    if isinstance(v, (int, float))}
            if vals:
                out.append({"ph": "C", "name": ev["name"],
                            "pid": pid_of[ev["track"]], "tid": 1,
                            "ts": ev["t_us"], "args": vals})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def profile_events(path, meta: dict, first_pid: int) -> list:
    """A ``torch.profiler`` Chrome trace's events on the recorder's axis
    (us from its origin), each of its processes renumbered from
    ``first_pid`` and named ``<file stem> <its name>``. The capture's clock
    is the one of the meta line's two origins nearest its first event;
    without them (an older file) nothing is merged."""
    if "origin_ns" not in meta or "origin_wall_ns" not in meta:
        return []
    raw = json.loads(pathlib.Path(path).read_text())
    base_ns = int(raw.get("baseTimeNanoseconds", 0))
    events = [e for e in raw.get("traceEvents", []) if "pid" in e]
    stamped = [e for e in events if e.get("ph") != "M" and "ts" in e]
    if not stamped:
        return []
    first_ns = float(stamped[0]["ts"]) * 1e3 + base_ns
    origin = min((meta["origin_ns"], meta["origin_wall_ns"]),
                 key=lambda o: abs(first_ns - o))
    shift_us = (base_ns - origin) / 1e3
    stem = pathlib.Path(path).stem
    pids: dict = {}
    out = []
    for e in events:
        e = dict(e, pid=pids.setdefault(e["pid"], first_pid + len(pids)))
        if e.get("ph") == "M":
            if e.get("name") == "process_name":
                name = e.get("args", {}).get("name", "")
                e["args"] = dict(e.get("args", {}), name=f"{stem} {name}".strip())
        elif "ts" in e:
            e["ts"] = float(e["ts"]) + shift_us
        out.append(e)
    return out


def export(run_dir, out_path=None) -> pathlib.Path:
    """``telemetry.jsonl`` under ``run_dir`` -> ``run_dir/trace.json``,
    with the run's ``torch_profile/launch<k>.json`` captures merged on the
    recorder's axis (``profile_events``)."""
    run_dir = pathlib.Path(run_dir)
    events = read_events(run_dir)
    base = run_dir if run_dir.is_dir() else run_dir.parent
    out_path = pathlib.Path(out_path) if out_path else base / "trace.json"
    doc = to_chrome_trace(events)
    meta = next((e for e in events if e.get("kind") == "meta"), {})
    first_pid = 1 + max((e["pid"] for e in doc["traceEvents"]), default=0)
    for path in sorted((base / "torch_profile").glob("launch*.json")):
        merged = profile_events(path, meta, first_pid)
        doc["traceEvents"] += merged
        first_pid += len({e["pid"] for e in merged})
    with open(out_path, "w") as f:
        json.dump(doc, f)
    return out_path


def layer_table(events) -> list:
    """The report's per-layer lines from the run's ``layers`` counters:
    by track and span, summed over launches, the count, device seconds,
    self device seconds and share of the track's launch seconds; then each
    counter's total."""
    launch_us: dict = {}
    for e in events:
        if e.get("kind") == "span" and e["name"] == "launch":
            launch_us[e["track"]] = launch_us.get(e["track"], 0) + e["dur_us"]
    rows: dict = {}
    totals: dict = {}
    for e in events:
        if e.get("kind") != "counter" or e["name"] != "layers":
            continue
        for name, t in e["values"].get("spans", {}).items():
            r = rows.setdefault((e["track"], name), [0, 0.0, 0.0])
            r[0] += t["count"]
            r[1] += t["device_s"]
            r[2] += t["self_device_s"]
        for name, n in e["values"].get("counters", {}).items():
            totals[name] = totals.get(name, 0) + n
    if not rows and not totals:
        return []
    lines = [f"  {'layer':>18} {'track':>8} {'count':>7} {'device_s':>9} "
             f"{'self_dev_s':>10} {'launch%':>8}"]
    for (track, name), (n, dev, self_dev) in sorted(rows.items(), key=lambda kv: -kv[1][1]):
        launch_s = launch_us.get(track, 0) / 1e6
        share = f"{100 * dev / launch_s:7.1f}%" if launch_s > 0 else f"{'-':>8}"
        lines.append(f"  {name:>18} {track:>8} {n:7d} {dev:9.3f} {self_dev:10.3f} {share}")
    for name, n in sorted(totals.items()):
        lines.append(f"  {'counter':>18} {name}: {n}")
    return lines


def report(run_dir_or_events) -> str:
    """The terminal time-breakdown table (paper dashboard rendering):
    per-category self-time totals + shares, then per-track programs."""
    events = (run_dir_or_events
              if isinstance(run_dir_or_events, list)
              else read_events(run_dir_or_events))
    spans = [e for e in events if e.get("kind") == "span"]
    if not spans:
        return "(no spans recorded)"
    meta = next((e for e in events if e.get("kind") == "meta"), {})
    self_us = _self_times(spans)
    cat_us: dict = {}
    cat_n: dict = {}
    for ev in spans:
        c = _span_category(ev)
        cat_us[c] = cat_us.get(c, 0) + max(self_us[ev["id"]], 0)
        cat_n[c] = cat_n.get(c, 0) + 1
    wall_us = max(e["t0_us"] + e["dur_us"] for e in spans) \
        - min(e["t0_us"] for e in spans)
    wall_us = max(wall_us, 1)
    lines = [f"== telemetry report: {meta.get('run', '?')} "
             f"(wall {wall_us / 1e6:.2f}s, {len(spans)} spans) ==",
             f"  {'category':>10} {'time_s':>9} {'share':>7} {'spans':>6}"]
    known = [c for c in _CATEGORY_ORDER if c in cat_us]
    known += sorted(set(cat_us) - set(known))
    for c in known:
        lines.append(f"  {c:>10} {cat_us[c] / 1e6:9.3f} "
                     f"{100 * cat_us[c] / wall_us:6.1f}% {cat_n[c]:6d}")

    # per-track program table (the per-bucket attribution the planner's
    # "B compiled programs, not S" claim reads)
    tracks: list = []
    for ev in spans:
        if ev["track"] not in tracks:
            tracks.append(ev["track"])
    occupancy: dict = {}
    cost: dict = {}
    comms: list = []
    for e in events:
        if e.get("kind") != "counter":
            continue
        if e["name"] == "lane_occupancy":
            occupancy[e["track"]] = e["values"]
        elif e["name"] == "program_cost":
            # per-program FLOPs/bytes (Lowered.cost_analysis, recorded once
            # per compiled program on its compile launch) — summed per track
            c = cost.setdefault(e["track"], {"flops": 0.0, "bytes": 0.0})
            c["flops"] += float(e["values"].get("flops", 0.0))
            c["bytes"] += float(e["values"].get("bytes_accessed", 0.0))
        elif e["name"] == "comms_total":
            comms.append((e["track"], e["values"]))
    lines.append(f"  {'track':>10} {'launches':>9} {'compiles':>9} "
                 f"{'execute_s':>10} {'compile_s':>10} {'lanes':>8} "
                 f"{'gflops':>8} {'GB':>7}")
    for t in tracks:
        launches = [e for e in spans
                    if e["track"] == t and e["name"] == "launch"]
        if not launches:
            continue
        cold = [e for e in launches
                if e["attrs"].get("compile_delta", 0) > 0]
        warm_us = sum(e["dur_us"] for e in launches) \
            - sum(e["dur_us"] for e in cold)
        occ = occupancy.get(t)
        lanes = (f"{occ['alive']}/{occ['total']}" if occ else "-")
        c = cost.get(t)
        gflops = f"{c['flops'] / 1e9:8.2f}" if c else f"{'-':>8}"
        gb = f"{c['bytes'] / 1e9:7.2f}" if c else f"{'-':>7}"
        lines.append(
            f"  {t:>10} {len(launches):9d} "
            f"{sum(e['attrs'].get('compile_delta', 0) for e in launches):9d}"
            f" {warm_us / 1e6:10.3f}"
            f" {sum(e['dur_us'] for e in cold) / 1e6:10.3f} {lanes:>8} "
            f"{gflops} {gb}")

    # comms observatory section (telemetry/comms.py): one row per
    # ``comms_total`` payload — per lane under a campaign — with the
    # simulated wall-clock and the achieved uplink compression ratio
    # (uplink bytes / dense-equivalent uplink bytes)
    if comms:
        lines.append(f"  {'comms':>10} {'lane':>6} {'up_MB':>9} "
                     f"{'down_MB':>9} {'overlay_MB':>10} {'ratio':>7} "
                     f"{'sim_s':>9}")
        for track, v in comms:
            dense = float(v.get("dense_up_bytes", 0.0))
            ratio = (f"{float(v.get('up_bytes', 0.0)) / dense:7.3f}"
                     if dense else f"{'-':>7}")
            lane = v.get("lane")
            lines.append(
                f"  {track:>10} {('-' if lane is None else lane):>6} "
                f"{float(v.get('up_bytes', 0.0)) / 1e6:9.2f} "
                f"{float(v.get('down_bytes', 0.0)) / 1e6:9.2f} "
                f"{float(v.get('overlay_bytes', 0.0)) / 1e6:10.2f} "
                f"{ratio} "
                f"{float(v.get('sim_time_s', 0.0)):9.3f}")
    return "\n".join(lines + layer_table(events))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    usage = ("usage: python -m repro_torch.telemetry.trace <run_dir>  "
             "| report <run_dir>  | export <run_dir> [out.json]")
    if not argv:
        print(usage, file=sys.stderr)
        return 2
    # a missing/empty/truncated telemetry.jsonl (crash mid-chunk, wrong
    # dir) is a user-facing condition, not a traceback: read_events raises
    # FileNotFoundError/ValueError naming the path — print and exit 1
    try:
        if argv[0] == "report":
            if len(argv) != 2:
                print(usage, file=sys.stderr)
                return 2
            print(report(argv[1]))
            return 0
        if argv[0] == "export":
            argv = argv[1:]
        if not 1 <= len(argv) <= 2:
            print(usage, file=sys.stderr)
            return 2
        out = export(argv[0], *argv[1:])
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        # `... report run/ | head` closes stdout early — not an error
        return 0
    print(f"wrote {out} (load at https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
