"""The flight recorder (port of ``repro/telemetry/recorder.py``): nested
spans + counters on the monotonic clock, and the same ``telemetry.jsonl``
event schema, so either package's ``trace.report`` reads either's file.

Event model (one JSON object per ``telemetry.jsonl`` line):

- ``{"kind": "meta", "schema": 1, "run": ..., "pid": ..., "unit": "us",
   "clock": "perf_counter_ns", "origin_ns": ..., "origin_wall_ns": ...}`` —
  first line of every file; the origins are the instant the events' times
  count from, on the monotonic clock and on the wall clock.
- ``{"kind": "span", "id": n, "parent": m|null, "depth": d, "name": ...,
   "track": ..., "t0_us": ..., "dur_us": ..., "attrs": {...}}`` — a closed
  span. IDs are assigned in *open* order and events are written in *close*
  order, so nesting reconstructs deterministically from (id, parent, depth)
  alone; wall times carry no ordering weight.
- ``{"kind": "counter", "name": ..., "track": ..., "t_us": ...,
   "values": {...}}`` — a point sample (staged bytes, lane occupancy,
  host RSS/CPU, quant-agg routing totals).

``track`` names the Perfetto track the event renders on: ``"run"`` for a
single executor, ``bucket<i>`` per planner bucket, ``"plan"`` for the
lockstep scheduler. Spans on one track nest by time containment (same tid),
which is exactly how Perfetto draws flame stacks.

A disabled recorder is a no-op: ``span()`` hands back a shared null context
and ``counter()`` returns immediately — the instrumented round loops pay a
dict-lookup per chunk boundary, nothing per round. Timing uses
``time.perf_counter_ns`` (monotonic); the recorder's spans touch no device
code, so telemetry cannot perturb the runs' numbers. The executor closes its
``launch`` span after ``torch.cuda.synchronize()``, so the span times the
device work, not the host's queueing of it.

Layer spans (``layer_span``, ``layer_count``, ``layer_times``) time the
layers inside a launch: the clients' local training, the int8 send, the
attention and norm backwards, the server's aggregate and update. They are
on only while a ``torch.profiler`` capture runs or an enabled recorder runs
a launch; off, a span site costs one call and two flag reads. An open span
is a ``record_function("repro_torch.<name>")`` range in the profiler's
timeline, a host interval on this clock, a device interval between two
CUDA events on the current stream (on the CPU the host interval stands for
it) and its parent, the innermost span open in the process: a backward that
autograd runs on its own device thread nests under the ``local_train`` that
waits for it. ``layer_times()`` resolves the events once and sums them by
name; an enabled recorder drains it into one ``layers`` counter per launch.
Recording a CUDA event is asynchronous, so spans leave the device's work
as it was.
"""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import time

import torch
import torch.autograd.profiler as _autograd_profiler


class Span:
    """An open span; ``attrs`` may be updated until the ``with`` exits.

    Its own context manager (not a ``contextlib`` generator): the chunk
    loop opens several spans per chunk boundary, and the hand-rolled
    ``__enter__``/``__exit__`` pair keeps that on the right side of the
    recorder's <=5% overhead budget."""
    __slots__ = ("name", "track", "attrs", "id", "parent", "depth", "_t0",
                 "_rec")

    def __init__(self, rec, name, track, attrs, sid, parent, depth, t0):
        self.name, self.track, self.attrs = name, track, attrs
        self.id, self.parent, self.depth = sid, parent, depth
        self._t0 = t0
        self._rec = rec

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        rec = self._rec
        rec._stack.pop()
        rec._emit({"kind": "span", "id": self.id, "parent": self.parent,
                   "depth": self.depth, "name": self.name,
                   "track": self.track, "t0_us": self._t0,
                   "dur_us": rec._now_us() - self._t0,
                   "attrs": dict(self.attrs)})
        if not rec._stack:
            rec.flush()
        return False


class _NullSpan:
    """Stand-in yielded by a disabled recorder: accepts (and discards)
    ``attrs`` updates so instrumentation sites need no enabled-checks."""
    __slots__ = ()

    @property
    def attrs(self):
        return {}


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return _NULL_SPAN

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()
_NULL_CTX = _NullCtx()
_NULL_LAYER = contextlib.nullcontext()


class FlightRecorder:
    """Host-side span/counter recorder streaming to ``telemetry.jsonl``.

    ``out_dir=None`` keeps events in memory only (``self.events``); with an
    out_dir the file is truncated on the recorder's first write (one file
    per recorder lifetime) and appended per event, flushed whenever the
    span stack empties. ``profile_chunks`` lists launch ordinals to wrap in
    a ``torch.profiler`` capture of the host and the card, exported as a
    Chrome trace under ``out_dir/torch_profile`` (``profile_paths``).
    """

    def __init__(self, out_dir=None, run_name: str = "run",
                 enabled: bool = True, profile_chunks=()):
        self.enabled = enabled
        self.run_name = run_name
        self.out_dir = pathlib.Path(out_dir) if out_dir else None
        self.profile_chunks = frozenset(int(c) for c in profile_chunks)
        self.events: list = []
        self._stack: list = []
        self._pending: list = []       # emitted, not yet serialized
        self._next_id = 0
        self._t0_ns = time.perf_counter_ns()
        self._t0_wall_ns = time.time_ns()      # the same instant on the wall clock
        self._fh = None
        self.profile_paths: list = []

    @classmethod
    def from_job(cls, job, fallback_dir=None) -> "FlightRecorder":
        """Build from a job's ``telemetry:`` section (validated by
        ``core/jobs.load_job``). No section, or ``enabled: false`` -> a
        no-op recorder; an enabled section without ``out_dir`` falls back
        to the executor's run dir (events stay in memory if neither)."""
        t = (getattr(job, "raw", None) or {}).get("telemetry") or {}
        enabled = bool(t) and bool(t.get("enabled", True))
        return cls(
            out_dir=(t.get("out_dir") or fallback_dir) if enabled else None,
            run_name=getattr(job, "name", "run"), enabled=enabled,
            profile_chunks=t.get("profile_chunks") or ())

    # -- clock ------------------------------------------------------------
    def _now_us(self) -> int:
        return (time.perf_counter_ns() - self._t0_ns) // 1000

    # -- spans ------------------------------------------------------------
    def span(self, name: str, track: str = "run", **attrs):
        if not self.enabled:
            return _NULL_CTX
        stack = self._stack
        sp = Span(self, name, track, attrs, self._next_id,
                  stack[-1].id if stack else None, len(stack),
                  self._now_us())
        self._next_id += 1
        stack.append(sp)
        return sp

    def counter(self, name: str, track: str = "run", *, t_us=None, **values):
        """Point sample; ``t_us`` backdates it onto the recorder clock (the
        probe drain stamps per-round samples interpolated across the launch
        span they were computed inside — they are device values, and the
        host only sees them at the chunk boundary)."""
        if not self.enabled:
            return
        self._emit({"kind": "counter", "name": name, "track": track,
                    "t_us": self._now_us() if t_us is None else int(t_us),
                    "values": values})

    def profile(self, ordinal: int):
        """A ``torch.profiler`` capture of launch ``ordinal`` when the
        ``profile_chunks`` knob lists it (else a no-op context); on exit the
        trace is exported as ``torch_profile/launch<ordinal>.json``."""
        if not self.enabled or ordinal not in self.profile_chunks:
            return _NULL_CTX
        return _Profile(self, ordinal)

    def layers(self, track: str = "run"):
        """Layer spans on for the ``with`` body (a launch, which ends
        synchronized); on exit ``layer_times()`` is drained into one
        ``layers`` counter (a no-op context when disabled)."""
        if not self.enabled:
            return _NULL_CTX
        return _LaunchLayers(self, track)

    # -- persistence ------------------------------------------------------
    def _emit(self, event: dict):
        """Record an event; serialization is deferred to ``flush()`` (the
        steady-state cost of an event is two list appends)."""
        self.events.append(event)
        if self.out_dir is not None:
            self._pending.append(event)

    def flush(self):
        """Serialize + write everything emitted since the last flush (one
        write call), and push it to the OS. Fired whenever the span stack
        empties — i.e. per chunk boundary — so a crash loses at most the
        open chunk's events."""
        if not self._pending:
            return
        if self._fh is None:
            self.out_dir.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.out_dir / "telemetry.jsonl", "w")
            self._fh.write(json.dumps(
                {"kind": "meta", "schema": 1, "run": self.run_name,
                 "pid": os.getpid(), "unit": "us",
                 "clock": "perf_counter_ns", "origin_ns": self._t0_ns,
                 "origin_wall_ns": self._t0_wall_ns}) + "\n")
        self._fh.write("".join(
            json.dumps(e, separators=(",", ":")) + "\n"
            for e in self._pending))
        self._pending.clear()
        self._fh.flush()

    def close(self):
        self.flush()
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __del__(self):                                # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class _Profile:
    """``torch.profiler`` over one launch: CPU activity, and CUDA activity
    where a card is present; exported as a Chrome trace."""

    def __init__(self, rec: FlightRecorder, ordinal: int):
        self.rec, self.ordinal = rec, ordinal
        self.prof = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        return _NULL_SPAN

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        d = (self.rec.out_dir or pathlib.Path(".")) / "torch_profile"
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"launch{self.ordinal}.json"
        self.prof.export_chrome_trace(str(path))
        self.rec.profile_paths.append(path)
        return False


class _LaunchLayers:
    """Layer spans on around one launch, then drained into a ``layers``
    counter: by span name its count, host, device and self device seconds,
    shapes and parents; by counter name its total."""

    def __init__(self, rec: FlightRecorder, track: str):
        self.rec, self.track = rec, track
        self.prev = False

    def __enter__(self):
        self.prev = _LOG.recording
        _LOG.recording = True
        return _NULL_SPAN

    def __exit__(self, *exc):
        _LOG.recording = self.prev
        times = layer_times()
        reset_layer_times()
        if times["spans"] or times["counters"]:
            spans = {name: dict(t, by_shape={str(k): n for k, n in t["by_shape"].items()},
                                parents={str(k): n for k, n in t["parents"].items()})
                     for name, t in times["spans"].items()}
            self.rec.counter("layers", track=self.track, spans=spans,
                             counters=times["counters"])
        return False


# -- layer spans -------------------------------------------------------------
class _LayerLog:
    """The process's layer spans: the open ones (one stack: a span opened on
    autograd's device thread nests under the span whose thread waits for
    it), the closed ones and the counters, kept in memory until
    ``reset_layer_times``. ``recording``: an enabled recorder is running a
    launch."""

    def __init__(self):
        self.recording = False
        self.stack: list = []
        self.closed: list = []
        self.counts: dict = {}


_LOG = _LayerLog()


class _LayerSpan:
    __slots__ = ("name", "attrs", "parent", "device", "_rf", "t0", "t1", "ev0", "ev1",
                 "dev_s")

    def __init__(self, name: str, device, attrs: dict):
        self.name, self.attrs, self.device = name, attrs, device
        self.parent = self._rf = self.ev0 = self.ev1 = self.dev_s = None
        self.t0 = self.t1 = 0

    def __enter__(self):
        stack = _LOG.stack
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self._rf = _autograd_profiler.record_function("repro_torch." + self.name)
        self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        if self.device is not None and self.device.type == "cuda":
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        if self.ev0 is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record(torch.cuda.current_stream(self.device))
        self.t1 = time.perf_counter_ns()
        self._rf.__exit__(*exc)
        self._rf = None
        stack = _LOG.stack
        if not stack or stack[-1] is not self:
            raise RuntimeError(f"layer span {self.name!r} closed while "
                               f"{stack[-1].name if stack else 'no span'!r} is innermost")
        stack.pop()
        _LOG.closed.append(self)
        return False

    def device_s(self) -> float:
        """Seconds between its two events (resolved once; the events are then
        released), or its host seconds off CUDA."""
        if self.dev_s is None:
            if self.ev0 is None:
                self.dev_s = (self.t1 - self.t0) * 1e-9
            else:
                self.dev_s = self.ev0.elapsed_time(self.ev1) * 1e-3
                self.ev0 = self.ev1 = None
        return self.dev_s


def layers_on() -> bool:
    """Whether layer spans and counts record now: a ``torch.profiler``
    capture is active (the flag the profiler sets on start and clears on
    stop), or an enabled recorder is running a launch."""
    return _autograd_profiler._is_profiler_enabled or _LOG.recording


def layer_span(name: str, device=None, **attrs):
    """A span over one layer's work on ``device`` (a context manager); off
    (``layers_on()`` false) a shared null context that yields None, with no
    range, clock read or event. ``attrs``: what the work was; a ``shape``
    attr is counted by ``layer_times``. The yielded span's ``attrs`` may be
    updated until the ``with`` exits (a site that builds them only when on
    tests the yielded span for None)."""
    if not layers_on():
        return _NULL_LAYER
    return _LayerSpan(name, device, attrs)


def layer_count(name: str, n) -> None:
    """Add ``n`` to the counter ``name`` while layer spans are on. ``n`` is
    an int or a device tensor, summed on the device and read by
    ``layer_times`` (a count taken from device values waits for nothing)."""
    if layers_on():
        _LOG.counts[name] = _LOG.counts.get(name, 0) + n


def layer_times() -> dict:
    """The closed layer spans and the counters since the last
    ``reset_layer_times``: ``{"spans": {name: {"count", "host_s",
    "device_s", "self_device_s", "by_shape": {shape: count}, "parents":
    {parent name or None: count}}}, "counters": {name: total}}``. Self
    device seconds are a span's device seconds minus its direct children's.
    Waits once for the devices the spans ran on; a counter summed on the
    device is read then."""
    closed = list(_LOG.closed)
    for dev in {sp.device for sp in closed if sp.ev0 is not None}:
        torch.cuda.synchronize(dev)
    self_s = {id(sp): sp.device_s() for sp in closed}
    for sp in closed:
        if sp.parent is not None and id(sp.parent) in self_s:
            self_s[id(sp.parent)] -= sp.device_s()
    spans: dict = {}
    for sp in closed:
        t = spans.setdefault(sp.name, {"count": 0, "host_s": 0.0, "device_s": 0.0,
                                       "self_device_s": 0.0, "by_shape": {},
                                       "parents": {}})
        t["count"] += 1
        t["host_s"] += (sp.t1 - sp.t0) * 1e-9
        t["device_s"] += sp.device_s()
        t["self_device_s"] += self_s[id(sp)]
        if "shape" in sp.attrs:
            shape = sp.attrs["shape"]
            t["by_shape"][shape] = t["by_shape"].get(shape, 0) + 1
        parent = sp.parent.name if sp.parent is not None else None
        t["parents"][parent] = t["parents"].get(parent, 0) + 1
    return {"spans": spans, "counters": {k: int(n) for k, n in _LOG.counts.items()}}


def reset_layer_times() -> None:
    """Forget the closed layer spans and the counters (open spans stay)."""
    _LOG.closed.clear()
    _LOG.counts.clear()


def read_events(path) -> list:
    """Parse a ``telemetry.jsonl`` (or a run dir containing one) back into
    event dicts — the single parser the exporter, report, and tests use."""
    p = pathlib.Path(path)
    if p.is_dir():
        p = p / "telemetry.jsonl"
    if not p.exists():
        raise FileNotFoundError(
            f"no telemetry.jsonl at {p} — was the run's job missing a "
            "telemetry: {enabled: true, out_dir: ...} section?")
    lines = p.read_text().splitlines()
    if not any(line.strip() for line in lines):
        raise ValueError(
            f"empty telemetry.jsonl at {p} — the run wrote no events "
            "(crashed before the first flush, or telemetry disabled?)")
    events = []
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            events.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                # a crash mid-write leaves one torn trailing line; everything
                # before it is intact (events are appended whole-line)
                break
            raise ValueError(
                f"corrupt telemetry.jsonl at {p}: line {i + 1} is not "
                "valid JSON (truncated mid-run?)") from None
    if not events:
        raise ValueError(
            f"empty telemetry.jsonl at {p} — only a torn partial line "
            "(crashed during the first flush?)")
    return events
