"""The arithmetic of the per-layer metrics that read the program's layer
spans and counters (``repro_torch.telemetry.layer_times``): device seconds
of named spans, as a share of the traced window or against the least time
of their work, and ratios of counters.

The spans record only while a ``torch.profiler`` capture runs, and only
the traced sub-window (``yardstick/trace.record``) runs one in a benchmark
process: ``layer_times()`` holds exactly that sub-window. A program without
layer spans, or a run without the span or counter a reader names, gives
None, and the metric is left out of the line. Device seconds are read only
where the traced window ran work on a device: on the CPU a span's seconds
are the host's, and no device metric is read from them.
"""
from __future__ import annotations


def layer_times():
    """The program's layer spans and counters, or None where it has none."""
    try:
        from repro_torch.telemetry import layer_times as read
    except ImportError:
        return None
    t = read()
    return t if t["spans"] or t["counters"] else None


def _spans(ctx, names: tuple) -> list:
    """The named spans found in a traced run on a device."""
    t = layer_times() if ctx.trace is not None and ctx.trace.busy_s > 0 else None
    if t is None:
        return []
    return [t["spans"][n] for n in names if n in t["spans"]]


def share(ctx, *names: str):
    """% of the traced window that the named spans' device seconds take."""
    found = _spans(ctx, names)
    if not found:
        return None
    return 100.0 * sum(s["device_s"] for s in found) / ctx.trace.window_s


def roofline(ctx, name: str, least_s):
    """% of the span ``name``'s device seconds that its calls would take at
    the card's roofline: ``least_s(shape, count)`` gives the least seconds
    of ``count`` calls at one shape the spans carry."""
    found = _spans(ctx, (name,))
    if not found or found[0]["device_s"] <= 0 or not found[0]["by_shape"]:
        return None
    sp = found[0]
    return 100.0 * sum(least_s(shape, n) for shape, n in sp["by_shape"].items()) \
        / sp["device_s"]


def counters(ctx, *names: str):
    """The named counters' totals, or None unless every one was counted."""
    t = layer_times() if ctx.trace is not None else None
    if t is None or any(n not in t["counters"] for n in names):
        return None
    return [t["counters"][n] for n in names]


def device_s(ctx, name: str):
    """The span ``name``'s device seconds, or None."""
    found = _spans(ctx, (name,))
    return found[0]["device_s"] if found and found[0]["device_s"] > 0 else None
