"""The arithmetic that the metric readers in ``metrics/`` share: each
reader names its inputs and calls one of these. A reader that finds
nothing to read returns None, and the metric is left out of the line."""
from __future__ import annotations

from portbench.yardstick import costs, peaks

ESIZE = {"bfloat16": 2, "float32": 4}


def idle_share(ctx):
    """% of the traced window in which no operation ran on the device."""
    t = ctx.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(ctx, precision: str):
    """% of the card's peak in ``precision`` that the window's model FLOPs
    (``work["model_flops"]``) reach over the window, per chip."""
    flops = ctx.work.get("model_flops")
    if not flops:
        return None
    return 100.0 * flops / (ctx.window_s * ctx.chips * peaks.FLOPS_PER_S[precision])


def roofline(ctx, kernel: str, names: tuple, least_s):
    """% of its device time that a kernel's launches in the traced window
    would take at the card's roofline: ``least_s(shape, count)`` gives the
    least seconds of ``count`` launches at one ``launches_by_shape`` key;
    ``names``: the kernel's names in the trace."""
    t = ctx.trace
    if t is None:
        return None
    launches = t.launches.get(kernel) or {}
    dev_s = t.device_s(*names)
    if not launches or dev_s <= 0:
        return None
    return 100.0 * sum(least_s(shape, n) for shape, n in launches.items()) / dev_s


def b1_least_s(shape, n):
    S, C, N, qblock = shape
    return n * peaks.least_seconds(*costs.quant_aggregate(S, C, N, qblock), "bf16")


def b2_least_s(esize: int):
    def least(shape, n):
        R, D = shape
        return n * peaks.least_seconds(*costs.rmsnorm(R, D, esize, esize), "bf16")
    return least


def b3_least_s(esize: int, precision: str):
    def least(shape, n):
        B, Sq, Sk, H, KV, Dk, Dv, causal = shape
        ops, nbytes = costs.flash_attention(B, Sq, Sk, H, KV, Dk, Dv, 0, causal, esize)
        return n * peaks.least_seconds(ops, nbytes, precision)
    return least
