"""Simulated rounds completed in the window, summed over the sweep's live
lanes, per second of the window (host clock)."""


def read(ctx):
    return ctx.work["lane_rounds"] / ctx.window_s
