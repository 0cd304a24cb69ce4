"""Tokens trained by the cohort's local steps in the rounds completed in
the window, per second of the window (host clock)."""


def read(ctx):
    return ctx.work["tokens"] / ctx.window_s
