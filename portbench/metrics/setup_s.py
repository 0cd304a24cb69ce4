"""Seconds from the process's start to the window's first step: imports,
kernel builds, inputs, weights, warm-up and the first rounds."""


def read(ctx):
    return ctx.setup_s
