"""The window's model FLOPs (the cohort's local steps, forward and backward,
counted from the configuration's shapes, recomputation not counted) as a %
of the card's bf16 peak, per chip."""
from portbench.yardstick import readers


def read(ctx):
    return readers.mfu(ctx, "bf16")
