"""The window's model FLOPs (the cohort's local training, forward and
backward, counted from the CNN's shapes) as a % of the card's float32 peak:
the port computes the CNN in f32 with TF32 off."""
from portbench.yardstick import readers


def read(ctx):
    return readers.mfu(ctx, "f32")
