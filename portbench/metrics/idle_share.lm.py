"""% of the traced sub-window in which no operation ran on the card."""
from portbench.yardstick import readers


def read(ctx):
    return readers.idle_share(ctx)
