"""B1 (``quant_aggregate_kernel``), the server's int8 reduction, in the
traced rounds: its launches' least time at the card's roofline over its
device time, in %."""
from portbench.yardstick import readers


def read(ctx):
    return readers.roofline(ctx, "quant_aggregate", ("quant_aggregate_kernel",),
                            readers.b1_least_s)
