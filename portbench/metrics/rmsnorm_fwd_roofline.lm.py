"""B2's forward (``rmsnorm_kernel``) in the traced rounds: its launches'
least time at the card's roofline over its device time, in %."""
from portbench.yardstick import readers


def read(ctx):
    esize = readers.ESIZE[ctx.cfg["torch_dtype"]]
    return readers.roofline(ctx, "rmsnorm", ("rmsnorm_kernel",), readers.b2_least_s(esize))
