"""B2's backward (``kernels/rmsnorm.backward``, torch ops today) in the
traced rounds: the least time of its calls' shapes at the card's roofline
(memory-bound, ``yardstick/bwd_costs``) over the device seconds of the
program's ``rmsnorm.bwd`` spans, in %."""
from portbench.yardstick import bwd_costs, spans


def read(ctx):
    return spans.roofline(ctx, "rmsnorm.bwd", bwd_costs.rmsnorm_bwd_least_s)
