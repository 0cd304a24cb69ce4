"""B3's backward (``kernels/flash_attention.plain_bwd``, torch ops today)
in the traced rounds: the least time of its calls' shapes at the card's
bf16 roofline (``yardstick/bwd_costs``) over the device seconds of the
program's ``attn.bwd`` spans, in %."""
from portbench.yardstick import bwd_costs, spans


def read(ctx):
    return spans.roofline(ctx, "attn.bwd", bwd_costs.attn_bwd_least_s("bf16"))
