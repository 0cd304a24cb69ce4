"""% of the traced window that B3's backward takes: the device seconds of
the program's ``attn.bwd`` spans over the window."""
from portbench.yardstick import spans


def read(ctx):
    return spans.share(ctx, "attn.bwd")
