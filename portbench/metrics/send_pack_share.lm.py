"""% of the traced window that the clients' int8 sends take
(``strategy.postprocess_packed`` -> ``core/packing.quantize_tree``): the
device seconds of the program's ``send.pack`` spans over the window."""
from portbench.yardstick import spans


def read(ctx):
    return spans.share(ctx, "send.pack")
