"""% of the traced window that the server takes: the device seconds of the
program's ``server.aggregate`` (B1, the unpack and the cast) and
``server.update`` spans over the window."""
from portbench.yardstick import spans


def read(ctx):
    return spans.share(ctx, "server.aggregate", "server.update")
