"""The model FLOPs of every client the traced chunk trained
(``clients_trained`` x local steps x batch x the CNN's FLOPs an image,
forward and backward) over the device seconds of the program's
``local_train`` spans, as a % of the card's float32 peak: how fast local
training runs, whatever share of it the server weighs."""
from portbench.yardstick import flops, peaks, spans


def read(ctx):
    got = spans.counters(ctx, "clients_trained")
    dev_s = spans.device_s(ctx, "local_train")
    if got is None or dev_s is None:
        return None
    tr = ctx.cell["traffic"]["train"]
    work = got[0] * tr["local_steps"] * tr["batch_size"] * flops.cnn_train_flops_per_image(ctx.cfg)
    return 100.0 * work / (dev_s * peaks.FLOPS_PER_S["f32"])
