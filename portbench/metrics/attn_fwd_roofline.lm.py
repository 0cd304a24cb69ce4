"""B3's forward (``flash_wgmma_kernel``, or ``flash_tf32x3_kernel`` where
the program routes there) in the traced rounds: its launches' least time at
the card's roofline over its device time, in %."""
from portbench.yardstick import readers


def read(ctx):
    esize = readers.ESIZE[ctx.cfg["torch_dtype"]]
    return readers.roofline(ctx, "flash_attention", ("flash_wgmma_kernel", "flash_tf32x3_kernel"),
                            readers.b3_least_s(esize, "bf16"))
