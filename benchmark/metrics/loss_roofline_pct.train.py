"""The fused loss kernels' share of their roofline in training: the
least time of a step's loss forward and backward
(``roofline.work.stage2_loss_bound_ms``) times the slice's steps, over
the device time of the kernels of ``csrc/fused_loss.cu`` in the slice."""

import re

from roofline.work import stage2_loss_bound_ms

KERNELS = re.compile(r"\b(loss_forward|loss_backward)\b")


def read(ctx):
    sl = ctx.get("slice")
    if ctx.get("kind") != "train" or sl is None:
        return None
    secs, n = sl.kernels(KERNELS)
    if n == 0:
        return None
    bound_s = stage2_loss_bound_ms(ctx["cfg"], ctx["batch"]) / 1e3 * ctx["slice_units"]
    return 100.0 * bound_s / secs
