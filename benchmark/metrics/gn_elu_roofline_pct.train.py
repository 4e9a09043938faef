"""The GroupNorm+ELU kernel's share of its roofline in training: the
least time of the step's GroupNorm+ELU forwards (every site of the D-net
and of the G-net, ``roofline.work.stage2_gn_bound_ms``: bytes at 3.35
TB/s) times the slice's steps, over the device time of the kernels of
``csrc/group_norm_elu.cu`` in the slice."""

import re

from roofline.work import stage2_gn_bound_ms

KERNELS = re.compile(r"\b(gn_elu_coop|gn_rows_sums|gn_rows_apply)\b")


def read(ctx):
    sl = ctx.get("slice")
    if ctx.get("kind") != "train" or sl is None:
        return None
    secs, n = sl.kernels(KERNELS)
    if n == 0:
        return None
    item = 2 if ctx["cfg"]["dtype"] == "bfloat16" else 4
    bound_s = stage2_gn_bound_ms(ctx["cfg"], ctx["batch"], item) / 1e3 * ctx["slice_units"]
    return 100.0 * bound_s / secs
