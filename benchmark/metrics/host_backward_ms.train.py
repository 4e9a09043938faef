"""The host's time in a stage-2 step's backward, ms: the median of the
program's untraced ``gdn.train.backward`` spans, around ``loss.backward()``
in ``train.steps._apply_update`` (autograd's launches of the backward
kernels)."""

from harness.spans import median_ms


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return median_ms("gdn.train.backward", ctx["window_units"])
