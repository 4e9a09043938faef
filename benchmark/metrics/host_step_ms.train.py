"""The host's time a stage-2 step, ms: the median of the program's
untraced ``gdn.train.step`` spans, around each call of the step in
``train.loop._epoch_loop`` (the forward, backward and update as the host
issues them, and any wait for a full launch queue; not the loss
read-back).  Where it reads near the wall time a step, the host paces
the step."""

from harness.spans import median_ms


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return median_ms("gdn.train.step", ctx["window_units"])
