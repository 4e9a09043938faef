"""The device's idle share in the traced slice of a online cell: 1 - the
union of the device's operation intervals over the slice's wall time."""


def read(ctx):
    sl = ctx.get("slice")
    if ctx.get("kind") != "online" or sl is None:
        return None
    return 100.0 * (1.0 - sl.busy_s() / sl.window_s)
