"""The device's idle share in a train cell: 1 - the device's busy time a
step (the union of its operation intervals in the traced slice, over the
slice's steps) over the host-clock time a step in the untraced window.
The profiler slows the host; the slice's own wall time would count that
as idle."""


def read(ctx):
    sl = ctx.get("slice")
    if ctx.get("kind") != "train" or sl is None:
        return None
    busy = sl.busy_s() / ctx["slice_units"]
    wall = ctx["window_s"] / ctx["window_units"]
    return 100.0 * (1.0 - busy / wall)
