"""How full the batcher's device batches ran in the window:
``DynamicBatcher.stats``' items over its batches times the batch size."""


def read(ctx):
    if ctx.get("kind") != "online":
        return None
    st = ctx["batcher"]
    if not st["batches"]:
        return None
    return 100.0 * st["batched_items"] / (st["batches"] * ctx["batch"])
