"""Hand-written CUDA kernels of the port and their wrappers."""


def load_all() -> None:
    """Build every kernel library at once (one nvcc per source, in
    parallel) and load each with its argtypes.  Call before timing or
    before worker threads launch kernels."""
    from gdn_tpu_torch.kernels import build, fused_loss, groupnorm

    build.build_all(("group_norm_elu", "fused_loss"))
    groupnorm.load()
    fused_loss.load()
