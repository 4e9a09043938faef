"""Hand-written CUDA kernels of the port and their wrappers.

Importing the package registers the kernels' inference forwards as the
``gdn_tpu_torch::`` ops of ``kernels/ops.py``, which an exported
artifact calls."""

from gdn_tpu_torch.kernels import ops  # noqa: F401  (registers the ops)


def load_all() -> None:
    """Build every kernel library at once (one nvcc per source, in
    parallel) and load each with its argtypes.  ``conv_gn_elu`` holds
    the whole fused conv family: the fusion-block and upsample entry
    points too.  Call before timing or before worker threads launch
    kernels."""
    from gdn_tpu_torch.kernels import build, conv_gn_elu, fused_loss, groupnorm

    build.build_all(("group_norm_elu", "fused_loss", "conv_gn_elu"))
    groupnorm.load()
    fused_loss.load()
    conv_gn_elu.load()
