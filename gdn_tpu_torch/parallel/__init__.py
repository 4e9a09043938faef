"""Data, tensor and spatial parallelism and FSDP over
``torch.distributed`` (port of ``gdn_tpu/parallel/``): ``mesh`` (the
(data, spatial, model) mesh, batch and image rows, the placement rules
and placement), ``tensor`` (column-parallel conv sites), ``spatial``
(height shards and their halos), ``multihost`` (process-group
start-up)."""

from gdn_tpu_torch.parallel.mesh import (
    create_mesh,
    fsdp_spec,
    model_size,
    param_mode,
    shard_batch,
    shard_stacked_batch,
    shard_state,
    spatial_size,
    tensor_parallel_spec,
    tree_shardings,
)
from gdn_tpu_torch.parallel.multihost import local_batch_slice, maybe_initialize
