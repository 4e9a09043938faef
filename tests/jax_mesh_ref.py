"""The JAX side of the port's tensor- and spatial-parallel tests: the JAX
package's own loss functions of both stages (the fused-guidance one
too), their value and gradient jitted on a 2-D mesh of the virtual CPU
devices (tests/conftest.py), as its train steps place them
(``_spatial_safe_cfg`` on a spatial mesh, ``tree_shardings(..., "tp")``
on a model mesh, ``"fsdp"`` where asked), for the small net or a model
variant of it.  The loss takes its jnp terms, as the port's runs it is
held against do."""

import jax
import jax.numpy as jnp
import numpy as np

from gdn_tpu import config as jcfg
from gdn_tpu.models import DtoDNet as JDtoD, RtoDNet as JRtoD
from gdn_tpu.parallel import mesh as jmesh
from gdn_tpu.train import steps as jsteps
from gdn_tpu_torch.checkpoint import params_from_flax

import torch_parallel_ranks as R


def to_flax(sd):
    """The port's state_dict as the JAX package's nested params (4-D
    kernels OIHW -> HWIO)."""
    tree = {}
    for key, t in sd.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        a = t.numpy()
        node[leaf] = jnp.asarray(np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a)
    return tree


def mesh_grads(stage, params, d_params, batch, mesh, model=None, train=None, mode=None):
    """(terms, grads in the port's layout) of the JAX package's loss on
    ``mesh``: the batch by ``batch_sharding`` (rows on "data", height on
    "spatial"), the parameters by ``tree_shardings(..., mode)`` (None:
    "tp" where the mesh has a "model" axis, replicated otherwise).
    ``model``: ModelConfig fields over ``R.SMALL`` (the image size is the
    batch's); ``train``: TrainConfig fields (with ``fused_guidance``
    stage 2 takes ``_stage2_loss_fused``)."""
    hw = tuple(batch["depth"].shape[1:3])
    cfg = jsteps._spatial_safe_cfg(
        jcfg.Config(model=jcfg.ModelConfig(**{**R.SMALL, "image_size": hw, **(model or {})}),
                    loss=jcfg.LossConfig(use_pallas=False),
                    train=jcfg.TrainConfig(lr=1e-3, **(train or {}))), mesh)
    if mode is None:
        mode = "tp" if jmesh.model_size(mesh) > 1 else "replicated"
    data = jmesh.batch_sharding(mesh)
    p_sh = jmesh.tree_shardings(params, mesh, mode)
    d_apply = JDtoD(cfg=cfg.model).apply
    if stage == 1:
        def f(p, b):
            return jax.value_and_grad(jsteps._stage1_loss, has_aux=True)(p, d_apply, b, cfg)

        (_, terms), grads = jax.jit(f, in_shardings=(p_sh, data))(params, batch)
    else:
        g_apply = JRtoD(cfg=cfg.model).apply
        d_sh = jmesh.tree_shardings(d_params, mesh, mode)

        def f(p, dp, b):
            if cfg.train.fused_guidance:
                return jax.value_and_grad(jsteps._stage2_loss_fused, has_aux=True)(
                    p, dp, b, cfg)
            return jax.value_and_grad(jsteps._stage2_loss, has_aux=True)(
                p, dp, g_apply, d_apply, b, cfg)

        (_, terms), grads = jax.jit(f, in_shardings=(p_sh, d_sh, data))(params, d_params,
                                                                         batch)
    return ({k: float(v) for k, v in terms.items()},
            params_from_flax(jax.tree.map(np.asarray, grads)))
