"""Configuration for the PyTorch/CUDA port of gdn-tpu.

A field-for-field copy of the JAX package's ``gdn_tpu/config.py``
dataclasses (same names, same defaults, same ``_exec_field`` metadata),
so a config built for one package describes the same network in the
other.  The rationale and the TPU measurements behind each default are
documented there and are not repeated here; none of those numbers
describe this port.

What differs:

- ``ModelConfig.compute_dtype`` returns a ``torch.dtype``.
- Values neither package runs raise ``ValueError`` at construction
  (``norm``, ``upsample``, ``deconv_init``, ``fusion``, ``activation``,
  ``quant``, ``dtype``, ``DataConfig.loader``), where the JAX package
  raises when the net is traced or the loader made; so does
  ``quant="int8"`` with ``norm="none"`` (the int8 sites live on the
  GroupNorm paths).
- Every model variant of the JAX package runs: ``norm`` "group" or
  "none" (a biased conv, then the activation), ``activation`` "elu",
  "relu", "gelu" (flax's tanh form) or "leaky_relu" (slope 0.2),
  ``upsample`` "resize_conv" or "deconv" (a stride-2 transposed conv,
  ``deconv_init`` "bilinear" or "lecun", optional ``deconv_gn``),
  ``fusion`` "concat" or "add" (a 1x1 ``lateral_proj``, then a
  ConvBlock) and ``multiscale_heads`` (a depth head at each coarse
  decoder scale, supervised by ``losses.multiscale_depth_loss``).
- The model's Pallas flags keep their names and route to the port's
  CUDA kernels.  ``use_pallas_convgn_s2``, ``use_pallas_convgn_bt`` and
  ``use_pallas_convgn`` send the 3x3 ConvBlocks (stride 2; stride 1;
  stride 1, tried in that order as in the JAX package) and
  ``use_pallas_fusion_bt`` the concat FusionBlocks to the fused
  conv3x3+GroupNorm+ELU kernels (``kernels/conv_gn_elu.py``,
  ``kernels/fusion_bt.py``); ``use_pallas_fusion`` sends the
  resize_conv UpBlock up-convs at an exact 2x target to the upsample
  kernel (``kernels/upsample.py``) and the concat FusionBlocks that
  ``use_pallas_fusion_bt`` has not taken to the per-image fusion kernel
  (``kernels/fusion_block.py``); ``use_pallas=False`` turns all five
  off.  As in the JAX package every fused route needs ``activation=
  "elu"`` and GroupNorm (the kernels compute ELU only): a net with
  another activation or ``norm="none"`` launches none of them, and the
  deconv branch never takes the upsample kernel.  Every GroupNorm+ELU
  site that stays unfused launches the GroupNorm+ELU kernel
  (``kernels/groupnorm.py``) on a CUDA device whatever
  ``use_pallas_gn`` says.  On the CPU each site runs its kernel's plain
  PyTorch form.  Either way the GN backward is the analytic two-reduce
  one that ``gn_analytic_vjp`` selects in the JAX package.  A
  GroupNorm site with another activation runs the plain
  ``ops.groupnorm.group_norm_act`` in the formulation ``gn_impl``
  names, as the JAX package routes it; ``elu_outform_vjp`` sends the
  deconv branch's bare ELU through ``ops.elu.elu_saveout`` (its
  backward reads the output only).  ``convgn_bt_tile`` selects a TPU
  tiling and changes nothing in the port.
- ``quant="int8"`` (post-training, ``ops/quant.py``) runs every conv
  whose input has at least ``quant_min_channels`` channels as an int8
  product and turns the fused conv routes off, as in the JAX package;
  the GroupNorm+ELU kernel stays, and the transposed conv of the deconv
  branch and the ``lateral_proj`` of add fusion stay in float.  It
  serves and scores only: the train steps refuse it.
- ``LossConfig.use_pallas`` routes the loss: set, the fused route
  (``kernels/fused_loss.py``: the CUDA kernels on the card, their plain
  version on the CPU); unset, the unfused plain-PyTorch terms.
  ``ssim_precision`` is checked and ignored: the port's SSIM is fp32.
- ``TrainConfig.flatten_optimizer`` changes no math (it packs optax's
  leaves on the TPU) and is accepted as a no-op.
- ``TrainConfig.grad_accum`` averages the gradients of k micro-steps as
  ``optax.MultiSteps`` does and ``remat`` recomputes the trained net's
  forward in its backward (``torch.utils.checkpoint``) under the policy
  ``remat_policy`` names: one of ``REMAT_POLICIES``, jax's own policies
  (``train.steps.REMAT_SAVED`` says what each keeps).  The names of
  jax's policy factories (``REMAT_FACTORIES``) and unknown names raise
  ``ValueError``: neither package's step can run them.
  ``fused_guidance`` (one pass of the frozen decoder over both nets'
  encodings in stage 2), ``fused_guidance_vjp`` (its hand-written
  backward), ``fused_encoders`` (both encoders as one grouped ladder)
  and ``steps_per_call`` (K steps a call of the train step) run as in
  the JAX package (``train/steps.py``, ``train/loop.py``).
  ``keep_ckpts`` and ``async_ckpt`` drive ``checkpoint.save_checkpoint``
  (keep the newest k files of a stage; write them on a background
  thread after a copy to the host).  ``check_numerics`` wraps the train
  step in ``utils.guards.GuardedStep``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def _exec_field(default):
    """Execution-strategy field: changes no trained parameter and
    belongs to the current environment (see gdn_tpu/config.py)."""
    return dataclasses.field(default=default, metadata={"execution": True})


# jax.checkpoint_policies' policies (TrainConfig.remat_policy), and its
# factories, which build a policy from arguments and are none themselves
REMAT_POLICIES = (
    "nothing_saveable", "dots_saveable", "checkpoint_dots",
    "dots_with_no_batch_dims_saveable", "checkpoint_dots_with_no_batch_dims",
    "everything_saveable",
)
REMAT_FACTORIES = (
    "save_only_these_names", "save_any_names_but_these",
    "save_anything_except_these_names", "save_and_offload_only_these_names",
    "save_from_both_policies", "offload_dot_with_no_batch_dims",
)
# (field, the values either package runs)
_MODEL_CHOICES = (
    ("norm", ("group", "none")),
    ("activation", ("elu", "relu", "gelu", "leaky_relu")),
    ("upsample", ("resize_conv", "deconv")),
    ("deconv_init", ("bilinear", "lecun")),
    ("fusion", ("concat", "add")),
    ("quant", ("none", "int8")),
    ("dtype", ("bfloat16", "float32")),
)
_DATA_CHOICES = (
    ("loader", ("native", "grain")),
)


def _check_choices(cfg, table) -> None:
    """Raise ValueError for each field of ``table`` (field, the values
    either package runs) that ``cfg`` sets to another value."""
    for name, allowed in table:
        if getattr(cfg, name) not in allowed:
            raise ValueError(f"unknown {name} {getattr(cfg, name)!r} ({'|'.join(allowed)})")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the two-stage guided depth network."""

    image_size: Tuple[int, int] = (128, 416)
    enc_channels: Tuple[int, ...] = (32, 64, 128, 256, 512)
    dec_channels: Tuple[int, ...] = (256, 128, 64, 32, 16)
    norm: str = "group"
    group_norm_groups: int = 8
    gn_impl: str = _exec_field("chanreduce")
    gn_analytic_vjp: bool = _exec_field(True)
    activation: str = "elu"
    upsample: str = "resize_conv"
    resize_conv_composed: bool = _exec_field(True)
    deconv_gn: bool = False
    deconv_init: str = "bilinear"
    elu_outform_vjp: bool = _exec_field(True)
    fusion: str = "concat"
    multiscale_heads: bool = False
    max_depth: float = 80.0
    min_depth: float = 1e-3
    dtype: str = _exec_field("bfloat16")
    quant: str = _exec_field("none")
    quant_min_channels: int = _exec_field(0)
    use_pallas: bool = _exec_field(True)
    use_pallas_fusion: bool = _exec_field(False)
    use_pallas_gn: bool = _exec_field(False)
    use_pallas_convgn: bool = _exec_field(False)
    use_pallas_convgn_bt: bool = _exec_field(False)
    convgn_bt_tile: int = _exec_field(8)
    use_pallas_convgn_s2: bool = _exec_field(False)
    use_pallas_fusion_bt: bool = _exec_field(False)

    def __post_init__(self):
        _check_choices(self, _MODEL_CHOICES)
        if self.quant != "none" and self.norm != "group":
            raise ValueError("quant='int8' requires norm='group' (the quantized "
                             "conv sites live on the group-norm paths)")

    @property
    def num_scales(self) -> int:
        return len(self.enc_channels)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss weights and routing (losses.py)."""

    w_recon: float = 1.0
    w_grad: float = 1.0
    w_ssim: float = 0.5
    w_latent: float = 0.1
    ssim_window: int = 11
    ssim_sigma: float = 1.5
    ssim_precision: str = "default"
    grad_scales: int = 4
    w_scales: float = 0.5
    use_pallas: bool = True


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Data pipeline settings (``data/``): the synthetic source, or the
    KITTI and NYU loaders on disk through the prefetch pipeline, with the
    decode cache (``decode_cache``) and the device-resident corpus
    (``device_cache``; ``device_cache_sharded``: 1/D of it on each of D
    ranks).  ``loader="grain"`` takes the grain loader's counterpart
    (``data/grain_loader.py``: grain's batch order and cursor,
    ``grain_workers`` decode threads).  ``num_workers`` changes nothing
    in the port: the native decoder sizes its own thread pool.
    ``batch_size`` is the global batch: each of D ranks takes 1/D of
    its rows."""

    dataset: str = "kitti"  # "kitti" | "nyu" | "synthetic"
    data_path: str = ""
    train_list: str = "train.txt"
    val_list: str = "val.txt"
    batch_size: int = 32
    num_workers: int = 4
    loader: str = "native"
    grain_workers: int = 0
    train_wire: str = "auto"  # "auto" | "f32"
    calib_dir: str = ""
    random_flip: bool = True
    random_crop: bool = True
    color_jitter: bool = True
    jitter_strength: float = 0.2
    scale_range: Tuple[float, float] = (1.0, 1.15)
    prefetch: int = 2
    decode_cache: str = ""
    device_cache: bool = False
    device_cache_sharded: bool = False

    def __post_init__(self):
        _check_choices(self, _DATA_CHOICES)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer and loop settings (train/)."""

    mode: str = "DtoD"  # "DtoD" (stage 1) | "RtoD" (stage 2)
    epochs: int = 50
    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    schedule: str = "step"
    decay_epochs: int = 20
    decay_gamma: float = 0.5
    grad_clip: Optional[float] = None
    warmup_steps: int = 0
    grad_accum: int = 1
    ema_decay: Optional[float] = None
    flatten_optimizer: bool = False
    remat: bool = False
    remat_policy: str = "nothing_saveable"
    freeze_decoder: bool = True
    fused_guidance: bool = False
    fused_guidance_vjp: bool = False
    fused_encoders: bool = False
    seed: int = 0
    check_numerics: bool = False
    log_every: int = 50
    ckpt_dir: str = "checkpoints"
    keep_ckpts: int = 3
    async_ckpt: bool = True
    steps_per_epoch: int = 1000
    steps_per_call: int = 1

    def __post_init__(self):
        if self.remat_policy in REMAT_FACTORIES:
            raise ValueError(
                f"remat_policy={self.remat_policy!r} is a factory of jax.checkpoint_"
                "policies, not a policy: it builds one from names or policies given "
                "to it, and neither package's train step can run it (one of "
                f"{'|'.join(REMAT_POLICIES)})")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r} "
                             f"({'|'.join(REMAT_POLICIES)})")
        if self.steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, not {self.steps_per_call}")


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    cap: float = 80.0
    crop: str = "garg"  # "garg" | "eigen" | "none"
    median_scaling: bool = False
    batch_size: int = 1
    gt_wire: str = "f32"  # "f32" | "u16"
    rgb_wire: str = "auto"  # "auto" | "f32"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device layout: ``num_devices`` data-parallel ranks (0: all the
    ranks that run), ``fsdp`` to shard the parameters and optimizer
    state over them, ``spatial_devices`` ranks sharing each image's
    height and ``model_devices`` each layer's output channels
    (``parallel.mesh.create_mesh(spatial=, model=)``).  TP and FSDP
    exclude each other as in the JAX package
    (``parallel.mesh.param_mode``); every model variant and training
    knob runs on every mesh, as in the JAX package (its train steps
    refuse only training with ``quant``)."""

    data_axis: str = "data"
    num_devices: int = 0
    spatial_devices: int = 1
    model_devices: int = 1
    fsdp: bool = False

    def __post_init__(self):
        if self.num_devices < 0:
            raise ValueError(f"num_devices must be >= 0, not {self.num_devices}")
        if self.spatial_devices < 1 or self.model_devices < 1:
            raise ValueError("spatial_devices and model_devices must be >= 1")
        if self.model_devices > 1 and self.fsdp:
            raise ValueError("model_devices>1 (tensor parallel) and fsdp are mutually "
                             "exclusive parameter placements")


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


def kitti_config(**overrides) -> Config:
    """KITTI 128x416, cap 80 m."""
    model = ModelConfig(image_size=(128, 416), max_depth=80.0)
    return _with(Config(model=model), **overrides)


def nyu_config(**overrides) -> Config:
    """NYU Depth v2 228x304, cap 10 m."""
    model = ModelConfig(image_size=(228, 304), max_depth=10.0)
    cfg = Config(
        model=model,
        data=DataConfig(dataset="nyu"),
        eval=EvalConfig(cap=10.0, crop="none"),
    )
    return _with(cfg, **overrides)


def _with(cfg: Config, **overrides) -> Config:
    """Apply dotted overrides, e.g. _with(cfg, **{"model.dtype": "float32"})."""
    for key, value in overrides.items():
        parts = key.split(".")
        if len(parts) == 1:
            cfg = dataclasses.replace(cfg, **{parts[0]: value})
        else:
            sub = getattr(cfg, parts[0])
            sub = dataclasses.replace(sub, **{parts[1]: value})
            cfg = dataclasses.replace(cfg, **{parts[0]: sub})
    return cfg


# ModelConfig flags that route 3x3 conv sites to the fused
# conv3x3+GroupNorm+ELU kernels (use_pallas_fusion: the UpBlock up-convs
# with their upsample, and the FusionBlocks); the scripts take each as
# --model.<flag>.
FUSED_KERNEL_FLAGS = (
    "use_pallas_convgn", "use_pallas_convgn_bt", "use_pallas_convgn_s2",
    "use_pallas_fusion_bt", "use_pallas_fusion",
)


def add_fused_kernel_flags(parser) -> None:
    """Add ``--model.<flag>`` for each of FUSED_KERNEL_FLAGS to an
    argparse parser."""
    for flag in FUSED_KERNEL_FLAGS:
        parser.add_argument(
            f"--model.{flag}", action="store_true",
            help=f"set ModelConfig.{flag}: route its conv sites to the fused "
                 "conv3x3+GroupNorm+ELU kernel")


def fused_kernel_overrides(args) -> dict:
    """The dotted config overrides of the ``--model.<flag>`` options set
    in parsed ``args``."""
    return {f"model.{flag}": True for flag in FUSED_KERNEL_FLAGS
            if getattr(args, f"model.{flag}")}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for another; in a rank of a process group, that rank's card
    (``cuda:{local_rank % device_count}``) when no index is given.
    Raises when CUDA is asked for and absent — the port never moves to
    the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    if dev.type == "cuda" and dev.index is None and torch.distributed.is_initialized():
        from gdn_tpu_torch.parallel.multihost import rank_device

        dev = rank_device("cuda")
    return dev
