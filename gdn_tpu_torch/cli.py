"""Command-line surface of the port's scripts (port of ``gdn_tpu/cli.py``).

The flag names, choices and defaults are the JAX package's:
``add_common_args``, ``add_train_args`` and ``add_eval_args`` add them
to a parser and ``build_config`` maps the parsed flags onto one
``Config``.  What differs:

- ``--platform`` (a JAX backend) becomes ``--device cuda|cpu``: the
  scripts run on the card unless the CPU is asked for.
- The port's own flags: ``--dtype`` (the conv stack's compute dtype),
  ``--ckpt_dir`` (another name of ``--model_dir``) and
  ``--model.<flag>`` for each fused-kernel route
  (``config.FUSED_KERNEL_FLAGS``).
- ``build_config`` sets ``model.use_pallas_gn``: the port launches the
  GroupNorm+ELU kernel at every unfused site on the card.
- The port runs every combination of flags the JAX package's scripts
  take (a model variant, ``--fused_guidance`` or ``--fsdp`` on any
  mesh).  A combination neither package runs raises from the Config
  (``--quantize int8 --norm none``, ``--model_devices 2 --fsdp``: a
  ``ValueError``), and ``parse_or_exit`` turns that into the parser's
  error.
- ``--num_devices N`` runs N ranks (0: every visible card, at least
  ``--spatial_devices`` x ``--model_devices``; one process on the CPU
  otherwise), ``--spatial_devices S`` shards each image's height over S
  of them and ``--model_devices M`` each layer's output channels over M,
  the rest split the batch; ``--fsdp`` shards the parameters and
  optimizer state over the data ranks and ``--device_cache_sharded``
  the device cache.  One command runs the job: ``start_ranks`` spawns
  the N ranks when the script was started alone, and joins the group
  torchrun gives it when torchrun started it.
  ``--steps_per_call`` and ``--fused_guidance`` run as in the JAX
  package; ``fused_guidance_vjp``, ``fused_encoders`` and
  ``remat_policy`` have no flag in either package and come through
  config.json and the config API.
- ``--quantize int8`` builds an int8 config (``model.quant``), which the
  scripts calibrate (``ops/quant.py``); ``--artifact`` is read by the
  serving script alone.

``apply_saved_model_config`` adopts the architecture saved next to a
checkpoint.
"""

from __future__ import annotations

import argparse
import dataclasses

from gdn_tpu_torch.checkpoint import load_config
from gdn_tpu_torch.config import (
    Config, add_fused_kernel_flags, fused_kernel_overrides, kitti_config, nyu_config,
)

def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset", choices=["kitti", "nyu", "synthetic"], default="kitti")
    p.add_argument("--data_path", type=str, default="")
    p.add_argument("--height", type=int, default=None,
                   help="train height (default: dataset native)")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--max_depth", type=float, default=None)
    p.add_argument("--model_dir", "--ckpt_dir", dest="model_dir", type=str,
                   default="checkpoints", help="checkpoint directory")
    p.add_argument("--no_pallas", action="store_true",
                   help="turn the fused kernels off: the plain loss terms and the "
                        "conv-then-GroupNorm route (the GroupNorm+ELU kernel stays)")
    p.add_argument("--upsample", choices=["resize_conv", "deconv"], default=None,
                   help="decoder upsampling style")
    p.add_argument("--deconv_init", choices=["lecun", "bilinear"], default=None,
                   help="deconv kernel init (used with --upsample deconv only)")
    p.add_argument("--norm", choices=["group", "none"], default=None,
                   help="conv-block normalization")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16",
                   help="compute dtype of the conv stack")
    add_fused_kernel_flags(p)


def add_train_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mode", choices=["DtoD", "RtoD"], default="DtoD",
                   help="stage 1 (depth autoencoder) or stage 2 (guided)")
    p.add_argument("--train_list", type=str, default="train.txt")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_schedule", choices=["step", "cosine", "constant"], default="step",
                   help="LR shape: step decay, cosine to 0 over the run, or constant; "
                        "all compose with --warmup_steps and --grad_accum")
    p.add_argument("--decay_epochs", type=int, default=20)
    p.add_argument("--decay_gamma", type=float, default=0.5)
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="linear 0->lr warmup over the first N optimizer steps")
    p.add_argument("--ema_decay", type=float, default=None,
                   help="track an EMA of the params, saved in checkpoints and "
                        "selectable at eval and serve time with --use_ema (e.g. 0.999)")
    p.add_argument("--grad_clip", type=float, default=None,
                   help="clip gradients to this global norm")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="accumulate gradients over N micro-batches per optimizer "
                        "update (effective batch = N * batch_size)")
    p.add_argument("--decode_cache", type=str, default="",
                   help="directory of the decoded-sample cache: the first epoch "
                        "decodes and stores wire samples, later ones read memmaps "
                        "(native loader only)")
    p.add_argument("--device_cache", action="store_true",
                   help="keep the decoded wire corpus on the card and gather batches "
                        "there (2 GiB gate)")
    p.add_argument("--device_cache_sharded", action="store_true",
                   help="shard the device-resident corpus over the data ranks (each "
                        "holds 1/D, per-shard sample order)")
    p.add_argument("--train_wire", choices=["auto", "f32"], default="auto",
                   help="upload format: auto ships uint8 RGB + uint16 depth counts "
                        "and decodes them on the card; f32 converts on the host")
    p.add_argument("--steps_per_epoch", type=int, default=1000,
                   help="steps per epoch for synthetic/unbounded data")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="optimizer steps a call of the train step (K batches "
                        "stacked on the device). Must divide steps_per_epoch")
    p.add_argument("--stage1_ckpt", type=str, default="",
                   help="(RtoD) stage-1 checkpoint dir; default <model_dir>/stage1")
    p.add_argument("--no_freeze_decoder", action="store_true")
    p.add_argument("--ssim_precision", choices=["default", "high", "highest"], default=None,
                   help="precision of the SSIM blurs on the TPU; the port's SSIM is fp32")
    p.add_argument("--num_devices", type=int, default=0,
                   help="ranks (0 = every visible card, at least spatial x model "
                        "devices; the script starts them, or joins torchrun's)")
    p.add_argument("--spatial_devices", type=int, default=1,
                   help="spatial-partitioning mesh axis: shard each image's height over "
                        "this many ranks (mesh = data x spatial x model)")
    p.add_argument("--model_devices", type=int, default=1,
                   help="tensor-parallel mesh axis: shard each layer's output channels "
                        "over this many ranks")
    p.add_argument("--fsdp", action="store_true",
                   help="shard parameters and optimizer/EMA state over the data ranks "
                        "(FSDP2); mutually exclusive with --model_devices")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint of this stage")
    p.add_argument("--fused_guidance", action="store_true",
                   help="stage 2: run the shared frozen decoder ONCE on the "
                        "concatenated D+G batch (requires freeze_decoder)")
    p.add_argument("--multiscale", action="store_true",
                   help="supervise depth at every decoder scale (multi-scale heads)")
    p.add_argument("--loader", choices=["native", "grain"], default="native",
                   help="host loader: the native loaders, or the grain loader's "
                        "counterpart (grain's order, a checkpointed cursor exact at "
                        "any --workers)")
    p.add_argument("--workers", type=int, default=0,
                   help="--loader grain: decode threads (0 = in the loading thread)")
    p.add_argument("--val_pairs_list", type=str, default="",
                   help="optional held-out list (train pair format) for per-epoch "
                        "validation loss")
    p.add_argument("--eval_every", type=int, default=0,
                   help="(RtoD) run the full eval protocol on the eval split every N "
                        "epochs, log eval_* and keep the best RMSE's checkpoint in "
                        "<model_dir>/stage2_best (0 = off)")
    p.add_argument("--eval_max_images", type=int, default=None,
                   help="cap images per in-training eval pass")
    p.add_argument("--eval_batch", type=int, default=32,
                   help="images per in-training eval step (metrics stay per-image)")
    p.add_argument("--tensorboard", action="store_true",
                   help="also write TensorBoard scalars under <model_dir>/tb")


def add_eval_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--val_list", type=str, default="val.txt")
    p.add_argument("--cap", type=float, default=None,
                   help="depth cap in meters (KITTI: 80 or 50; NYU: 10)")
    p.add_argument("--crop", choices=["garg", "eigen", "none"], default=None)
    p.add_argument("--calib_dir", type=str, default="",
                   help="KITTI calibration dir for velodyne .bin GT entries in the "
                        "eval list")
    p.add_argument("--median_scaling", action="store_true")
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--eval_batch", type=int, default=8,
                   help="images per eval step (metrics stay per-image)")
    p.add_argument("--save_preds", type=str, default="",
                   help="also save each image's predicted depth (.npy, train size, "
                        "named by dataset index) into this directory")
    p.add_argument("--flip_tta", action="store_true",
                   help="horizontal-flip test-time augmentation, one 2B-wide forward")
    p.add_argument("--gt_wire", choices=["f32", "u16"], default=None,
                   help="GT upload format: u16 ships round(gt*256) counts, 1/4 the "
                        "bytes; f32 (default) is exact")
    p.add_argument("--rgb_wire", choices=["auto", "f32"], default=None,
                   help="RGB upload format: auto (default) ships bfloat16 when the "
                        "model computes in bfloat16 (bit-identical)")
    p.add_argument("--num_devices", type=int, default=1,
                   help="data-parallel eval over this many ranks (1 = single device; "
                        "0 = every visible card; eval_batch must divide by it)")
    p.add_argument("--use_ema", action="store_true",
                   help="score the EMA weights of an --ema_decay training run")
    p.add_argument("--device_cache", action="store_true",
                   help="stage the whole split on the card first (wire format, "
                        "2 GiB gate; host-fed past it or on an allocation failure)")


def build_config(args: argparse.Namespace) -> Config:
    """The Config the parsed flags describe, as ``gdn_tpu.cli.build_config``
    builds it (plus the port's ``--dtype``, ``--model.<flag>`` and
    ``model.use_pallas_gn``).  Raises NotImplementedError for a value
    the port does not run yet, naming its ROADMAP item."""
    preset = nyu_config if args.dataset == "nyu" else kitti_config
    over = {
        "model.use_pallas_gn": True,
        "model.dtype": args.dtype,
        **fused_kernel_overrides(args),
        "data.dataset": args.dataset,
        "data.data_path": args.data_path,
        "train.seed": args.seed,
        "train.ckpt_dir": args.model_dir,
    }
    if args.height or args.width:
        h0, w0 = preset().model.image_size
        over["model.image_size"] = (args.height or h0, args.width or w0)
    if args.max_depth:
        over["model.max_depth"] = args.max_depth
    for field in ("upsample", "deconv_init", "norm"):
        if getattr(args, field, None):
            over[f"model.{field}"] = getattr(args, field)
    if getattr(args, "multiscale", False):
        over["model.multiscale_heads"] = True
    if getattr(args, "quantize", "none") != "none":
        over["model.quant"] = args.quantize
    if getattr(args, "no_pallas", False):
        over["model.use_pallas"] = False
        over["loss.use_pallas"] = False
    if hasattr(args, "epochs"):
        over.update({
            "data.train_list": args.train_list,
            "data.batch_size": args.batch_size,
            "train.mode": args.mode,
            "train.epochs": args.epochs,
            "train.lr": args.lr,
            "train.schedule": args.lr_schedule,
            "train.decay_epochs": args.decay_epochs,
            "train.decay_gamma": args.decay_gamma,
            "train.steps_per_epoch": args.steps_per_epoch,
            "train.steps_per_call": args.steps_per_call,
            "train.warmup_steps": args.warmup_steps,
            "train.ema_decay": args.ema_decay,
            "train.grad_clip": args.grad_clip,
            "train.grad_accum": args.grad_accum,
            "train.fused_guidance": args.fused_guidance,
            "data.loader": args.loader,
            "data.grain_workers": args.workers,
            "data.train_wire": args.train_wire,
            "data.decode_cache": args.decode_cache,
            "data.device_cache": args.device_cache,
            "data.device_cache_sharded": args.device_cache_sharded,
            "train.freeze_decoder": not args.no_freeze_decoder,
            "train.log_every": args.log_every,
            "mesh.num_devices": args.num_devices,
            "mesh.spatial_devices": args.spatial_devices,
            "mesh.model_devices": args.model_devices,
            "mesh.fsdp": args.fsdp,
        })
        if args.ssim_precision is not None:
            over["loss.ssim_precision"] = args.ssim_precision
    # --eval_batch is on both surfaces: the eval CLI and in-training eval
    if getattr(args, "eval_batch", None):
        over["eval.batch_size"] = args.eval_batch
    if hasattr(args, "val_list"):
        over["data.val_list"] = args.val_list
        if getattr(args, "calib_dir", ""):
            over["data.calib_dir"] = args.calib_dir
        for field in ("cap", "crop", "gt_wire", "rgb_wire"):
            if getattr(args, field, None) is not None:
                over[f"eval.{field}"] = getattr(args, field)
        if getattr(args, "median_scaling", False):
            over["eval.median_scaling"] = True
        if hasattr(args, "num_devices"):
            over["mesh.num_devices"] = args.num_devices
    return preset(**over)


def parse_or_exit(p: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """Parse ``argv`` and check that the port runs what it asks for: a
    value the Config refuses ends the run through ``p.error`` with its
    ROADMAP item, and so does a combination the Config rejects."""
    args = p.parse_args(argv)
    try:
        build_config(args)
    except (NotImplementedError, ValueError) as e:
        p.error(str(e))
    return args


def apply_saved_model_config(cfg: Config, args: argparse.Namespace,
                             ckpt_dir: str) -> Config:
    """Adopt the ModelConfig saved next to a checkpoint
    (``<ckpt_dir>/config.json``), so eval, serve and resume rebuild the
    trained architecture without the training flags.

    Only the architecture is adopted: the execution fields
    (``_exec_field`` metadata: kernel routes, compute dtype) stay those
    of ``cfg``, the current environment.  Architecture flags given on
    the command line (``--height``, ``--width``, ``--max_depth``,
    ``--upsample``, ``--deconv_init``, ``--norm``, ``--multiscale``) win
    over the saved value, with a warning when they contradict it; so does
    ``--dtype``, which is an execution field.  Without config.json,
    ``cfg`` is returned as it is."""
    saved = load_config(ckpt_dir)
    if saved is None:
        return cfg
    model = saved.model
    execution_fields = {f.name for f in dataclasses.fields(type(model))
                        if f.metadata.get("execution")}
    dtype = getattr(args, "dtype", None)
    if dtype is not None and dtype != model.dtype:
        print(f"[config] checkpoint {ckpt_dir} was trained with "
              f"model.dtype={model.dtype!r}; the command line asks for {dtype!r}",
              flush=True)
    model = dataclasses.replace(model, **{f: getattr(cfg.model, f) for f in execution_fields})
    overrides = {}
    if getattr(args, "height", None) or getattr(args, "width", None):
        overrides["image_size"] = (args.height or model.image_size[0],
                                   args.width or model.image_size[1])
    if getattr(args, "max_depth", None):
        overrides["max_depth"] = args.max_depth
    for field in ("upsample", "deconv_init", "norm"):
        v = getattr(args, field, None)
        if v is not None:
            overrides[field] = v
    if getattr(args, "multiscale", False):
        overrides["multiscale_heads"] = True
    for field, v in overrides.items():
        if getattr(model, field) != v:
            print(f"[config] WARNING: checkpoint {ckpt_dir} was trained with "
                  f"model.{field}={getattr(model, field)!r} but the command line "
                  f"asks for {v!r}; honoring the command line: expect a "
                  "parameter-shape mismatch unless this is intentional", flush=True)
    model = dataclasses.replace(model, **overrides)
    if model != cfg.model:
        diffs = [f.name for f in dataclasses.fields(model)
                 if getattr(model, f.name) != getattr(cfg.model, f.name)]
        print(f"[config] adopted model config from {ckpt_dir}/config.json "
              f"(differs from the command line's defaults in: {', '.join(diffs)})",
              flush=True)
    return dataclasses.replace(cfg, model=model)


def start_ranks(args: argparse.Namespace, main, argv) -> bool:
    """Start the data-parallel ranks of a script run: returns True in a
    parent that ran ``main(argv)`` in its spawned ranks (it has nothing
    left to do), False in the process that goes on as a rank or alone.

    Under torchrun (``RANK`` and ``WORLD_SIZE`` set) the process joins
    the group torchrun describes.  Otherwise ``--num_devices`` N > 1
    (0: every visible card, one on the CPU, raised to ``--spatial_devices``
    x ``--model_devices`` where it is not a multiple) spawns N ranks over a
    ``file://`` rendezvous (``parallel.multihost.run_ranks``), after the
    kernels are built once here so that the ranks load them."""
    import os

    import torch

    from gdn_tpu_torch.parallel import multihost

    device_type = args.device
    if torch.distributed.is_initialized():
        return False
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        multihost.maybe_initialize(device_type=device_type)
        return False
    n = args.num_devices
    if n == 0:
        n = torch.cuda.device_count() if device_type == "cuda" else 1
        inner = getattr(args, "spatial_devices", 1) * getattr(args, "model_devices", 1)
        if n % inner:
            n = inner
    if n <= 1:
        return False
    if device_type == "cuda":
        from gdn_tpu_torch import kernels

        kernels.load_all()
    multihost.run_ranks(main, n, (argv,), device_type=device_type)
    return True
