#!/usr/bin/env python
"""Training entry point of the PyTorch/CUDA port (gdn_tpu_torch), the
counterpart of scripts/train.py.

``--mode DtoD`` trains the stage-1 depth autoencoder; ``--mode RtoD``
reads the stage-1 D-net, moves and freezes its decoder in a fresh G-net
and trains stage 2.  Each epoch ends with a full checkpoint (weights,
EMA, optimizer, counts, data cursor) in ``<ckpt_dir>/stage1/`` or
``stage2/``, with the run's config.json beside it (scripts/eval_torch.py
and scripts/serve_torch.py --ckpt_dir read them).  ``--resume`` adopts
the saved config, restores the newest checkpoint of the stage, moves
the data to its step and trains ``--epochs`` more epochs.  SIGTERM or
SIGINT ends the run after the step in flight, with a checkpoint to
resume from.  RtoD reads the D-net from ``<ckpt_dir>/stage1/`` (or
``--stage1_ckpt``) and adopts its config, or takes an exported
``--stage1_pth`` described by the flags.  ``--ema_decay`` keeps an EMA
of the weights (``--use_ema`` in eval and serve), ``--grad_accum N``
applies one update every N batches on their mean gradient.

Runs on the card (``--device cuda``, the default) or, when asked, on
the CPU.  ``--dataset kitti|nyu`` trains from the list file
``--train_list`` under ``--data_path`` (lines ``<rgb> <depth>``, e.g. the
corpus scripts/make_fixture.py writes): the host decodes (the native
decoder when it builds, else PIL), a prefetch thread uploads the uint8 /
uint16 wire (``--train_wire auto``) and decodes and augments it on the
device.  ``--decode_cache DIR`` keeps the decoded samples in memmaps for
later epochs; ``--device_cache`` keeps the whole wire corpus on the card
and gathers batches there.  ``--resume`` moves the loader and the
augmentation stream to the restored step.  ``--dataset synthetic`` draws
batches on the card and does not augment them.  The step lines also go
to ``<ckpt_dir>/train_log.jsonl``.  ``--val_pairs_list`` validates each
epoch on ``--val_steps`` (default 10) batches of a pairs list (f32 wire);
on synthetic data ``--val_steps N`` validates on N held-out synthetic
batches (seed + 1).  ``--eval_every N`` (RtoD) scores the G-net every N
epochs with the full eval protocol on the ``--val_list`` split (the
synthetic eval split on synthetic data) and keeps the best eval RMSE's
checkpoint in ``<ckpt_dir>/stage2_best/`` (scripts/eval_torch.py --best).

Examples:
  python scripts/make_fixture.py --out data/kitti --n 512 --style scene
  python scripts/train_torch.py --mode DtoD --dataset kitti --data_path data/kitti \\
      --epochs 1 --steps_per_epoch 50 --decode_cache data/kitti_cache
  python scripts/train_torch.py --mode RtoD --dataset kitti --data_path data/kitti \\
      --epochs 1 --steps_per_epoch 50 --device_cache
  python scripts/train_torch.py --mode DtoD --dataset synthetic \\
      --epochs 1 --steps_per_epoch 50
  python scripts/train_torch.py --mode DtoD --dataset synthetic \\
      --epochs 1 --steps_per_epoch 50 --resume    # one more epoch
  python scripts/train_torch.py --mode RtoD --dataset synthetic \\
      --epochs 1 --steps_per_epoch 50 --ema_decay 0.999 --grad_accum 2
  python scripts/train_torch.py --mode DtoD --dataset synthetic --device cpu \\
      --dtype float32 --height 32 --width 64 --batch_size 2 \\
      --epochs 1 --steps_per_epoch 3       # CPU smoke run
  python scripts/train_torch.py --mode DtoD --dataset synthetic \\
      --model.use_pallas_convgn_bt --model.use_pallas_convgn_s2 \\
      --model.use_pallas_fusion_bt --epochs 1 --steps_per_epoch 50
          # the 3x3 conv sites through the fused conv+GroupNorm+ELU kernels
  python scripts/train_torch.py --mode DtoD --dataset synthetic \\
      --model.use_pallas_fusion --epochs 1 --steps_per_epoch 50
          # the UpBlock up-convs through the upsample kernel and the
          # FusionBlocks through the per-image fusion kernel
  python scripts/train_torch.py --mode RtoD --dataset synthetic \\
      --epochs 4 --steps_per_epoch 50 --val_steps 5 --eval_every 1
          # validation and in-training eval with best-model tracking
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    from gdn_tpu_torch.config import add_fused_kernel_flags

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", choices=["DtoD", "RtoD"], default="DtoD",
                   help="DtoD = stage 1 (D-net), RtoD = stage 2 (G-net)")
    p.add_argument("--dataset", choices=["kitti", "nyu", "synthetic"],
                   default="kitti",
                   help="data source and preset (image size, max depth)")
    p.add_argument("--data_path", type=str, default="",
                   help="root of the list files and the paths in them")
    p.add_argument("--train_list", type=str, default="train.txt")
    p.add_argument("--val_pairs_list", type=str, default="",
                   help="held-out list in the train pair format: validation loss "
                        "each epoch")
    p.add_argument("--val_list", type=str, default="val.txt",
                   help="eval split of --eval_every (lines '<rgb> <gt>')")
    p.add_argument("--calib_dir", type=str, default="",
                   help="KITTI calibration dir for velodyne .bin GT in --val_list")
    p.add_argument("--train_wire", choices=["auto", "f32"], default="auto",
                   help="upload format: auto ships uint8 RGB + uint16 depth counts "
                        "and decodes them on the card; f32 converts on the host")
    p.add_argument("--decode_cache", type=str, default="",
                   help="directory of the decoded-sample cache: the first epoch "
                        "decodes and stores wire samples, later ones read memmaps")
    p.add_argument("--device_cache", action="store_true",
                   help="keep the decoded wire corpus on the card and gather batches "
                        "there (2 GiB gate)")
    p.add_argument("--loader", choices=["native", "grain"], default="native",
                   help="host loader (grain: not ported)")
    p.add_argument("--height", type=int, default=None,
                   help="train height (default: the preset's)")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--steps_per_epoch", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--dtype", choices=["bfloat16", "float32"],
                   default="bfloat16", help="compute dtype of the conv stack")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--ckpt_dir", type=str, default="checkpoints")
    p.add_argument("--stage1_ckpt", type=str, default="",
                   help="(RtoD) stage-1 checkpoint dir; default <ckpt_dir>/stage1")
    p.add_argument("--stage1_pth", type=str, default="",
                   help="(RtoD) read the D-net from this exported .pth instead, "
                        "described by the flags")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint of this stage")
    p.add_argument("--ema_decay", type=float, default=None,
                   help="track an EMA of the params, saved in checkpoints and "
                        "selectable at eval and serve time with --use_ema (e.g. 0.999)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="accumulate gradients over N micro-batches per optimizer "
                        "update (effective batch = N * batch_size)")
    p.add_argument("--val_steps", type=int, default=0,
                   help="validation batches each epoch: of --val_pairs_list (0 = "
                        "10), or held-out synthetic ones (seed + 1; 0 = off)")
    p.add_argument("--eval_every", type=int, default=0,
                   help="(RtoD) run the full eval protocol on the eval split every N "
                        "epochs, log eval_* and keep the best RMSE's checkpoint in "
                        "<ckpt_dir>/stage2_best (0 = off)")
    p.add_argument("--eval_max_images", type=int, default=None,
                   help="cap images per in-training eval pass")
    p.add_argument("--eval_batch", type=int, default=32,
                   help="images per in-training eval step (metrics stay per-image)")
    add_fused_kernel_flags(p)
    args = p.parse_args(argv)
    if args.loader == "grain":
        p.error("--loader grain: not ported yet (ROADMAP.md Queue A item 8, the grain "
                "loader); use --loader native")
    return args


def build_config(args):
    from gdn_tpu_torch.config import fused_kernel_overrides, kitti_config, nyu_config

    preset = nyu_config if args.dataset == "nyu" else kitti_config
    over = {
        "model.use_pallas_gn": True, "model.dtype": args.dtype,
        "data.dataset": args.dataset, "data.batch_size": args.batch_size,
        "data.data_path": args.data_path, "data.train_list": args.train_list,
        "data.val_list": args.val_list, "data.calib_dir": args.calib_dir,
        "data.train_wire": args.train_wire, "data.decode_cache": args.decode_cache,
        "data.device_cache": args.device_cache, "data.loader": args.loader,
        "train.mode": args.mode, "train.epochs": args.epochs,
        "train.lr": args.lr, "train.seed": args.seed,
        "train.steps_per_epoch": args.steps_per_epoch,
        "train.log_every": args.log_every, "train.ckpt_dir": args.ckpt_dir,
        "train.ema_decay": args.ema_decay, "train.grad_accum": args.grad_accum,
        "eval.batch_size": args.eval_batch,
        **fused_kernel_overrides(args),
    }
    if args.height or args.width:
        h0, w0 = preset().model.image_size
        over["model.image_size"] = (args.height or h0, args.width or w0)
    return preset(**over)


def build_data(cfg, device, skip: int = 0):
    """The training batches from batch ``skip`` on: the synthetic source
    on the device, or the disk loader behind the prefetch pipeline (wire
    decode and augmentation on the device)."""
    from gdn_tpu_torch.data.pipeline import make_loader, make_train_pipeline

    loader = make_loader(cfg, "train", device=device)
    loader.seek(skip)
    if cfg.data.dataset == "synthetic":
        return loader
    print(f"{cfg.data.dataset}: {len(loader)} pairs, decoder {loader.decoder}, "
          f"wire {cfg.data.train_wire}", flush=True)
    if cfg.data.device_cache:
        from gdn_tpu_torch.data.device_cache import DeviceResidentDataset

        loader = DeviceResidentDataset(loader, device=device)
        print(f"device_cache: {len(loader)} samples, {loader.resident_bytes / 2**20:.1f} "
              f"MiB resident on {device}", flush=True)
    return make_train_pipeline(cfg, loader, augment=True, skip=skip, device=device)


def build_val(cfg, args, device):
    """Validation: a pairs list on disk (f32 wire, like the JAX CLI) or
    held-out synthetic batches; {} without either."""
    h, w = cfg.model.image_size
    if args.val_pairs_list and cfg.data.dataset != "synthetic":
        from gdn_tpu_torch.data.kitti import KittiTrainDataset
        from gdn_tpu_torch.data.nyu import NyuTrainDataset

        cls = NyuTrainDataset if cfg.data.dataset == "nyu" else KittiTrainDataset
        return dict(val_iter=cls(cfg.data.data_path, args.val_pairs_list, (h, w),
                                 cfg.data.batch_size, max_depth=cfg.model.max_depth,
                                 wire="f32"),
                    val_steps=args.val_steps or 10)
    if args.val_steps and cfg.data.dataset == "synthetic":
        from gdn_tpu_torch.data.synthetic import SyntheticDataset

        return dict(val_iter=SyntheticDataset(cfg.data.batch_size, h, w, cfg.model.max_depth,
                                              seed=args.seed + 1, device=device),
                    val_steps=args.val_steps)
    return {}


def main(argv=None):
    args = parse_args(argv)

    from gdn_tpu_torch import checkpoint as ckpt
    from gdn_tpu_torch.cli import apply_saved_model_config
    from gdn_tpu_torch.config import resolve_device
    from gdn_tpu_torch.data.pipeline import CachedSampleIterable, make_loader
    from gdn_tpu_torch.train.loop import stage1_state, stage2_state, train_stage1, train_stage2
    from gdn_tpu_torch.utils.logging import MetricLogger

    device = resolve_device(args.device)
    cfg = build_config(args)
    n = "1" if args.mode == "DtoD" else "2"
    stage_dir = os.path.join(args.ckpt_dir, f"stage{n}")
    stage1_dir = args.stage1_ckpt or os.path.join(args.ckpt_dir, "stage1")
    if args.resume:
        # the checkpoint's own architecture, the flags given still win
        cfg = apply_saved_model_config(cfg, args, stage_dir)
    elif args.mode == "RtoD" and not args.stage1_pth:
        # the stage-1 config describes the decoder that moves to the G-net
        cfg = apply_saved_model_config(cfg, args, stage1_dir)
    h, w = cfg.model.image_size
    logger = MetricLogger(prefix=f"stage{n}",
                          jsonl_path=os.path.join(args.ckpt_dir, "train_log.jsonl"))
    print(f"stage{n}: {h}x{w}, batch {args.batch_size}, {args.dtype}, "
          f"device {device}", flush=True)
    if args.mode == "RtoD":
        if args.stage1_pth:
            d_params = ckpt.load_pth(args.stage1_pth)
        else:
            d_params = ckpt.load_params(stage1_dir)
            print(f"loaded stage-1 params from {stage1_dir}", flush=True)
    state = None
    if args.resume:
        fresh = (stage1_state(cfg, device) if args.mode == "DtoD"
                 else stage2_state(cfg, d_params, device))
        state = ckpt.restore_checkpoint(stage_dir, fresh)
        print(f"resumed stage {n} at step {state.step}", flush=True)
    # the batch stream continues where a resumed run stopped
    data = build_data(cfg, device, skip=state.step if state is not None else 0)
    val = build_val(cfg, args, device)
    if args.mode == "DtoD":
        state = train_stage1(cfg, data, state=state, logger=logger, device=device, **val)
    else:
        split = CachedSampleIterable(lambda: make_loader(cfg, "eval", device=device),
                                     max_items=args.eval_max_images)
        state = train_stage2(cfg, data, d_params, state=state, logger=logger, device=device,
                             eval_dataset=split if args.eval_every else None,
                             eval_every=args.eval_every,
                             eval_max_images=args.eval_max_images, **val)
    logger.close()
    print(f"stage {n} finished at step {state.step}; checkpoints in {stage_dir}", flush=True)
    return state


if __name__ == "__main__":
    main()
