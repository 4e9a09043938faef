#!/usr/bin/env python
"""Training entry point of the PyTorch/CUDA port (gdn_tpu_torch), the
counterpart of scripts/train.py, with its flag surface
(gdn_tpu_torch/cli.py: the JAX package's flags, ``--device`` for
``--platform``, and the port's ``--dtype`` and ``--model.<flag>``).

``--mode DtoD`` trains the stage-1 depth autoencoder; ``--mode RtoD``
reads the stage-1 D-net, moves and freezes its decoder in a fresh G-net
(``--no_freeze_decoder`` trains it too) and trains stage 2.  Each epoch
ends with a full checkpoint (weights, EMA, optimizer, counts, data
cursor) in ``<model_dir>/stage1/`` or ``stage2/`` (``--ckpt_dir`` is
another name of ``--model_dir``), with the run's config.json beside it
(scripts/eval_torch.py, serve_torch.py and demo_torch.py read them).
``--resume`` adopts the saved config, restores the newest checkpoint of
the stage, moves the data to its step and trains ``--epochs`` more
epochs.  SIGTERM or SIGINT ends the run after the step in flight, with a
checkpoint to resume from.  RtoD reads the D-net from
``<model_dir>/stage1/`` (or ``--stage1_ckpt``) and adopts its config, or
takes an exported ``--stage1_pth`` described by the flags.  The
optimizer: ``--lr`` with ``--lr_schedule step|cosine|constant``
(``--decay_epochs``, ``--decay_gamma``) after ``--warmup_steps``,
``--grad_clip``, ``--ema_decay`` (``--use_ema`` in eval and serve),
``--grad_accum N`` (one update every N batches on their mean gradient),
``--steps_per_call K`` (K steps a call of the train step, on K batches
stacked on the device; K divides ``--steps_per_epoch``).
``--fused_guidance`` (RtoD) runs the frozen decoder once a step over the
D-net's and the G-net's encodings together.
``--tensorboard`` also writes the step scalars under ``<model_dir>/tb``.

Runs on the card (``--device cuda``, the default) or, when asked, on
the CPU.  ``--dataset kitti|nyu`` trains from the list file
``--train_list`` under ``--data_path`` (lines ``<rgb> <depth>``, e.g. the
corpus scripts/make_fixture.py writes): the host decodes (the native
decoder when it builds, else PIL), a prefetch thread uploads the uint8 /
uint16 wire (``--train_wire auto``) and decodes and augments it on the
device.  ``--decode_cache DIR`` keeps the decoded samples in memmaps for
later epochs; ``--device_cache`` keeps the whole wire corpus on the card
and gathers batches there.  ``--loader grain`` takes the grain loader's
counterpart instead: grain's batch order, ``--workers N`` decode
threads, and its cursor in each checkpoint (``--resume`` restores it,
exact at any thread count).  ``--resume`` moves the other loaders and
the augmentation stream to the restored step.  ``--dataset synthetic``
draws batches on the card and does not augment them.  The step lines
(loss terms, ``lr``, images/s) also go to ``<model_dir>/train_log.jsonl``.
``--val_pairs_list`` validates each epoch on ``--val_steps`` (default 10)
batches of a pairs list (f32 wire); on synthetic data ``--val_steps N``
validates on N held-out synthetic batches (seed + 1).  ``--eval_every N``
(RtoD) scores the G-net every N epochs with the full eval protocol on the
``--val_list`` split (the synthetic eval split on synthetic data) and
keeps the best eval RMSE's checkpoint in ``<model_dir>/stage2_best/``
(scripts/eval_torch.py --best).  ``--upsample deconv [--deconv_init
lecun]``, ``--norm none`` and ``--multiscale`` train the model
variants.  ``--num_devices N`` trains data parallel over N ranks
(0: every visible card): started alone the script spawns them, each on
``cuda:{rank % cards}`` (nccl when each has a card of its own, gloo
when they share one; ``--device cpu``: gloo), and under torchrun it joins
the group torchrun starts; ``--batch_size`` stays the global batch, each
rank trains on 1/N of its rows, and rank 0 logs and writes the
checkpoints (the same files as one device's).  ``--fsdp`` shards the
parameters and optimizer state over the ranks (FSDP2);
``--device_cache_sharded`` (with ``--device_cache``) holds 1/N of the
corpus on each rank.  ``--spatial_devices S`` shards each image's
height over S ranks and ``--model_devices M`` each layer's output
channels over M (tensor parallel); the batch splits over the rest, and
with ``--num_devices 0`` the script starts at least S x M ranks.  Any
variant flag, ``--fused_guidance`` and ``--fsdp`` (with
``--spatial_devices`` too) run on either axis, as in the JAX package; S
must divide ``--height`` (NYU's 228 splits unevenly below it, and the
levels that do not line up run gathered).

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
  python scripts/train_torch.py --mode RtoD --dataset synthetic \\
      --epochs 1 --steps_per_epoch 50 --steps_per_call 2 --fused_guidance
          # two steps a call, one decoder pass a step over both nets
  python scripts/train_torch.py --mode DtoD --dataset kitti --data_path data/kitti \\
      --loader grain --workers 4 --lr_schedule cosine --warmup_steps 100 \\
      --grad_clip 1.0 --tensorboard --model_dir runs/grain
  python scripts/train_torch.py --mode RtoD --dataset synthetic --num_devices 2 \\
      --fsdp --epochs 1 --steps_per_epoch 50   # two ranks, FSDP
  torchrun --nproc_per_node 8 scripts/train_torch.py --mode DtoD \\
      --dataset synthetic --epochs 1 --steps_per_epoch 50   # under torchrun
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    from gdn_tpu_torch.cli import add_common_args, add_train_args, parse_or_exit

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_train_args(p)
    p.add_argument("--val_list", type=str, default="val.txt",
                   help="eval split of --eval_every (lines '<rgb> <gt>')")
    p.add_argument("--calib_dir", type=str, default="",
                   help="KITTI calibration dir for velodyne .bin GT in --val_list")
    p.add_argument("--stage1_pth", type=str, default="",
                   help="(RtoD) read the D-net from this exported .pth instead, "
                        "described by the flags")
    p.add_argument("--val_steps", type=int, default=0,
                   help="validation batches each epoch: of --val_pairs_list (0 = "
                        "10), or held-out synthetic ones (seed + 1; 0 = off)")
    args = parse_or_exit(p, argv)
    if args.loader == "grain" and args.device_cache:
        p.error("--device_cache requires --loader native")
    return args


def build_config(args):
    from gdn_tpu_torch.cli import build_config

    return build_config(args)


def build_data(cfg, device, skip: int = 0, loader_state=None, mesh=None):
    """(the training batches from batch ``skip`` on, the host loader):
    the synthetic source on the device, or the disk loader behind the
    prefetch pipeline (wire decode and augmentation on the device).  A
    grain cursor saved at step ``skip`` (``loader_state``, the
    checkpoint's ``loader`` entry) restores the grain loader's
    counterpart; every other loader seeks.  With a data ``mesh`` the
    pipeline yields this rank's rows (the synthetic source yields the
    global batch, which the loop cuts)."""
    from gdn_tpu_torch.data.pipeline import make_loader, make_train_pipeline

    loader = make_loader(cfg, "train", device=device)
    if skip and (loader_state or {}).get("step") == skip and "grain" in loader_state:
        loader.load_state_dict(loader_state["grain"], produced=skip)
        print(f"restored grain loader state at step {skip}", flush=True)
    elif skip:
        loader.seek(skip)
    if cfg.data.dataset == "synthetic":
        return loader, loader
    print(f"{cfg.data.dataset}: {len(loader)} pairs, decoder {loader.decoder}, "
          f"wire {cfg.data.train_wire}", flush=True)
    host = loader
    if cfg.data.device_cache and cfg.data.device_cache_sharded:
        from gdn_tpu_torch.data.device_cache import ShardedDeviceDataset

        loader = ShardedDeviceDataset(loader, mesh, device=device)
        loader.seek(skip)
        print(f"device_cache (sharded): {len(loader)} samples, "
              f"{loader.resident_bytes / 2**20:.1f} MiB resident on {device}", flush=True)
    elif cfg.data.device_cache:
        from gdn_tpu_torch.data.device_cache import DeviceResidentDataset

        loader = DeviceResidentDataset(loader, device=device, mesh=mesh)
        print(f"device_cache: {len(loader)} samples, {loader.resident_bytes / 2**20:.1f} "
              f"MiB resident on {device}", flush=True)
    return make_train_pipeline(cfg, loader, augment=True, skip=skip, device=device,
                               mesh=mesh), host


def grain_state_fn(cfg, loader):
    """The checkpoint's ``loader`` entry of a grain run,
    ``{"step": n, "grain": cursor at n}``; None for other loaders (the
    loop then saves ``{"step": n}``).  A failed capture is reported and
    the checkpoint goes without a cursor: with more than one decode
    thread there is then no seek() to fall back on."""
    if cfg.data.loader != "grain" or cfg.data.dataset == "synthetic":
        return None

    def state_at(step: int):
        try:
            return {"step": step, "grain": loader.state_dict_at(step)}
        except ValueError as e:
            fallback = ("there is NO seek() fallback: --resume from this checkpoint will "
                        "refuse to reposition the data stream"
                        if cfg.data.grain_workers >= 2 else "resume will use seek()")
            print(f"[train] WARNING: loader state capture failed ({e}); {fallback}",
                  flush=True)
            return {"step": step}

    return state_at


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
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)

    from gdn_tpu_torch import checkpoint as ckpt
    from gdn_tpu_torch.cli import apply_saved_model_config, start_ranks
    from gdn_tpu_torch.config import resolve_device
    from gdn_tpu_torch.data.pipeline import CachedSampleIterable, make_loader
    from gdn_tpu_torch.parallel.mesh import create_mesh
    from gdn_tpu_torch.train.loop import stage1_state, stage2_state, train_stage1, train_stage2
    from gdn_tpu_torch.utils.logging import MetricLogger

    if start_ranks(args, main, argv):
        return None
    device = resolve_device(args.device)
    cfg = build_config(args)
    mesh = create_mesh(cfg.mesh.num_devices, spatial=cfg.mesh.spatial_devices,
                       model=cfg.mesh.model_devices, device_type=device.type)
    n = "1" if args.mode == "DtoD" else "2"
    root = cfg.train.ckpt_dir
    stage_dir = os.path.join(root, f"stage{n}")
    stage1_dir = args.stage1_ckpt or os.path.join(root, "stage1")
    if args.resume:
        # the checkpoint's own architecture, the flags given still win
        cfg = apply_saved_model_config(cfg, args, stage_dir)
    elif args.mode == "RtoD" and not args.stage1_pth:
        # the stage-1 config describes the decoder that moves to the G-net
        cfg = apply_saved_model_config(cfg, args, stage1_dir)
    h, w = cfg.model.image_size
    logger = MetricLogger(prefix=f"stage{n}",
                          jsonl_path=os.path.join(root, "train_log.jsonl"),
                          tensorboard_dir=os.path.join(root, "tb") if args.tensorboard else None)
    print(f"stage{n}: {h}x{w}, batch {cfg.data.batch_size}, {cfg.model.dtype}, "
          f"device {device}", flush=True)
    if args.mode == "RtoD":
        if args.stage1_pth:
            d_params = ckpt.load_pth(args.stage1_pth)
        else:
            d_params = ckpt.load_params(stage1_dir)
            print(f"loaded stage-1 params from {stage1_dir}", flush=True)
    state, loader_state = None, None
    if args.resume:
        fresh = (stage1_state(cfg, device) if args.mode == "DtoD"
                 else stage2_state(cfg, d_params, device))
        state = ckpt.restore_checkpoint(stage_dir, fresh)
        loader_state = ckpt.load_loader_state(stage_dir, step=state.step)
        print(f"resumed stage {n} at step {state.step}", flush=True)
    # the batch stream continues where a resumed run stopped
    data, loader = build_data(cfg, device, skip=state.step if state is not None else 0,
                              loader_state=loader_state, mesh=mesh)
    val = build_val(cfg, args, device)
    kw = dict(state=state, logger=logger, device=device,
              loader_state_fn=grain_state_fn(cfg, loader), mesh=mesh, **val)
    if args.mode == "DtoD":
        state = train_stage1(cfg, data, **kw)
    else:
        split = CachedSampleIterable(lambda: make_loader(cfg, "eval", device=device),
                                     max_items=args.eval_max_images)
        state = train_stage2(cfg, data, d_params, eval_dataset=split if args.eval_every else None,
                             eval_every=args.eval_every,
                             eval_max_images=args.eval_max_images, **kw)
    logger.close()
    print(f"stage {n} finished at step {state.step}; checkpoints in {stage_dir}", flush=True)
    return state


if __name__ == "__main__":
    main()
