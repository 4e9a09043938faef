#!/usr/bin/env python
"""Eval entry point of the PyTorch/CUDA port (gdn_tpu_torch), the
counterpart of scripts/eval.py: read a checkpoint that
scripts/train_torch.py wrote, run the eval split through the reference
protocol (forward at train size -> bilinear resize to the GT's size in
fp32 -> crop/cap/mask -> the 8-metric table) and print the table, the
images/s and one ``name=value`` line.  The flags are the JAX eval
CLI's (gdn_tpu_torch/cli.py; ``--ckpt_dir`` is another name of
``--model_dir``); ``--quantize int8`` and ``--num_devices`` > 1 end the
run at parse time, naming their ROADMAP item.

``--stage 2`` (default) scores the G-net of the newest checkpoint in
``<model_dir>/stage2/`` (``--best``: ``stage2_best/``, the best eval RMSE
of a ``train_torch.py --eval_every`` run); ``--stage 1`` scores the
D-net's reconstruction of each GT, downsampled to train size by nearest
resize (``<model_dir>/stage1/``).  The architecture comes from the
checkpoint's config.json (``--height``/``--width`` still win, loudly).
``--use_ema`` scores the EMA weights of an ``--ema_decay`` run.
``--pth`` scores an exported state_dict instead; the flags describe the
model then.  Runs on the card (``--device cuda``, the default) or, when
asked, on the CPU.  ``--dataset kitti|nyu`` scores the split of the list
file ``--val_list`` under ``--data_path`` (lines ``<rgb> <gt>``; the GT a
depth ``.npy``/``.png`` at its raw size, or for KITTI a velodyne ``.bin``
projected with the calibration files in ``--calib_dir``);
``--dataset synthetic`` the synthetic split (32 images, seed 999, GT at
train size).  ``--device_cache`` stages the split on the card first.

Examples:
  python scripts/eval_torch.py --dataset kitti --data_path data/kitti \\
      --val_list eigen_test.txt --calib_dir data/kitti/calib --ckpt_dir checkpoints
  python scripts/eval_torch.py --dataset nyu --data_path data/nyu --val_list test.txt
  python scripts/eval_torch.py --dataset synthetic --ckpt_dir checkpoints
  python scripts/eval_torch.py --dataset synthetic --best --flip_tta --use_ema
  python scripts/eval_torch.py --dataset synthetic --stage 1 --device cpu \\
      --dtype float32      # CPU run of a tiny net trained on the CPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

def parse_args(argv=None):
    from gdn_tpu_torch.cli import add_common_args, add_eval_args, parse_or_exit

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_eval_args(p)
    p.add_argument("--stage", choices=["1", "2"], default="2",
                   help="score the stage-2 G-net (default) or the stage-1 D-net's "
                        "reconstruction")
    p.add_argument("--quantize", choices=["none", "int8"], default="none",
                   help="post-training int8 inference (not ported)")
    p.add_argument("--quant_calib_dir", default="",
                   help="images to calibrate --quantize int8 on (not ported)")
    p.add_argument("--best", action="store_true",
                   help="read <model_dir>/stage2_best (train_torch.py --eval_every)")
    p.add_argument("--pth", type=str, default="",
                   help="score this exported .pth instead of a checkpoint; the flags "
                        "describe the model")
    args = parse_or_exit(p, argv)
    if args.use_ema and args.pth:
        p.error("--use_ema reads the EMA of a checkpoint directory; an exported .pth "
                "holds one set of weights (scripts/export_torch.py --use_ema exports "
                "a JAX run's EMA)")
    if args.stage == "1" and (args.best or args.flip_tta):
        p.error("--best and --flip_tta apply to --stage 2 only")
    return args


def build_config(args):
    from gdn_tpu_torch.cli import build_config

    return build_config(args)


def main(argv=None):
    args = parse_args(argv)

    from gdn_tpu_torch import kernels
    from gdn_tpu_torch.checkpoint import load_params, load_pth
    from gdn_tpu_torch.cli import apply_saved_model_config
    from gdn_tpu_torch.config import resolve_device
    from gdn_tpu_torch.data.pipeline import make_loader
    from gdn_tpu_torch.evaluate import Stage1Split, evaluate
    from gdn_tpu_torch.models import DtoDNet, RtoDNet
    from gdn_tpu_torch.train.steps import make_eval_forward

    device = resolve_device(args.device)
    cfg = build_config(args)
    if args.pth:
        source, sd = args.pth, load_pth(args.pth)
    else:
        source = os.path.join(args.model_dir, "stage1" if args.stage == "1"
                              else "stage2_best" if args.best else "stage2")
        cfg = apply_saved_model_config(cfg, args, source)
        try:
            sd = load_params(source, key="ema" if args.use_ema else "params")
        except KeyError as e:
            raise SystemExit(f"eval_torch.py: --use_ema: {e.args[0]}") from None
    h, w = cfg.model.image_size
    net = (DtoDNet if args.stage == "1" else RtoDNet)(cfg.model)
    net.load_state_dict(sd, strict=True)
    net = net.to(device)
    if device.type == "cuda":
        kernels.load_all()
    split = make_loader(cfg, "eval", device=device)
    dataset = Stage1Split(split, (h, w)) if args.stage == "1" else split
    print(f"stage {args.stage} eval of {source}{' (EMA)' if args.use_ema else ''}: "
          f"{h}x{w}, batch {cfg.eval.batch_size}, {cfg.model.dtype}, device {device}",
          flush=True)
    results = evaluate(cfg, make_eval_forward(cfg, net, flip_tta=args.flip_tta), dataset,
                       max_images=args.max_images, save_preds=args.save_preds or None,
                       device_cache=args.device_cache, device=device)
    print(" ".join(f"{k}={v:.4f}" for k, v in results.items()), flush=True)
    return results


if __name__ == "__main__":
    main()
