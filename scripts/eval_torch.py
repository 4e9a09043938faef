#!/usr/bin/env python
"""Eval entry point of the PyTorch/CUDA port (gdn_tpu_torch), the
counterpart of scripts/eval.py: read a checkpoint that
scripts/train_torch.py wrote, run the eval split through the reference
protocol (forward at train size -> bilinear resize to the GT's size in
fp32 -> crop/cap/mask -> the 8-metric table) and print the table, the
images/s and one ``name=value`` line.

``--stage 2`` (default) scores the G-net of the newest checkpoint in
``<ckpt_dir>/stage2/`` (``--best``: ``stage2_best/``, the best eval RMSE
of a ``train_torch.py --eval_every`` run); ``--stage 1`` scores the
D-net's reconstruction of each GT, downsampled to train size by nearest
resize (``<ckpt_dir>/stage1/``).  The architecture comes from the
checkpoint's config.json (``--height``/``--width`` still win, loudly).
``--use_ema`` scores the EMA weights of an ``--ema_decay`` run.
``--pth`` scores an exported state_dict instead; the flags describe the
model then.  Runs on the card (``--device cuda``, the default) or, when
asked, on the CPU.  Only the synthetic eval split is ported (32 images,
seed 999, GT at train size).

Examples:
  python scripts/eval_torch.py --dataset synthetic --ckpt_dir checkpoints
  python scripts/eval_torch.py --dataset synthetic --best --flip_tta --use_ema
  python scripts/eval_torch.py --dataset synthetic --stage 1 --device cpu \\
      --dtype float32      # CPU run of a tiny net trained on the CPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

A8 = "ROADMAP.md Queue A item 8 (data)"
A10 = "ROADMAP.md Queue A item 10 (parallel)"
A11 = "ROADMAP.md Queue A item 11 (int8 PTQ)"


def parse_args(argv=None):
    from gdn_tpu_torch.config import add_fused_kernel_flags

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", choices=["kitti", "nyu", "synthetic"], default="kitti",
                   help="preset and eval split; only synthetic data is ported")
    p.add_argument("--stage", choices=["1", "2"], default="2",
                   help="score the stage-2 G-net (default) or the stage-1 D-net's "
                        "reconstruction")
    p.add_argument("--ckpt_dir", type=str, default="checkpoints")
    p.add_argument("--best", action="store_true",
                   help="read <ckpt_dir>/stage2_best (train_torch.py --eval_every)")
    p.add_argument("--pth", type=str, default="",
                   help="score this exported .pth instead of a checkpoint; the flags "
                        "describe the model")
    p.add_argument("--height", type=int, default=None,
                   help="train height (default: the checkpoint's, else the preset's)")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16",
                   help="compute dtype of the conv stack")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    # the eval flags of gdn_tpu/cli.py::add_eval_args
    p.add_argument("--cap", type=float, default=None,
                   help="depth cap in meters (KITTI: 80 or 50; NYU: 10)")
    p.add_argument("--crop", choices=["garg", "eigen", "none"], default=None)
    p.add_argument("--calib_dir", type=str, default="",
                   help="KITTI calibration dir (velodyne GT; not ported)")
    p.add_argument("--median_scaling", action="store_true")
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--eval_batch", type=int, default=8,
                   help="images per eval step (metrics stay per-image)")
    p.add_argument("--save_preds", type=str, default="",
                   help="also save each image's predicted depth (.npy, train size, "
                        "named by dataset index) into this directory")
    p.add_argument("--flip_tta", action="store_true",
                   help="horizontal-flip test-time augmentation, one 2B-wide forward "
                        "(stage 2)")
    p.add_argument("--gt_wire", choices=["f32", "u16"], default=None,
                   help="GT upload format: u16 ships round(gt*256) counts, 1/4 the "
                        "bytes; f32 (default) is exact")
    p.add_argument("--rgb_wire", choices=["auto", "f32"], default=None,
                   help="RGB upload format: auto (default) ships bfloat16 when the "
                        "model computes in bfloat16 (bit-identical)")
    p.add_argument("--num_devices", type=int, default=1,
                   help="data-parallel eval over this many cards (only 1 is ported)")
    p.add_argument("--use_ema", action="store_true",
                   help="score the EMA weights of an --ema_decay training run")
    p.add_argument("--device_cache", action="store_true",
                   help="stage the whole split on the card first (wire format, "
                        "2 GiB gate; host-fed past it or on an allocation failure)")
    p.add_argument("--quantize", choices=["none", "int8"], default="none",
                   help="post-training int8 inference (not ported)")
    add_fused_kernel_flags(p)
    args = p.parse_args(argv)
    if args.dataset != "synthetic":
        p.error(f"--dataset {args.dataset}: the real-data loaders are not ported "
                f"yet ({A8}); use --dataset synthetic")
    if args.calib_dir:
        p.error(f"--calib_dir: velodyne GT is not ported yet ({A8})")
    if args.quantize != "none":
        p.error(f"--quantize {args.quantize}: not ported yet ({A11})")
    if args.use_ema and args.pth:
        p.error("--use_ema reads the EMA of a checkpoint directory; an exported .pth "
                "holds one set of weights (scripts/export_torch.py --use_ema exports "
                "a JAX run's EMA)")
    if args.num_devices != 1:
        p.error(f"--num_devices {args.num_devices}: not ported yet ({A10})")
    if args.stage == "1" and (args.best or args.flip_tta):
        p.error("--best and --flip_tta apply to --stage 2 only")
    return args


def build_config(args):
    from gdn_tpu_torch.config import fused_kernel_overrides, kitti_config

    over = {"model.use_pallas_gn": True, "model.dtype": args.dtype,
            "data.dataset": args.dataset, "eval.batch_size": args.eval_batch,
            "eval.median_scaling": args.median_scaling, **fused_kernel_overrides(args)}
    for field in ("cap", "crop", "gt_wire", "rgb_wire"):
        if getattr(args, field) is not None:
            over[f"eval.{field}"] = getattr(args, field)
    if args.height or args.width:
        h0, w0 = kitti_config().model.image_size
        over["model.image_size"] = (args.height or h0, args.width or w0)
    return kitti_config(**over)


def main(argv=None):
    args = parse_args(argv)

    from gdn_tpu_torch import kernels
    from gdn_tpu_torch.checkpoint import load_params, load_pth
    from gdn_tpu_torch.cli import apply_saved_model_config
    from gdn_tpu_torch.config import resolve_device
    from gdn_tpu_torch.data.synthetic import SyntheticEvalDataset
    from gdn_tpu_torch.evaluate import Stage1Split, evaluate
    from gdn_tpu_torch.models import DtoDNet, RtoDNet
    from gdn_tpu_torch.train.steps import make_eval_forward

    device = resolve_device(args.device)
    cfg = build_config(args)
    if args.pth:
        source, sd = args.pth, load_pth(args.pth)
    else:
        source = os.path.join(args.ckpt_dir, "stage1" if args.stage == "1"
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
    split = SyntheticEvalDataset(height=h, width=w, max_depth=cfg.model.max_depth,
                                 device=device)
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
