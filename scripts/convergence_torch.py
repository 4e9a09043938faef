#!/usr/bin/env python
"""Convergence protocol of the PyTorch/CUDA port, the counterpart of
scripts/convergence.py: per seed, the two-stage pipeline on the
procedural synthetic data (D-net on ``SyntheticDataset(seed)``, the
decoder moved and frozen, the G-net on ``SyntheticDataset(seed +
1000)``), then the held-out ``SyntheticEvalDataset`` through the eval
protocol.  Prints one JSON line a seed (the 8-metric table, ``mins``
rounded as the JAX script does, ``seconds`` unrounded) and then the
``DONE`` line with ``a1_mean``.

The flags and defaults are the JAX script's (300 steps a stage, batch
16, lr 5e-4, 32x64, 30 eval images); ``--platform`` is ``--device``
here, and ``--dtype`` picks the compute dtype (bfloat16, the JAX
default).  Flags for what the port does not run yet (``--norm none``,
``--upsample deconv``, ``--multiscale``) are refused with their ROADMAP
item.

Examples:
  python scripts/convergence_torch.py --seeds 0 1 2
  python scripts/convergence_torch.py --seeds 0 --steps 3 --batch_size 2 \\
      --eval_images 2 --device cpu --dtype float32     # CPU smoke run
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--steps", type=int, default=300,
                   help="train steps PER STAGE (default 300 -> the 600-step protocol)")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--height", type=int, default=32)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--eval_images", type=int, default=30)
    p.add_argument("--norm", choices=["group", "none"], default="group")
    p.add_argument("--upsample", choices=["resize_conv", "deconv"], default=None)
    p.add_argument("--deconv_init", choices=["lecun", "bilinear"], default=None)
    p.add_argument("--multiscale", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    args = p.parse_args(argv)
    try:
        protocol_config(args, args.seeds[0])
    except NotImplementedError as e:
        p.error(str(e))
    return args


def protocol_config(args, seed: int):
    """The JAX script's Config for one seed, with the port's compute
    dtype and its GroupNorm+ELU kernel."""
    import dataclasses

    from gdn_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig

    model = ModelConfig(image_size=(args.height, args.width), norm=args.norm,
                        multiscale_heads=args.multiscale, dtype=args.dtype,
                        use_pallas_gn=True)
    if args.upsample:
        model = dataclasses.replace(model, upsample=args.upsample)
    if args.deconv_init:
        model = dataclasses.replace(model, deconv_init=args.deconv_init)
    return Config(model=model,
                  train=TrainConfig(ckpt_dir="", lr=args.lr, epochs=1,
                                    steps_per_epoch=args.steps, seed=seed, log_every=100),
                  data=DataConfig(batch_size=args.batch_size, dataset="synthetic"))


def main(argv=None):
    args = parse_args(argv)

    from gdn_tpu_torch.config import resolve_device
    from gdn_tpu_torch.data.synthetic import SyntheticDataset, SyntheticEvalDataset
    from gdn_tpu_torch.evaluate import evaluate
    from gdn_tpu_torch.train.loop import train_stage1, train_stage2
    from gdn_tpu_torch.train.steps import make_eval_forward

    device = resolve_device(args.device)
    h, w = args.height, args.width
    results = {}
    for seed in args.seeds:
        t0 = time.time()
        cfg = protocol_config(args, seed)
        d_data = SyntheticDataset(args.batch_size, h, w, cfg.model.max_depth, seed=seed,
                                  device=device)
        d_state = train_stage1(cfg, d_data, device=device)
        g_data = SyntheticDataset(args.batch_size, h, w, cfg.model.max_depth,
                                  seed=seed + 1000, device=device)
        g_state = train_stage2(cfg, g_data, d_state.net, device=device)
        eval_ds = SyntheticEvalDataset(args.eval_images, h, w, cfg.model.max_depth)
        m = evaluate(cfg, make_eval_forward(cfg, g_state.net), eval_ds, verbose=False,
                     device=device)
        results[seed] = {k: round(float(v), 4) for k, v in m.items()}
        seconds = time.time() - t0
        print(json.dumps({"seed": seed, "mins": round(seconds / 60, 1), "seconds": seconds,
                          "metrics": results[seed]}), flush=True)
    a1s = [results[s]["a1"] for s in results]
    done = {"DONE": True, "norm": args.norm, "upsample": cfg.model.upsample,
            "seeds": args.seeds, "a1_mean": round(sum(a1s) / len(a1s), 4),
            "per_seed": results}
    print(json.dumps(done), flush=True)
    return done


if __name__ == "__main__":
    main()
