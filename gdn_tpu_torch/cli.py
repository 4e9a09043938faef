"""Command-line helpers of the port's scripts (port of
``gdn_tpu/cli.py``; so far the adoption of a checkpoint's config).
"""

from __future__ import annotations

import argparse
import dataclasses

from gdn_tpu_torch.checkpoint import load_config
from gdn_tpu_torch.config import Config


def apply_saved_model_config(cfg: Config, args: argparse.Namespace,
                             ckpt_dir: str) -> Config:
    """Adopt the ModelConfig saved next to a checkpoint
    (``<ckpt_dir>/config.json``), so eval, serve and resume rebuild the
    trained architecture without the training flags.

    Only the architecture is adopted: the execution fields
    (``_exec_field`` metadata: kernel routes, compute dtype) stay those
    of ``cfg``, the current environment.  Architecture flags given on
    the command line (``--height``, ``--width``, and the JAX CLI's
    ``--max_depth``, ``--upsample``, ``--deconv_init``, ``--norm``,
    ``--multiscale`` where a parser has them) win over the saved value,
    with a warning when they contradict it; so does ``--dtype``, which is
    an execution field.  Without config.json, ``cfg`` is returned as it
    is."""
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
