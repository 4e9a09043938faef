"""Demo and inference (port of ``gdn_tpu/demo.py``): single images,
directories or frame sequences -> colorized depth maps and a GIF.

The G-net runs at the model's train size; each prediction is resized
back to its input frame's size (``ops.resize.resize_bilinear``, fp32)
and colorized by inverse depth (``ops.colormap.colorize_depth``).
Runs on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch
from PIL import Image

from gdn_tpu_torch.config import Config, resolve_device
from gdn_tpu_torch.models import RtoDNet
from gdn_tpu_torch.ops.colormap import colorize_depth
from gdn_tpu_torch.ops.resize import resize_bilinear

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp")
VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def list_inputs(path: str) -> List[str]:
    if os.path.isdir(path):
        return sorted(os.path.join(path, f) for f in os.listdir(path)
                      if f.lower().endswith(IMAGE_EXTS))
    return [path]


def iter_frames(path: str):
    """Yield (name, rgb uint8 HWC) for an image file, a directory of
    frames, or a video file (read with imageio)."""
    if os.path.isfile(path) and path.lower().endswith(VIDEO_EXTS):
        import imageio.v3 as iio

        for i, frame in enumerate(iio.imiter(path)):
            yield f"frame{i:05d}", np.asarray(frame)[..., :3]
        return
    for p in list_inputs(path):
        yield (os.path.splitext(os.path.basename(p))[0],
               np.asarray(Image.open(p).convert("RGB")))


def _resize_hw(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of an (H, W, C) tensor's (H, W) axes, in fp32."""
    return resize_bilinear(x.permute(2, 0, 1)[None], tuple(size))[0].permute(1, 2, 0)


class DepthPredictor:
    """RGB -> depth at the input's size.  ``params``: the G-net's
    state_dict, or the RtoDNet itself.  ``flip_tta``: horizontal-flip
    test-time averaging in one forward of two images."""

    def __init__(self, cfg: Config, params: Union[Dict[str, torch.Tensor], torch.nn.Module],
                 flip_tta: bool = False, device=None):
        from gdn_tpu_torch.train.steps import make_eval_forward

        self.cfg = cfg
        self.device = resolve_device(device)
        if isinstance(params, torch.nn.Module):
            net = params
        else:
            net = RtoDNet(cfg.model)
            net.load_state_dict(params, strict=True)
        self.net = net.to(self.device).eval()
        if self.device.type == "cuda":
            from gdn_tpu_torch import kernels

            kernels.load_all()
        self._fwd = make_eval_forward(cfg, self.net, flip_tta=flip_tta)

    def __call__(self, rgb: np.ndarray) -> np.ndarray:
        """rgb (H, W, 3) float in [0, 1] or uint8 -> depth (H, W) meters."""
        if rgb.dtype == np.uint8:
            rgb = rgb.astype(np.float32) / 255.0
        h, w = rgb.shape[:2]
        x = torch.from_numpy(np.ascontiguousarray(rgb, np.float32)).to(self.device)
        x = _resize_hw(x, self.cfg.model.image_size)[None]
        depth = self._fwd(x)[0]  # (th, tw, 1) fp32
        return _resize_hw(depth, (h, w))[..., 0].cpu().numpy()


def run_demo(cfg: Config, params, input_path: str, output_dir: str,
             gif: Optional[str] = None, cmap: str = "magma", side_by_side: bool = True,
             flip_tta: bool = False, device=None) -> List[str]:
    """Predict depth for every input frame; write colorized PNGs
    (``<name>_depth.png``: the frame above its depth when
    ``side_by_side``) and optionally an animated GIF.  Returns the
    written paths."""
    os.makedirs(output_dir, exist_ok=True)
    predictor = DepthPredictor(cfg, params, flip_tta=flip_tta, device=device)
    written, frames = [], []
    for name, rgb in iter_frames(input_path):
        color = colorize_depth(predictor(rgb), cfg.model.max_depth, cmap)
        frame = np.concatenate([rgb, color], axis=0) if side_by_side else color
        out_path = os.path.join(output_dir, name + "_depth.png")
        Image.fromarray(frame).save(out_path)
        written.append(out_path)
        frames.append(frame)
    if gif and frames:
        gif_path = gif if os.path.isabs(gif) else os.path.join(output_dir, gif)
        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(gif_path, save_all=True, append_images=imgs[1:], duration=100, loop=0)
        written.append(gif_path)
    return written
