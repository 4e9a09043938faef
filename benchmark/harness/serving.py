"""What the serving cells share: the port's predictor built from the
seed's weights, and the comparison of what it answered with the
reference's depth of the same frames."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from harness import inputs
from harness.core import Run, program_config


def g_params(run: Run):
    return inputs.make_nets_params(run.cfgj, run.seed, run.device)[1]


def predictor(run: Run, g_p, batch: int, control: bool = False, calib=None):
    """The port's ``BatchedPredictor`` at ``batch``.  ``control``: its
    int8 path (``model.quant="int8"``), calibrated on ``calib`` (uint8
    frames), the port's own lower precision."""
    from gdn_tpu_torch.serving import BatchedPredictor

    if not control:
        return BatchedPredictor(program_config(run.cfgj, batch), g_p, batch, run.device)
    from gdn_tpu_torch.models import RtoDNet
    from gdn_tpu_torch.ops.quant import calibrate_quant

    cfg = program_config(run.cfgj, batch, {"quant": "int8"})
    with torch.device(run.device):
        net = RtoDNet(cfg.model)
    net.load_state_dict(g_p, strict=True)
    scales = calibrate_quant(net.eval(), [torch.from_numpy(c).float() / 255.0 for c in calib])
    return BatchedPredictor(cfg, g_p, batch, run.device, quant_scales=scales)


def reference_depth(run: Run, g_p, pool: np.ndarray, idx: List[int],
                    precision: str = "fp32") -> Dict[int, np.ndarray]:
    """{pool index: the reference's depth (H, W) in meters}."""
    from reference.model import predict_depth, reference_mode

    idx = sorted(set(idx))
    frames = torch.from_numpy(pool[idx]).to(run.device)
    with reference_mode():
        depth = predict_depth(g_p, frames, run.cfgj, precision).cpu().numpy()
    return dict(zip(idx, depth))


def _errors(answers: List[Tuple[int, np.ndarray]], ref: Dict[int, np.ndarray]) -> np.ndarray:
    """Every pixel's gap in meters of the answers kept (pool index, uint16
    depth*256 counts as served) to the reference's depth."""
    return np.concatenate([np.abs(a.astype(np.float32) / 256.0 - ref[i]).ravel()
                           for i, a in answers])


def gaps(answers: List[Tuple[int, np.ndarray]], ref: Dict[int, np.ndarray]) -> Dict[str, float]:
    """The compared numbers: the widest pixel gap and the 99th percentile
    pixel gap, in meters.  (A mean gap tells the control apart less well:
    §6 of PERF.md.)"""
    err = _errors(answers, ref)
    return {"depth_max_gap_m": float(err.max()), "depth_p99_gap_m": float(np.percentile(err, 99))}


def look(answers: List[Tuple[int, np.ndarray]], ref: Dict[int, np.ndarray]) -> Dict[str, float]:
    """Other statistics of the same gaps: the mean and root mean square
    over every pixel, and the worst frame's mean."""
    err = _errors(answers, ref)
    worst = max(float(np.abs(a.astype(np.float32) / 256.0 - ref[i]).mean()) for i, a in answers)
    return {"mean_m": float(err.mean()), "rms_m": float(np.sqrt(np.square(err).mean())),
            "worst_frame_mean_m": worst}
