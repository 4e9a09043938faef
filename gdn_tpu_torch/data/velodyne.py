"""KITTI velodyne -> depth map (port of ``gdn_tpu/data/velodyne.py``;
numpy, run once an eval image on the host).

Velodyne points X_v map into camera-2 pixels through
P = P_rect_02 @ R_rect_00 @ Tr_velo_to_cam; where several points land
in one pixel the nearest wins.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np


def load_velodyne_points(path: str) -> np.ndarray:
    """(N, 4) float32 x, y, z, reflectance."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def read_calib_file(path: str) -> Dict[str, np.ndarray]:
    """{key: float64 values} of a KITTI calibration file; lines that do
    not parse as numbers (dates) are skipped."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            try:
                out[key.strip()] = np.asarray([float(x) for x in value.split()],
                                              dtype=np.float64)
            except ValueError:
                pass
    return out


def projection_matrix(calib_dir: str, cam: int = 2) -> np.ndarray:
    """(3, 4) projection from velodyne to the image plane of ``cam``."""
    c2c = read_calib_file(os.path.join(calib_dir, "calib_cam_to_cam.txt"))
    v2c = read_calib_file(os.path.join(calib_dir, "calib_velo_to_cam.txt"))
    tr = np.eye(4)
    tr[:3, :3] = v2c["R"].reshape(3, 3)
    tr[:3, 3] = v2c["T"]
    r_rect = np.eye(4)
    r_rect[:3, :3] = c2c["R_rect_00"].reshape(3, 3)
    p_rect = c2c[f"P_rect_0{cam}"].reshape(3, 4)
    return p_rect @ r_rect @ tr


def depth_from_velodyne(points: np.ndarray, proj: np.ndarray,
                        shape: Tuple[int, int]) -> np.ndarray:
    """(H, W) float32 depth in meters (0: no return) of (N, 4) velodyne
    points; the nearest point wins a pixel."""
    h, w = shape
    pts = points[points[:, 0] > 1.0]  # in front of the sensor
    hom = np.hstack([pts[:, :3], np.ones((len(pts), 1))])
    cam = hom @ proj.T
    z = cam[:, 2]
    valid = z > 1e-3
    cam, z = cam[valid], z[valid]
    # KITTI convention: round to the pixel, then 1-based -> 0-based
    u = np.round(cam[:, 0] / z) - 1
    v = np.round(cam[:, 1] / z) - 1
    inside = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    u, v, z = u[inside].astype(np.int64), v[inside].astype(np.int64), z[inside]
    depth = np.zeros((h, w), dtype=np.float32)
    # farthest first, so nearer points overwrite; argsort(-z) decides ties
    order = np.argsort(-z)
    depth[v[order], u[order]] = z[order]
    return depth


def depth_from_velodyne_files(velo_path: str, calib_dir: str, shape: Tuple[int, int],
                              cam: int = 2) -> np.ndarray:
    proj = projection_matrix(calib_dir, cam)
    return depth_from_velodyne(load_velodyne_points(velo_path), proj, shape)
