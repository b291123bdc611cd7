"""Benchmark sequence loading: TUM RGB-D format + trajectory files
(counterpart of hessgpu_tpu/sfm/datasets.py).

Harness for the ATE benchmark on a long sequence (TUM/KITTI). Parses the
standard TUM layout:

    rgb.txt               timestamp path
    groundtruth.txt       timestamp tx ty tz qx qy qz qw
    (associations by nearest timestamp)

and KITTI odometry poses (per-line 3x4 row-major matrices).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np


def _read_tum_table(path: str) -> List[Tuple[float, List[str]]]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            rows.append((float(parts[0]), parts[1:]))
    return rows


def quat_to_rot(qx, qy, qz, qw) -> np.ndarray:
    """Unit quaternion -> rotation matrix (TUM order: qx qy qz qw)."""
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)],
    ])


def load_tum_sequence(root: str, max_frames: Optional[int] = None,
                      stride: int = 1) -> Dict:
    """Load a TUM RGB-D sequence directory.

    Returns dict with image_paths, timestamps, and (if groundtruth.txt
    exists) gt_centers (N, 3) camera centers associated by timestamp.
    """
    rgb = _read_tum_table(os.path.join(root, "rgb.txt"))
    rgb = rgb[::stride]
    if max_frames:
        rgb = rgb[:max_frames]
    image_paths = [os.path.join(root, rest[0]) for _, rest in rgb]
    stamps = np.array([t for t, _ in rgb])

    out = {"image_paths": image_paths, "timestamps": stamps}

    gt_path = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt_path):
        gt = _read_tum_table(gt_path)
        gt_t = np.array([t for t, _ in gt])
        gt_vals = np.array([[float(v) for v in rest] for _, rest in gt])
        idx = np.searchsorted(gt_t, stamps)
        idx = np.clip(idx, 0, len(gt_t) - 1)
        out["gt_centers"] = gt_vals[idx, :3]
        out["gt_quats"] = gt_vals[idx, 3:7]
    return out


def load_kitti_poses(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI odometry poses file -> (R (N,3,3) cam->world, centers (N,3))."""
    mats = []
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if len(vals) != 12:
                continue
            mats.append(np.array(vals).reshape(3, 4))
    Rs = np.stack([m[:, :3] for m in mats])
    ts = np.stack([m[:, 3] for m in mats])
    return Rs, ts


def evaluate_sequence_ate(image_paths: List[str], gt_centers: np.ndarray,
                          K: Optional[np.ndarray] = None,
                          cfg=None, device="cuda", **sfm_kwargs) -> Dict:
    """Run the full engine on a sequence and report ATE vs ground truth.
    Detection and reconstruction run on `device` ("cuda" unless the CPU is
    asked for)."""
    from .. import HessianSift, SiftConfig
    from .evaluate import ate_rmse, camera_centers
    from .incremental import default_intrinsics, reconstruct_sequence
    from ..io_image import load_image

    cfg = cfg or SiftConfig()
    sift = HessianSift(cfg, device=device)
    feats = [sift.run(p) for p in image_paths]
    if K is None:
        img0 = load_image(image_paths[0])
        K = default_intrinsics(img0.shape[1], img0.shape[0])
    rec = reconstruct_sequence(feats, K, device=device, **sfm_kwargs)
    if rec is None:
        return {"ate": float("inf"), "registered": 0}
    est = camera_centers(rec.R, rec.t)
    # cameras map to original frame indices via view_ids (frames can be
    # skipped), so align each estimate with its own ground-truth pose
    ids = rec.view_ids or list(range(rec.num_cameras))
    sel = [(c, v) for c, v in enumerate(ids) if v < len(gt_centers)]
    cams = [c for c, _ in sel]
    views = [v for _, v in sel]
    return {
        "ate": ate_rmse(est[cams], gt_centers[views]),
        "registered": rec.num_cameras,
        "points": rec.num_points,
    }
