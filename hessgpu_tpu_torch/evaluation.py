"""Detector quality evaluation: repeatability under known homographies (the
port's counterpart of hessgpu_tpu/evaluation.py, over its HessianSift).

The reference claims Hessian extrema are more repeatable than DoG and that
saddle points improve coverage (README.md:8-19, CVWW'16 paper). This module
quantifies repeatability the standard way (Mikolajczyk protocol,
simplified): warp an image by a known homography, detect on both, and count
keypoints whose mapped position lands within eps of a detection in the
warped image (with a scale-consistency gate).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def warp_image(img: np.ndarray, H: np.ndarray,
               out_shape: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Inverse-warp img by homography H (maps src -> dst coords).

    Bilinear sampling, zeros outside. img: (H, W) float.
    """
    h, w = img.shape[:2]
    oh, ow = out_shape or (h, w)
    ys, xs = np.mgrid[0:oh, 0:ow].astype(np.float64)
    ones = np.ones_like(xs)
    Hinv = np.linalg.inv(H)
    src = np.stack([xs, ys, ones], -1) @ Hinv.T
    sx = src[..., 0] / src[..., 2]
    sy = src[..., 1] / src[..., 2]

    x0 = np.floor(sx).astype(int)
    y0 = np.floor(sy).astype(int)
    fx = sx - x0
    fy = sy - y0
    valid = (x0 >= 0) & (x0 < w - 1) & (y0 >= 0) & (y0 < h - 1)
    x0c = np.clip(x0, 0, w - 2)
    y0c = np.clip(y0, 0, h - 2)
    v = (img[y0c, x0c] * (1 - fx) * (1 - fy)
         + img[y0c, x0c + 1] * fx * (1 - fy)
         + img[y0c + 1, x0c] * (1 - fx) * fy
         + img[y0c + 1, x0c + 1] * fx * fy)
    return np.where(valid, v, 0.0).astype(np.float32)


def rotation_homography(angle_deg: float, h: int, w: int,
                        scale: float = 1.0) -> np.ndarray:
    """Rotation (+ scale) about the image center."""
    a = np.radians(angle_deg)
    c, s = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = w / 2.0, h / 2.0
    T1 = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]])
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    T2 = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1.0]])
    return T2 @ R @ T1


def repeatability(feats_a: Dict, feats_b: Dict, H: np.ndarray,
                  shape_b: Tuple[int, int], eps: float = 2.5,
                  scale_ratio: float = 1.5, border: int = 10) -> float:
    """Fraction of A-keypoints (mapped into B and inside its borders) with a
    B-keypoint within eps pixels and consistent scale."""
    xa = np.stack([feats_a["x"], feats_a["y"],
                   np.ones_like(feats_a["x"])], 1) @ H.T
    pa = xa[:, :2] / xa[:, 2:3]
    sa = feats_a["sigma"] * np.sqrt(max(np.linalg.det(H[:2, :2]), 1e-12))

    hb, wb = shape_b
    inside = ((pa[:, 0] > border) & (pa[:, 0] < wb - border)
              & (pa[:, 1] > border) & (pa[:, 1] < hb - border))
    if inside.sum() == 0:
        return 0.0
    pa = pa[inside]
    sa = sa[inside]

    pb = np.stack([feats_b["x"], feats_b["y"]], 1)
    sb = feats_b["sigma"]
    d2 = ((pa[:, None, :] - pb[None, :, :]) ** 2).sum(-1)
    sr = np.maximum(sa[:, None], sb[None, :]) / \
        np.minimum(sa[:, None] + 1e-9, sb[None, :] + 1e-9)
    hit = ((d2 < eps * eps) & (sr < scale_ratio)).any(axis=1)
    return float(hit.mean())


def evaluate_repeatability(image: np.ndarray, cfg=None,
                           angles=(10, 30, 60), scales=(1.0, 0.8),
                           device="cuda") -> Dict:
    """Detect on an image and its warps (on `device`); report mean
    repeatability."""
    import torch

    from .config import SiftConfig
    from .detector import HessianSift
    from .ops.resize import rgb_to_gray

    cfg = cfg or SiftConfig()
    sift = HessianSift(cfg, device=device)
    if image.ndim == 3:
        image = rgb_to_gray(torch.from_numpy(
            image.astype(np.float32) / 255.0)).numpy()
    base = sift.run(image)
    h, w = image.shape
    scores = {}
    for ang in angles:
        for sc in scales:
            H = rotation_homography(ang, h, w, sc)
            warped = warp_image(image, H)
            fb = sift.run(warped)
            scores[(ang, sc)] = repeatability(base, fb, H, warped.shape)
    scores["mean"] = float(np.mean([v for k, v in scores.items()
                                    if k != "mean"]))
    return scores
