"""Trajectory evaluation: Umeyama alignment + ATE (TUM convention); the
port's own copy of hessgpu_tpu/sfm/evaluate.py (NumPy only).
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = True):
    """Least-squares similarity transform aligning src -> dst ((N, 3) each).

    Returns (s, R, t) with dst ~ s * R @ src + t.
    """
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    u, d, vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        S[2, 2] = -1
    R = u @ S @ vt
    var_s = (xs ** 2).sum() / len(src)
    s = float(np.trace(np.diag(d) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def camera_centers(Rs, ts) -> np.ndarray:
    """World-frame camera centers from world->camera (R, t): C = -R^T t."""
    return np.stack([-R.T @ t for R, t in zip(Rs, ts)])


def ate_rmse(est_centers: np.ndarray, gt_centers: np.ndarray,
             with_scale: bool = True) -> float:
    """Absolute trajectory error after similarity alignment (TUM metric)."""
    s, R, t = umeyama_alignment(est_centers, gt_centers, with_scale)
    aligned = (s * (R @ est_centers.T)).T + t
    return float(np.sqrt(((aligned - gt_centers) ** 2).sum(1).mean()))
