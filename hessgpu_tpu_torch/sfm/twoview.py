"""Two-view geometry: fundamental/essential estimation, pose recovery,
triangulation, PnP (counterpart of hessgpu_tpu/sfm/twoview.py).

RANSAC evaluates all hypotheses as one batched computation (batched minimal
solvers + one (H, N) residual matrix) instead of the classic sequential
loop. Each RANSAC is split into a sampler and a deterministic core
(`*_from_samples`) that takes the hypotheses' sample indices: the public
functions draw them from a torch.Generator on the host, and
sfm/incremental.py feeds the cores the JAX package's own draws
(sfm/prng.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..utils.precision import full_f32_matmul

_SQRT2 = math.sqrt(2.0)


class TwoViewResult(NamedTuple):
    F: torch.Tensor           # (3, 3) fundamental
    inliers: torch.Tensor     # (N,) bool
    num_inliers: torch.Tensor


class PnPResult(NamedTuple):
    R: torch.Tensor           # (3, 3)
    t: torch.Tensor           # (3,)
    inliers: torch.Tensor     # (N,) bool
    num_inliers: torch.Tensor


def _similarity(scale, mean):
    """Rows [s, 0, -s mx], [0, s, -s my], [0, 0, 1] for batched (...,)
    scale and (..., 2) mean."""
    zero = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    return torch.stack([
        torch.stack([scale, zero, -scale * mean[..., 0]], -1),
        torch.stack([zero, scale, -scale * mean[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)


def _normalize_points(pts):
    """Hartley normalization of (..., M, 2): zero mean, mean distance
    sqrt(2). Returns the points and the (..., 3, 3) transform."""
    mean = pts.mean(-2)
    centered = pts - mean[..., None, :]
    scale = _SQRT2 / (torch.linalg.vector_norm(centered, dim=-1).mean(-1)
                      + 1e-12)
    return centered * scale[..., None, None], _similarity(scale, mean)


def _design(n1, n2):
    """Epipolar constraint rows (..., M, 9) of normalized points."""
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                        torch.ones_like(x1)], -1)


def _rank2_null_vector(A):
    """F (..., 3, 3) from the right null vector of A (..., M, 9), its
    smallest singular value set to 0."""
    vt = torch.linalg.svd(A, full_matrices=True).Vh
    F = vt[..., -1, :].reshape(*A.shape[:-2], 3, 3)
    u, s, vt2 = torch.linalg.svd(F)
    s = s * s.new_tensor([1.0, 1.0, 0.0])
    return (u * s[..., None, :]) @ vt2


def _eight_point(p1, p2):
    """Normalized 8-point F of (..., M, 2) correspondences, rank 2, scaled
    so that F[2, 2] = 1."""
    n1, T1 = _normalize_points(p1)
    n2, T2 = _normalize_points(p2)
    F = T2.mT @ _rank2_null_vector(_design(n1, n2)) @ T1
    f22 = F[..., 2, 2]
    f22 = f22 + torch.where(f22.abs() < 1e-12, 1e-12, 0.0)
    return F / f22[..., None, None]


def eight_point(p1, p2):
    """Normalized 8-point fundamental estimate from >= 8 correspondences.

    p1, p2: (M, 2). Returns (3, 3) F with rank-2 enforcement."""
    with full_f32_matmul():
        return _eight_point(p1, p2)


def sampson_error(F, p1, p2):
    """Squared Sampson distance of each correspondence: (N,) for F (3, 3),
    (..., N) for a batch of F (..., 3, 3)."""
    ones = p1.new_ones((p1.shape[0], 1))
    x1 = torch.cat([p1, ones], 1)
    x2 = torch.cat([p2, ones], 1)
    with full_f32_matmul():
        Fx1 = x1 @ F.mT          # (..., N, 3)
        Ftx2 = x2 @ F            # (..., N, 3)
    num = (x2 * Fx1).sum(-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 \
        + Ftx2[..., 1] ** 2
    return num / (den + 1e-12)


def _draw(generator, valid, shape):
    """Indices (shape) drawn with replacement among the valid entries, on
    the host from `generator`, placed on valid's device."""
    probs = valid.to(torch.float64).cpu()
    idx = torch.multinomial(probs, math.prod(shape), replacement=True,
                            generator=generator)
    return idx.reshape(shape).to(valid.device)


def ransac_fundamental_from_samples(idx, p1, p2, valid,
                                    threshold: float = 2.0) -> TwoViewResult:
    """The deterministic core of ransac_fundamental: idx (H, 8) are the
    hypotheses' correspondence indices."""
    with full_f32_matmul():
        Fs = _eight_point(p1[idx], p2[idx])                 # (H, 3, 3)
        errs = sampson_error(Fs, p1, p2)                    # (H, N)
        thr2 = threshold * threshold
        inl = (errs < thr2) & valid[None, :]
        scores = inl.sum(1)
        best = torch.argmax(scores)

        # refit on the best hypothesis' inliers (weighted by mask)
        best_inl = inl[best]
        Ff = _weighted_eight_point(p1, p2, best_inl.to(p1.dtype))
        inl_f = (sampson_error(Ff, p1, p2) < thr2) & valid
        # keep the refit only if it didn't lose inliers
        better = inl_f.sum() >= scores[best]
        F = torch.where(better, Ff, Fs[best])
        inliers = torch.where(better, inl_f, best_inl)
    return TwoViewResult(F=F, inliers=inliers, num_inliers=inliers.sum())


def ransac_fundamental(p1, p2, valid, threshold: float = 2.0,
                       num_hypotheses: int = 512,
                       generator: Optional[torch.Generator] = None
                       ) -> TwoViewResult:
    """Batched RANSAC: all hypotheses evaluated in parallel.

    p1, p2: (N, 2) matched points; valid: (N,) bool mask (masked entries
    never become inliers and are never sampled). threshold: Sampson
    distance threshold in pixels. The 8-tuples are drawn with replacement
    (collisions make degenerate hypotheses that simply score poorly) from
    `generator`, a CPU torch.Generator."""
    idx = _draw(generator, valid, (num_hypotheses, 8))
    return ransac_fundamental_from_samples(idx, p1, p2, valid, threshold)


def _weighted_eight_point(p1, p2, wts):
    """Least-squares F from weighted correspondences (soft inlier refit)."""
    wsum = wts.sum() + 1e-12
    m1 = (wts[:, None] * p1).sum(0) / wsum
    m2 = (wts[:, None] * p2).sum(0) / wsum
    c1 = p1 - m1
    c2 = p2 - m2
    s1 = _SQRT2 / ((wts * torch.linalg.vector_norm(c1, dim=1)).sum() / wsum
                   + 1e-12)
    s2 = _SQRT2 / ((wts * torch.linalg.vector_norm(c2, dim=1)).sum() / wsum
                   + 1e-12)
    A = _design(c1 * s1, c2 * s2) * wts[:, None]
    F = _rank2_null_vector(A)
    return _similarity(s2, m2).T @ F @ _similarity(s1, m1)


# ---------------------------------------------------------------------------
# calibrated geometry
# ---------------------------------------------------------------------------

def essential_from_fundamental(F, K1, K2):
    with full_f32_matmul():
        E = K2.T @ F @ K1
        u, s, vt = torch.linalg.svd(E)
        # project to the essential manifold: singular values (1, 1, 0)
        return u @ torch.diag(E.new_tensor([1.0, 1.0, 0.0])) @ vt


def triangulate(P1, P2, p1, p2):
    """Linear (DLT) triangulation. P*: (3, 4) projections; p*: (N, 2).

    Returns (N, 3) points, each the null vector of its 4x4 normal
    equations (eigh of A^T A)."""
    A = torch.stack([
        p1[:, 0, None] * P1[2] - P1[0],
        p1[:, 1, None] * P1[2] - P1[1],
        p2[:, 0, None] * P2[2] - P2[0],
        p2[:, 1, None] * P2[2] - P2[1],
    ], 1)                                                  # (N, 4, 4)
    with full_f32_matmul():
        _, v = torch.linalg.eigh(A.mT @ A)
    X = v[..., 0]
    w = X[:, 3] + torch.where(X[:, 3].abs() < 1e-12, 1e-12, 0.0)
    return X[:, :3] / w[:, None]


def recover_pose(E, p1, p2, K1, K2, valid=None):
    """Decompose E into (R, t) resolving the 4-fold ambiguity by cheirality.

    p1, p2: (N, 2) pixel coordinates. Returns (R, t, points3d, front_mask).
    """
    W = E.new_tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    with full_f32_matmul():
        u, _, vt = torch.linalg.svd(E)
        # enforce proper rotations
        u = u * torch.sign(torch.linalg.det(u))
        vt = vt * torch.sign(torch.linalg.det(vt))
        R1 = u @ W @ vt
        R2 = u @ W.T @ vt
        t = u[:, 2]

        ones = p1.new_ones((p1.shape[0], 1))
        n1 = (torch.cat([p1, ones], 1) @ torch.linalg.inv_ex(K1)[0].T)[:, :2]
        n2 = (torch.cat([p2, ones], 1) @ torch.linalg.inv_ex(K2)[0].T)[:, :2]
        if valid is None:
            valid = torch.ones(p1.shape[0], dtype=torch.bool,
                               device=p1.device)

        P1 = torch.cat([torch.eye(3, dtype=E.dtype, device=E.device),
                        E.new_zeros((3, 1))], 1)
        Rs = torch.stack([R1, R1, R2, R2])
        ts = torch.stack([t, -t, t, -t])
        Xs, fronts = [], []
        for R, tt in zip(Rs, ts):
            X = triangulate(P1, torch.cat([R, tt[:, None]], 1), n1, n2)
            z2 = (X @ R.T + tt)[:, 2]
            fronts.append((X[:, 2] > 0) & (z2 > 0) & valid)
            Xs.append(X)
    fronts = torch.stack(fronts)
    best = torch.argmax(fronts.sum(1))
    return Rs[best], ts[best], torch.stack(Xs)[best], fronts[best]


def _dlt_pose6(X, x_norm):
    """6-point DLT poses [R|t] from 3D-2D (normalized) correspondences,
    batched: X (H, 6, 3), x_norm (H, 6, 2). Returns (R, t, ok), branch-free.
    """
    Xh = torch.cat([X, X.new_ones(X.shape[:-1] + (1,))], -1)   # (H, 6, 4)
    u_, v_ = x_norm[..., 0, None], x_norm[..., 1, None]
    zeros = torch.zeros_like(Xh)
    rows1 = torch.cat([zeros, -Xh, v_ * Xh], -1)
    rows2 = torch.cat([Xh, zeros, -u_ * Xh], -1)
    A = torch.cat([rows1, rows2], -2)                          # (H, 12, 12)
    vt = torch.linalg.svd(A, full_matrices=True).Vh
    P = vt[..., -1, :].reshape(*A.shape[:-2], 3, 4)
    um, sm, vtm = torch.linalg.svd(P[..., :3])
    d = torch.sign(torch.linalg.det(um @ vtm))
    diag = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
    R = um @ torch.diag_embed(diag) @ vtm
    scale = sm.mean(-1) * d
    ok = scale.abs() > 1e-12
    t = P[..., 3] / torch.where(ok, scale, torch.ones_like(scale))[..., None]
    return R, t, ok


def ransac_pnp_from_samples(idx, pts3d, pts2d, valid, K,
                            threshold: float = 8.0) -> PnPResult:
    """The deterministic core of ransac_pnp: idx (H, 6) are the
    hypotheses' correspondence indices."""
    with full_f32_matmul():
        ones = pts2d.new_ones((pts2d.shape[0], 1))
        norm2d = (torch.cat([pts2d, ones], 1)
                  @ torch.linalg.inv_ex(K)[0].T)[:, :2]
        Rs, ts, oks = _dlt_pose6(pts3d[idx], norm2d[idx])
        xc = pts3d @ Rs.mT + ts[:, None, :]                   # (H, N, 3)
        z = torch.clamp(xc[..., 2], min=1e-9)
        pix = (xc[..., :2] / z[..., None]) @ K[:2, :2].T + K[:2, 2]
    err = torch.linalg.vector_norm(pix - pts2d, dim=-1)
    errs = torch.where((xc[..., 2] > 0) & valid, err,
                       torch.full_like(err, float("inf")))
    inl = (errs < threshold) & oks[:, None]
    scores = inl.sum(1)
    best = torch.argmax(scores)
    return PnPResult(R=Rs[best], t=ts[best], inliers=inl[best],
                     num_inliers=scores[best])


def ransac_pnp(pts3d, pts2d, valid, K, threshold: float = 8.0,
               num_hypotheses: int = 256,
               generator: Optional[torch.Generator] = None) -> PnPResult:
    """Batched-hypothesis PnP: register a camera from 2D-3D matches.

    All hypotheses' 6-point DLTs run as one batch and score against the
    full correspondence set in a single (H, N) residual matrix - the same
    pattern as ransac_fundamental.

    pts3d: (N, 3) world points; pts2d: (N, 2) pixels; valid: (N,) mask;
    K: (3, 3) intrinsics. threshold: reprojection-error inlier gate (px).
    The 6-tuples are drawn from `generator`, a CPU torch.Generator."""
    idx = _draw(generator, valid, (num_hypotheses, 6))
    return ransac_pnp_from_samples(idx, pts3d, pts2d, valid, K, threshold)


def type_aware_match_mask(type1, type2):
    """Typed keypoints allow type-consistent matching: dark blobs match
    dark blobs, bright match bright, saddles match saddles.

    Returns (N1, N2) bool gate usable with matcher._match_core."""
    return type1[:, None] == type2[None, :]
