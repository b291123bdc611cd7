"""Two-view geometry: fundamental/essential estimation, pose recovery,
triangulation, PnP (counterpart of hessgpu_tpu/sfm/twoview.py).

RANSAC evaluates all hypotheses as one batched computation (batched minimal
solvers + one (H, N) residual matrix) instead of the classic sequential
loop. Each RANSAC is split into a sampler and a deterministic core
(`*_from_samples`) that takes the hypotheses' sample indices: the public
functions draw them from a torch.Generator on the host, and
sfm/incremental.py feeds the cores the JAX package's own draws
(sfm/prng.py).

The two cores are the JAX package's jitted ransac_fundamental and
ransac_pnp: on the card each replays one captured CUDA graph per
(threshold, the shapes, the device). Their SVDs go by the tensor's device
(_null_vector, _svd3): on the card to the kernels of csrc/linalg.cu
(ops/cuda/linalg.py: Jacobi stopped on the card, reading nothing back to the
host, so a core is one graph, eager route and replay alike); on the CPU to
torch.linalg.svd, the LAPACK of the JAX package's CPU run - or, with
PLAIN_JACOBI_ON_CPU set (a test seam), to the kernels' plain versions
(ops/linalg.py). A fundamental RANSAC's N follows the data (its draws
depend on N, so it is not padded), so its key is captured at its second
call and its first runs eagerly; PnP's correspondences are padded to
powers of two by the caller and captured at the first call. On the CPU,
and inside utils.graphs.disable_graphs(), the cores run eagerly.
ransac_fundamental_from_samples.clear_cache() and
ransac_pnp_from_samples.clear_cache() free their graphs.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..ops import linalg
from ..ops.cuda import linalg as cuda_linalg
from ..utils.graphs import GraphCache, graphs_enabled
from ..utils.precision import full_f32_matmul

_SQRT2 = math.sqrt(2.0)

# The bytes the captured RANSAC programs may reserve, each core its own
# cache, the least recently used dropped first (PERF.md, chip_smoke.py's
# compiled phase).
RANSAC_GRAPH_BYTES = 1 << 30
_RANSAC_F_GRAPHS = GraphCache(RANSAC_GRAPH_BYTES, capture_at=2)
_PNP_GRAPHS = GraphCache(RANSAC_GRAPH_BYTES)

# the tests' seam: CPU tensors' SVDs through the card kernels' plain
# versions (ops/linalg.py) instead of LAPACK
PLAIN_JACOBI_ON_CPU = False


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


def _null_vector(A):
    """(..., n): the unit right singular vector of the smallest singular
    value of each (M, n) matrix of A (..., M, n) - the last row of its full
    SVD's Vh, up to sign."""
    if A.is_cuda:
        return cuda_linalg.null_vector(A)
    if PLAIN_JACOBI_ON_CPU:
        return linalg.null_vector_plain(A)
    return torch.linalg.svd(A, full_matrices=True).Vh[..., -1, :]


def _svd3(A):
    """(U, S, Vh) of each 3 x 3 matrix of A (..., 3, 3)."""
    if A.is_cuda:
        return cuda_linalg.svd3(A)
    if PLAIN_JACOBI_ON_CPU:
        return linalg.svd3_plain(A)
    return tuple(torch.linalg.svd(A))


def _rank2_null_vector(A):
    """F (..., 3, 3) from the right null vector of A (..., M, 9), its
    smallest singular value set to 0."""
    F = _null_vector(A).reshape(*A.shape[:-2], 3, 3)
    u, s, vt2 = _svd3(F)
    keep = s.new_ones(3)
    keep[2:].fill_(0.0)      # a fill: assigning a float would copy it in
    s = s * keep
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


def _at(x, i):
    """x[i] for a 0-d index tensor i, without reading i back to the host
    (indexing by a 0-d tensor does, which no capture can hold)."""
    return x[i.reshape(1)][0]


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
    hypotheses' correspondence indices. On the card: the graphs of
    _ransac_fundamental_core for (threshold, the shapes), captured at the
    key's second call."""
    with full_f32_matmul():
        if p1.is_cuda and graphs_enabled(_RANSAC_F_GRAPHS):
            return _RANSAC_F_GRAPHS(
                (float(threshold),),
                lambda *a: _ransac_fundamental_core(*a, threshold),
                idx, p1, p2, valid)
        return _ransac_fundamental_core(idx, p1, p2, valid, threshold)


def _ransac_fundamental_core(idx, p1, p2, valid, threshold):
    """The body of ransac_fundamental_from_samples, run with TF32 off."""
    Fs = _eight_point(p1[idx], p2[idx])                     # (H, 3, 3)
    errs = sampson_error(Fs, p1, p2)                        # (H, N)
    thr2 = threshold * threshold
    inl = (errs < thr2) & valid[None, :]
    scores = inl.sum(1)
    best = torch.argmax(scores)

    # refit on the best hypothesis' inliers (weighted by mask)
    best_inl = _at(inl, best)
    Ff = _weighted_eight_point(p1, p2, best_inl.to(p1.dtype))
    inl_f = (sampson_error(Ff, p1, p2) < thr2) & valid
    # keep the refit only if it didn't lose inliers
    better = inl_f.sum() >= _at(scores, best)
    F = torch.where(better, Ff, _at(Fs, best))
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
    batched: X (H, 6, 3), x_norm (H, 6, 2). Returns (R, t, ok, scale),
    branch-free; a negative scale (the null vector's sign) gives a wrong R,
    as in the JAX package (ROADMAP, reference-side caveats).
    """
    Xh = torch.cat([X, X.new_ones(X.shape[:-1] + (1,))], -1)   # (H, 6, 4)
    u_, v_ = x_norm[..., 0, None], x_norm[..., 1, None]
    zeros = torch.zeros_like(Xh)
    rows1 = torch.cat([zeros, -Xh, v_ * Xh], -1)
    rows2 = torch.cat([Xh, zeros, -u_ * Xh], -1)
    A = torch.cat([rows1, rows2], -2)                          # (H, 12, 12)
    P = _null_vector(A).reshape(*A.shape[:-2], 3, 4)
    um, sm, vtm = _svd3(P[..., :3])
    d = torch.sign(torch.linalg.det(um @ vtm))
    diag = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
    R = um @ torch.diag_embed(diag) @ vtm
    scale = sm.mean(-1) * d
    ok = scale.abs() > 1e-12
    t = P[..., 3] / torch.where(ok, scale, torch.ones_like(scale))[..., None]
    return R, t, ok, scale


def pnp_hypotheses(idx, pts3d, pts2d, K):
    """Every hypothesis of ransac_pnp_from_samples: (R, t, ok, scale) of the
    6-point DLTs over the correspondences idx (H, 6)."""
    ones = pts2d.new_ones((pts2d.shape[0], 1))
    norm2d = (torch.cat([pts2d, ones], 1)
              @ torch.linalg.inv_ex(K)[0].T)[:, :2]
    return _dlt_pose6(pts3d[idx], norm2d[idx])


def ransac_pnp_from_samples(idx, pts3d, pts2d, valid, K,
                            threshold: float = 8.0) -> PnPResult:
    """The deterministic core of ransac_pnp: idx (H, 6) are the
    hypotheses' correspondence indices. On the card: the graphs of
    _ransac_pnp_core for (threshold, the shapes)."""
    with full_f32_matmul():
        if pts3d.is_cuda and graphs_enabled(_PNP_GRAPHS):
            return _PNP_GRAPHS(
                (float(threshold),),
                lambda *a: _ransac_pnp_core(*a, threshold),
                idx, pts3d, pts2d, valid, K)
        return _ransac_pnp_core(idx, pts3d, pts2d, valid, K, threshold)


def _ransac_pnp_core(idx, pts3d, pts2d, valid, K, threshold):
    """The body of ransac_pnp_from_samples, run with TF32 off."""
    Rs, ts, oks, _ = pnp_hypotheses(idx, pts3d, pts2d, K)
    xc = pts3d @ Rs.mT + ts[:, None, :]                       # (H, N, 3)
    z = torch.clamp(xc[..., 2], min=1e-9)
    pix = (xc[..., :2] / z[..., None]) @ K[:2, :2].T + K[:2, 2]
    err = torch.linalg.vector_norm(pix - pts2d, dim=-1)
    errs = torch.where((xc[..., 2] > 0) & valid, err,
                       torch.full_like(err, float("inf")))
    inl = (errs < threshold) & oks[:, None]
    scores = inl.sum(1)
    best = torch.argmax(scores)
    return PnPResult(R=_at(Rs, best), t=_at(ts, best),
                     inliers=_at(inl, best), num_inliers=_at(scores, best))


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


ransac_fundamental_from_samples.clear_cache = _RANSAC_F_GRAPHS.clear
ransac_pnp_from_samples.clear_cache = _PNP_GRAPHS.clear


def type_aware_match_mask(type1, type2):
    """Typed keypoints allow type-consistent matching: dark blobs match
    dark blobs, bright match bright, saddles match saddles.

    Returns (N1, N2) bool gate usable with matcher._match_core."""
    return type1[:, None] == type2[None, :]
