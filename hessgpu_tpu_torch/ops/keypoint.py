"""Keypoint test: threshold, 3x3x3 NMS, edge rejection, subpixel refinement
and blob typing (counterpart of hessgpu_tpu/ops/keypoint.py); with
ops/hessian.py the plain version of the fused detect kernel (csrc/detect.cu).

Every test is evaluated for all pixels and combined with masks, with the
accept/reject semantics of ComputeKEY_Kernel (ProgramCU.cu:657-920):

  * |response| must exceed 0.8*T when subpixel localization is on (T else).
  * maxima: strictly greater than the left/right neighbours, >= the other 24
    neighbours of the 3x3x3 cube, and (Hessian personality) response >= 0;
    minima symmetrically.
  * edge rejection on the 2x2 Hessian of the response map:
    det <= 0 or trace^2 > ((e+1)^2/e) * det rejects.
  * subpixel: 3-variable Newton step by the symmetric adjugate solve; the
    refined response must exceed T and |dx|,|dy|,|ds| < 1. A degenerate
    system accepts the unrefined keypoint with zero offset.
  * type: saddle if response < 0, else dark/bright blob by the sign of Lxx
    of the *Gaussian* image (ProgramCU.cu:827-851).

All inputs may carry leading batch dimensions. Scalar constants are rounded
to float32 on the host (f32()), so the CUDA kernel, which receives the same
floats, compares against identical values.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .hessian import _shift

# Feature types (reference config.h:46-49)
TYPE_DARK_BLOB = 0
TYPE_BRIGHT_BLOB = 1
TYPE_SADDLE = 2
TYPE_NONE = 3


def f32(v: float) -> float:
    """A Python float that is exactly a float32 value."""
    return float(np.float32(v))


class KeypointMaps(NamedTuple):
    """Dense per-pixel detection results ("key map")."""
    valid: torch.Tensor      # bool (..., H, W)
    response: torch.Tensor   # f32 refined response, fp16-rounded, 0 off keys
    dx: torch.Tensor         # f32 subpixel offsets
    dy: torch.Tensor
    ds: torch.Tensor
    ftype: torch.Tensor      # i32 feature type (TYPE_*)


def _solve3_pivoted(a0, a1, a2):
    """Symmetric 3x3 solve A x = w by adjugate (Cramer).

    Each a* is a tuple of 4 same-shaped tensors (row coefficients + rhs) of
    the symmetric scale-space Hessian system. Keeps the name of the JAX
    function it mirrors. Returns (ok, dx, dy, ds): ok=False marks degenerate
    systems (|det| < 1e-30), whose offsets are zero - those pixels are
    accepted unrefined. A near-singular system is still inverted and its
    huge offsets fail the |offset| < 1 gate downstream.
    """
    a, b, c, r0 = a0
    d, e, r1 = a1[1], a1[2], a1[3]
    f, r2 = a2[2], a2[3]
    C00 = d * f - e * e
    C01 = c * e - b * f
    C02 = b * e - c * d
    det = a * C00 + b * C01 + c * C02
    ok = det.abs() >= f32(1e-30)
    rdet = torch.reciprocal(torch.where(ok, det, torch.ones_like(det)))
    s0 = r0 * rdet
    s1 = r1 * rdet
    s2 = r2 * rdet
    dx = C00 * s0 + C01 * s1 + C02 * s2
    C11 = a * f - c * c
    C12 = b * c - a * e
    dy = C01 * s0 + C11 * s1 + C12 * s2
    C22 = a * d - b * b
    ds = C02 * s0 + C12 * s1 + C22 * s2
    zero = torch.zeros_like(ds)
    return ok, torch.where(ok, dx, zero), torch.where(ok, dy, zero), \
        torch.where(ok, ds, zero)


def detect_keypoints_level(
    resp_prev: torch.Tensor,
    resp_cur: torch.Tensor,
    resp_next: torch.Tensor,
    gauss_cur: torch.Tensor,
    threshold: float,
    edge_threshold: float,
    subpixel: bool = True,
    hessian: bool = True,
    darkness_adaption: bool = False,
) -> KeypointMaps:
    """Run the keypoint test on one detection level. All inputs (..., H, W).

    darkness_adaption scales the threshold per pixel by
    min(2*intensity + 0.1, 1) so dark regions keep weaker keypoints
    (reference -da flag, GLSL shader ProgramGLSL.cpp:835-839).
    """
    h, w = resp_cur.shape[-2:]
    v = resp_cur
    if darkness_adaption:
        thr = f32(threshold) * torch.clamp(2.0 * gauss_cur + f32(0.1), max=1.0)
        thr0 = f32(0.8) * thr if subpixel else thr
    else:
        thr = f32(threshold)
        thr0 = f32(0.8 * threshold) if subpixel else thr

    # --- 3x3x3 neighbourhoods -------------------------------------------------
    def ring(x):
        """8 in-plane neighbours of x."""
        top, bot = _shift(x, -1, 0), _shift(x, 1, 0)
        return [_shift(top, 0, -1), top, _shift(top, 0, 1),
                _shift(x, 0, -1), _shift(x, 0, 1),
                _shift(bot, 0, -1), bot, _shift(bot, 0, 1)]

    tl, up, tr, left, right, bl, down, br = ring(v)

    rest = [up, down, tl, tr, bl, br]
    rest += ring(resp_prev) + [resp_prev]
    rest += ring(resp_next) + [resp_next]
    rest_max = rest[0]
    rest_min = rest[0]
    for x in rest[1:]:
        rest_max = torch.maximum(rest_max, x)
        rest_min = torch.minimum(rest_min, x)

    is_max = (v > torch.maximum(left, right)) & (v >= rest_max)
    is_min = (v < torch.minimum(left, right)) & (v <= rest_min)
    if hessian:
        # Hessian extrema must be sign-consistent (ProgramCU.cu:663-677)
        is_max = is_max & (v >= 0)
        is_min = is_min & (v <= 0)
    extremum = (v.abs() > thr0) & (is_max | is_min)

    # --- edge rejection on the response map ------------------------------------
    fx = 0.5 * (right - left)
    fy = 0.5 * (down - up)
    vx2 = 2.0 * v
    fxx = left + right - vx2
    fyy = up + down - vx2
    fxy = 0.25 * (br + tl - bl - tr)
    det2 = fxx * fyy - fxy * fxy
    trc = fxx + fyy
    tr2 = trc * trc
    te = f32((edge_threshold + 1.0) ** 2 / edge_threshold)
    extremum = extremum & (det2 > 0) & (tr2 <= te * det2)

    # --- subpixel refinement ---------------------------------------------------
    if subpixel:
        cn = resp_next
        cp = resp_prev
        fs = 0.5 * (cn - cp)
        fss = cn + cp - vx2
        fxs = 0.25 * (_shift(cn, 0, 1) + _shift(cp, 0, -1)
                      - _shift(cn, 0, -1) - _shift(cp, 0, 1))
        fys = 0.25 * (_shift(cn, 1, 0) + _shift(cp, -1, 0)
                      - _shift(cn, -1, 0) - _shift(cp, 1, 0))

        ok, dx, dy, ds = _solve3_pivoted(
            (fxx, fxy, fxs, -fx),
            (fxy, fyy, fys, -fy),
            (fxs, fys, fss, -fs),
        )
        refined = v + 0.5 * (dx * fx + dy * fy + ds * fs)
        response = torch.where(ok, refined, v)
        passed = (response.abs() > thr) & (ds.abs() < 1.0) \
            & (dx.abs() < 1.0) & (dy.abs() < 1.0)
        # degenerate solve: accept unrefined (reference behavior)
        extremum = extremum & (~ok | passed)
    else:
        dx = dy = ds = torch.zeros_like(v)
        response = v

    # --- interior-only (row/col in [1, dim-2]) ---------------------------------
    rows = torch.arange(h, device=v.device).reshape(-1, 1)
    cols = torch.arange(w, device=v.device).reshape(1, -1)
    interior = (rows > 0) & (rows < h - 1) & (cols > 0) & (cols < w - 1)
    valid = extremum & interior

    # --- blob type -------------------------------------------------------------
    if hessian:
        g_lxx = (_shift(gauss_cur, 0, -1) - 2.0 * gauss_cur
                 + _shift(gauss_cur, 0, 1))
        ftype = torch.where(g_lxx > 0, TYPE_DARK_BLOB, TYPE_BRIGHT_BLOB)
        ftype = torch.where(response < 0, TYPE_SADDLE, ftype)
    else:
        # DoG personality: maxima are bright blobs, minima dark
        # (GPU_SIFT_MODIFIED branch, ProgramCU.cu:852-853)
        ftype = torch.where(is_max, TYPE_BRIGHT_BLOB, TYPE_DARK_BLOB)
    ftype = torch.where(valid, ftype, TYPE_NONE).to(torch.int32)

    # The reference stores the response as fp16 in the key map
    # (ProgramCU.cu:865); top-K and file output see the quantized value.
    response = response.to(torch.float16).to(torch.float32)
    response = torch.where(valid, response, torch.zeros_like(response))

    return KeypointMaps(valid=valid, response=response,
                        dx=dx, dy=dy, ds=ds, ftype=ftype)
