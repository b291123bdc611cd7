"""Per-keypoint orientation assignment: 36-bin gradient histograms
(counterpart of hessgpu_tpu/ops/orientation.py); the plain PyTorch version of
the orientation kernel (csrc/patch.cu).

Vectorized over keypoints: every valid keypoint gathers a static-size window
from its level and pixels outside its own support are masked, in absolute
level coordinates - the vote set does not depend on the window.

Semantics (ComputeOrientation_Kernel, ProgramCU.cu:1221-1645):
  * window radius win = |sigma| * (gaussian_factor * window_factor), weight
    grad * exp(-0.5 d^2 / (gaussian_factor * sigma)^2), cut at squared
    distance win^2 + 0.5.
  * integer pixels floor(p - win)..floor(p + win), clamped to [1, dim - 2].
  * 6 rounds of circular [1/3 1/3 1/3] smoothing, ((pre + cur) + nxt) / 3.
  * half-SIFT folds bins 18..35 into 0..17.
  * single: first-max argmax + parabolic refinement, full-precision theta.
  * multi: up to max_peaks <= 4 strict local maxima > peak_threshold * max,
    by vote descending (ties to the lowest bin), each quantized to 8 bits:
    theta = floor(frac * 255) * 2pi / 255. A keypoint whose histogram has no
    strict local maximum gets zero orientations and is dropped.

The arithmetic order of every expression is the order of the CUDA kernel.
Divisions by a constant divide by a 0-dim tensor: PyTorch's CUDA division by
a Python scalar multiplies by its reciprocal, which is not the same float.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .gather import LevelMaps, check_level_maps, window_gather

TWO_PI = 6.283185307179586
BINS_PER_RADIAN = 36.0 / TWO_PI  # 5.729577951308232
CHUNK = 256   # keypoints per gathered batch of windows


class OrientationResult(NamedTuple):
    thetas: torch.Tensor  # f32 (B, G, 4) device-frame orientations, 0 if unset
    valid: torch.Tensor   # bool (B, G, 4)
    votes: Optional[torch.Tensor] = None    # f32 (B, G, 36) smoothed, folded
    support: Optional[torch.Tensor] = None  # i32 (B, G) pixels that voted


def _const(ref: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=ref.dtype, device=ref.device)


def _histogram36(kx, ky, sigma, grad_win, rot_win, x0, y0, width, height,
                 gaussian_factor, window_factor):
    """36-bin weighted orientation histograms (K, 36) of K keypoints from
    their (K, ws, ws) windows at origins (y0, x0); width/height: (K,) float
    level sizes. Also returns the number of pixels that voted, (K,)."""
    wsize = grad_win.shape[-1]
    gsigma = sigma * gaussian_factor
    win = sigma.abs() * (gaussian_factor * window_factor)
    dist_threshold = (win * win + 0.5)[:, None, None]
    factor = (-0.5 / (gsigma * gsigma))[:, None, None]

    ar = torch.arange(wsize, dtype=torch.float32, device=kx.device)
    iy = y0[:, None, None] + ar[None, :, None]
    ix = x0[:, None, None] + ar[None, None, :]
    dx = (ix + 0.5) - kx[:, None, None]   # pixel centres
    dy = (iy + 0.5) - ky[:, None, None]
    sq = dx * dx + dy * dy

    def lo(k):
        return torch.floor(k - win).clamp(min=1.0)[:, None, None]

    def hi(k, dim):
        return torch.minimum(dim - 2.0, torch.floor(k + win))[:, None, None]

    in_range = ((ix >= lo(kx)) & (ix <= hi(kx, width))
                & (iy >= lo(ky)) & (iy <= hi(ky, height))
                & (sq < dist_threshold))

    obin = torch.floor(rot_win * BINS_PER_RADIAN).to(torch.int32)
    obin = torch.where(obin < 0, obin + 36, obin).clamp_(0, 35)
    weight = torch.where(in_range, grad_win * torch.exp(sq * factor), 0.0)
    zero = torch.zeros_like(weight)
    votes = torch.stack(
        [torch.where(obin == b, weight, zero).sum(dim=(1, 2))
         for b in range(36)], dim=1)
    return votes, in_range.sum(dim=(1, 2), dtype=torch.int32)


def _smooth6(votes: torch.Tensor) -> torch.Tensor:
    three = _const(votes, 3.0)
    for _ in range(6):
        votes = ((torch.roll(votes, 1, -1) + votes)
                 + torch.roll(votes, -1, -1)) / three
    return votes


def _single_peak(votes: torch.Tensor) -> torch.Tensor:
    """First-max argmax + parabolic refinement -> theta (K,) in radians."""
    imax = torch.argmax(votes, dim=-1, keepdim=True)   # ties: lowest index
    vmax = torch.gather(votes, -1, imax)
    pre = torch.gather(votes, -1, (imax + 35) % 36)
    nxt = torch.gather(votes, -1, (imax + 1) % 36)
    off = 0.5 * (nxt - pre) / (vmax + vmax - nxt - pre)
    theta = (imax.to(votes.dtype) + 0.5 + off) / _const(votes, BINS_PER_RADIAN)
    return theta[..., 0]


def _multi_peaks(votes: torch.Tensor, peak_threshold: float, max_peaks: int):
    """Up to max_peaks strict local maxima above threshold * max, by vote
    descending. Returns (thetas (K, 4), valid (K, 4)); 8-bit quantized."""
    pre = torch.roll(votes, 1, -1)
    nxt = torch.roll(votes, -1, -1)
    vmax = votes.max(dim=-1, keepdim=True).values
    is_peak = (votes > peak_threshold * vmax) & (votes > pre) & (votes > nxt)

    score = torch.where(is_peak, votes, -torch.inf)
    # a stable sort keeps the lower bin first among equal votes
    top_v, top_i = torch.sort(score, dim=-1, descending=True, stable=True)
    top_v, top_i = top_v[..., :4], top_i[..., :4]
    valid = torch.isfinite(top_v) & (
        torch.arange(4, device=votes.device) < max_peaks)

    prei = torch.gather(pre, -1, top_i)
    nxti = torch.gather(nxt, -1, top_i)
    vi = torch.gather(votes, -1, top_i)
    di = 0.5 * (nxti - prei) / (vi + vi - nxti - prei)
    rot = top_i.to(votes.dtype) + di + 0.5  # in bins

    frac = rot / _const(votes, 36.0)
    frac = torch.where(frac < 0, frac + 1.0, frac)
    thetas = torch.floor(frac * 255.0) * (TWO_PI / 255.0)
    return torch.where(valid, thetas, 0.0), valid


def peaks_from_votes(votes: torch.Tensor, single: bool = False,
                     peak_threshold: float = 0.8, max_peaks: int = 4):
    """Orientations (thetas (..., 4), valid (..., 4)) from smoothed, folded
    histograms (..., 36): the tail of the orientation stage."""
    if single or max_peaks <= 1:
        theta = _single_peak(votes)
        thetas = torch.zeros(votes.shape[:-1] + (4,), dtype=votes.dtype,
                             device=votes.device)
        thetas[..., 0] = theta
        valid = torch.zeros_like(thetas, dtype=torch.bool)
        valid[..., 0] = True
        return thetas, valid
    return _multi_peaks(votes, peak_threshold, min(max_peaks, 4))


def gather_levels(tables, level_id, flat, wsize: int, sel):
    """For the selected flat slots `sel` (int64 (K,)) of (B, G) tables (x, y
    first): the table values (K,) each, the two (K, ws, ws) windows around
    (y, x), their origins as floats and the level sizes as floats (the
    global height of a band). flat: LevelMaps.flat() of the maps that
    level_id indexes."""
    G = level_id.shape[-1]
    flat_grad, flat_rot, (lbase, lbstride, lh, lw, lrow0, lstep, lrows) = flat
    vals = [t.reshape(-1)[sel] for t in tables]
    lid = level_id.reshape(-1)[sel].to(torch.int64)
    b = torch.div(sel, G, rounding_mode="floor")
    base = lbase[lid] + b * lbstride[lid]
    h, w = lh[lid], lw[lid]
    row0 = lrow0[lid] + b * lstep[lid]
    rows = lrows[lid]
    gwin, y0, x0 = window_gather(flat_grad, base, h, w, vals[1], vals[0],
                                 wsize, row0, rows)
    rwin, _, _ = window_gather(flat_rot, base, h, w, vals[1], vals[0], wsize,
                               row0, rows)
    f = torch.float32
    return vals, gwin, rwin, x0.to(f), y0.to(f), w.to(f), h.to(f)


def valid_chunks(kvalid: torch.Tensor, chunk: int):
    """The flat indices of the valid slots, `chunk` at a time (reads the mask
    back to the host: the plain versions work on the valid slots only)."""
    idx = torch.nonzero(kvalid.reshape(-1))[:, 0]
    return idx.split(chunk) if idx.numel() else ()


def check_tables(name: str, maps: LevelMaps, level_id, *tables) -> None:
    check_level_maps(maps)
    if level_id.ndim != 2 or level_id.shape[0] != maps.batch:
        raise ValueError(f"{name}: tables must be (B, G) with B = "
                         f"{maps.batch}, got {tuple(level_id.shape)}")
    for t in tables:
        if t.shape != level_id.shape or t.device != maps.grad[0].device:
            raise ValueError(f"{name}: tables must share one (B, G) shape "
                             "and the maps' device")


def compute_orientations_flat(
    x, y, sigma, kvalid, level_id, maps: LevelMaps, wsize: int,
    gaussian_factor: float = 1.5, window_factor: float = 2.0,
    peak_threshold: float = 0.8, half_sift: bool = False,
    max_peaks: int = 4, single: bool = False,
) -> OrientationResult:
    """Cross-level orientation pass over (B, G) keypoint tables in level
    coordinates; level_id indexes maps' levels. wsize: static window size
    covering the largest support. Slots that are not valid give zeros."""
    check_tables("compute_orientations_flat", maps, level_id, x, y, sigma,
                 kvalid)
    B, G = x.shape
    dev = x.device
    thetas = torch.zeros((B * G, 4), dtype=torch.float32, device=dev)
    ovalid = torch.zeros((B * G, 4), dtype=torch.bool, device=dev)
    votes_out = torch.zeros((B * G, 36), dtype=torch.float32, device=dev)
    support = torch.zeros((B * G,), dtype=torch.int32, device=dev)
    flat = maps.flat()
    for sel in valid_chunks(kvalid, CHUNK):
        (kx, ky, ks), gwin, rwin, x0, y0, w, h = gather_levels(
            (x, y, sigma), level_id, flat, wsize, sel)
        votes, npix = _histogram36(kx, ky, ks, gwin, rwin, x0, y0, w, h,
                                   gaussian_factor, window_factor)
        votes = _smooth6(votes)
        if half_sift:
            votes = torch.cat([votes[:, :18] + votes[:, 18:],
                               torch.zeros_like(votes[:, 18:])], dim=1)
        th, ov = peaks_from_votes(votes, single, peak_threshold, max_peaks)
        thetas[sel], ovalid[sel] = th, ov
        votes_out[sel], support[sel] = votes, npix
    return OrientationResult(thetas.reshape(B, G, 4), ovalid.reshape(B, G, 4),
                             votes_out.reshape(B, G, 36),
                             support.reshape(B, G))
