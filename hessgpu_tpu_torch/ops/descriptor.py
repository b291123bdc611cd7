"""SIFT descriptor computation: rotated 4x4 cell grid, 8 orientation bins
(counterpart of hessgpu_tpu/ops/descriptor.py); the plain PyTorch version of
the descriptor kernel (csrc/patch.cu) and the tensor code around it.

Each keypoint gathers ONE static window covering all 16 cells and every
pixel's contribution is distributed to cells/bins by bilinear weights. The
per-cell Gaussian weight exp(-0.125 * (u^2 + v^2)) depends only on the
pixel's position in the descriptor frame, and the cell bound |n| < 1 plus
the interior clamp [1, dim - 2] are per-pixel conditions in absolute level
coordinates, so the pixel set does not depend on the window.

Semantics (ComputeDescriptor_Kernel, ProgramCU.cu:1650-1948, and
NormalizeDescriptor, ProgramCU.cu:1950-2103):
  * cell spacing spt = |sigma * window_factor|, window_factor = 3.0.
  * rotated sampling frame via (cos, sin) of the keypoint orientation.
  * bilinear over cell coordinates, linear over 8 orientation bins with
    circular wrap.
  * half-SIFT folds 8 bins to 4.
  * normalization: L2 -> clamp 0.2 -> L2.
  * rect (unrotated) variant for rectangle description.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .gather import LevelMaps
from .orientation import CHUNK, check_tables, gather_levels, valid_chunks

PI = math.pi


def descriptor_window_size(max_sigma: float, window_factor: float = 3.0) -> int:
    """Static gather window size covering the full 4x4 descriptor support.

    Support half-extent: cells span [-2, 2]*spt in the rotated frame; the
    union bounding box of per-cell windows is <= 2.5*sqrt(2)*spt + 1.
    """
    spt = abs(max_sigma * window_factor)
    r = int(math.ceil(2.5 * math.sqrt(2.0) * spt + 1.0)) + 1
    return 2 * r + 1


def _cell_bin_sums(cu, cv, theta_pix, weight):
    """(K, 16, 8) sums over the window of ay * ax (bilinear cell weights of
    cell coordinates cu, cv) times the two-bin orientation weights of
    theta_pix in [0, 8) times weight; all inputs (K, ws, ws)."""
    K = cu.shape[0]
    fo = torch.floor(theta_pix)
    ob = fo.to(torch.int64).clamp_(0, 7)      # guard the fp edge at 8.0
    w2 = theta_pix - fo                       # weight of bin ob + 1
    w1 = 1.0 - w2

    cells = torch.arange(4, dtype=torch.float32, device=cu.device)
    # |c - cell| < 1 guard = the reference's |nx| < 1
    ax = (1.0 - (cu.reshape(K, -1, 1) - cells).abs()).clamp_(min=0.0)
    ay = (1.0 - (cv.reshape(K, -1, 1) - cells).abs()).clamp_(min=0.0)

    bins = torch.arange(8, device=cu.device)
    obf = ob.reshape(K, -1, 1)
    o_mat = (w1.reshape(K, -1, 1) * (obf == bins)
             + w2.reshape(K, -1, 1) * (((obf + 1) % 8) == bins))
    o_mat = o_mat * weight.reshape(K, -1, 1)                      # (K, P, 8)

    # desc[cy, cx, b] = sum_p ay[p, cy] * ax[p, cx] * o_mat[p, b]
    spatial = (ay[:, :, :, None] * ax[:, :, None, :]).reshape(K, -1, 16)
    return torch.matmul(spatial.transpose(1, 2), o_mat)          # (K, 16, 8)


def _pixel_grid(x0, y0, wsize: int):
    ar = torch.arange(wsize, dtype=torch.float32, device=x0.device)
    iy = y0[:, None, None] + ar[None, :, None]
    ix = x0[:, None, None] + ar[None, None, :]
    return ix, iy


def _interior(ix, iy, width, height):
    return ((ix >= 1.0) & (ix <= (width - 2.0)[:, None, None])
            & (iy >= 1.0) & (iy <= (height - 2.0)[:, None, None]))


def _descriptor_windows(kx, ky, sigma, theta, grad_win, rot_win, x0, y0,
                        width, height, window_factor):
    """Raw (K, 16, 8) descriptors [cell cy * 4 + cx, bin] of K keypoints from
    their (K, ws, ws) windows at origins (y0, x0), and the number of pixels
    that contributed, (K,)."""
    k3 = lambda a: a[:, None, None]
    ix, iy = _pixel_grid(x0, y0, grad_win.shape[-1])
    dx = (ix + 0.5) - k3(kx)
    dy = (iy + 0.5) - k3(ky)

    spt = (sigma * window_factor).abs()
    crspt = k3(torch.cos(theta) / spt)
    srspt = k3(torch.sin(theta) / spt)
    # cell-frame coordinates: u along descriptor x, v along descriptor y
    u = crspt * dx + srspt * dy
    v = crspt * dy - srspt * dx
    anglef = k3(torch.where(theta > PI, theta - 2.0 * PI, theta))
    gauss_w = torch.exp(-0.125 * (u * u + v * v))

    # cell coordinates in [-0.5, 3.5]: cell i accepts |cu - i| < 1
    cu = u + 1.5
    cv = v + 1.5
    in_support = (cu > -1.0) & (cu < 4.0) & (cv > -1.0) & (cv < 4.0)
    mask = _interior(ix, iy, width, height) & in_support

    theta_pix = (anglef - rot_win) * (4.0 / PI)
    theta_pix = torch.where(theta_pix < 0, theta_pix + 8.0, theta_pix)
    weight = torch.where(mask, gauss_w * grad_win, 0.0)
    return (_cell_bin_sums(cu, cv, theta_pix, weight),
            mask.sum(dim=(1, 2), dtype=torch.int32))


def compute_descriptors_flat(
    x, y, sigma, theta, kvalid, level_id, maps: LevelMaps, wsize: int,
    window_factor: float = 3.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-level descriptor pass over (B, G) keypoint tables in level
    coordinates: raw, unnormalized (B, G, 16, 8) descriptors (zeros on slots
    that are not valid; finalize_descriptors folds and normalizes) and the
    number of contributing pixels (B, G) i32."""
    check_tables("compute_descriptors_flat", maps, level_id, x, y, sigma,
                 theta, kvalid)
    B, G = x.shape
    desc = torch.zeros((B * G, 16, 8), dtype=torch.float32, device=x.device)
    support = torch.zeros((B * G,), dtype=torch.int32, device=x.device)
    # bound the gathered working set: the (K, P, 16) cell weights dominate
    chunk = max(1, min(CHUNK, (1 << 27) // (wsize * wsize * 16)))
    flat = maps.flat()
    for sel in valid_chunks(kvalid, chunk):
        (kx, ky, ks, kt), gwin, rwin, x0, y0, w, h = gather_levels(
            (x, y, sigma, theta), level_id, flat, wsize, sel)
        desc[sel], support[sel] = _descriptor_windows(
            kx, ky, ks, kt, gwin, rwin, x0, y0, w, h, window_factor)
    return desc.reshape(B, G, 16, 8), support.reshape(B, G)


def _descriptor_rect_windows(kx, ky, rw, rh, grad_win, rot_win, x0, y0,
                             width, height):
    """Unrotated rectangle descriptors (ComputeDescriptorRECT_Kernel,
    ProgramCU.cu:1811-1948): 4x4 cells tile the rectangle whose top-left
    corner is (kx, ky) and size is (rw, rh); no Gaussian weighting, no
    rotation; orientation bins relative to angle 0."""
    k3 = lambda a: a[:, None, None]
    ix, iy = _pixel_grid(x0, y0, grad_win.shape[-1])
    # cell i accepts |(p - pt_i) / spt| < 1 with pt_i = k + (i + 0.5) * spt
    # =>  cu = (px - kx) / sptx - 0.5
    cu = (((ix + 0.5) - k3(kx)) / k3(rw * 0.25) - 0.5).expand_as(grad_win)
    cv = (((iy + 0.5) - k3(ky)) / k3(rh * 0.25) - 0.5).expand_as(grad_win)
    in_support = (cu > -1.0) & (cu < 4.0) & (cv > -1.0) & (cv < 4.0)
    mask = _interior(ix, iy, width, height) & in_support

    theta_pix = (-rot_win) * (4.0 / PI)
    theta_pix = torch.where(theta_pix < 0, theta_pix + 8.0, theta_pix)
    weight = torch.where(mask, grad_win, 0.0)
    return _cell_bin_sums(cu, cv, theta_pix, weight)


def compute_descriptors_rect(
    x, y, rect_w, rect_h, kvalid, grad: torch.Tensor, rot: torch.Tensor,
    wsize: int, half_sift: bool = False, normalize: bool = True,
) -> torch.Tensor:
    """Rect descriptors for one level's rectangle list ((K,) geometry, (H, W)
    maps): (K, 128) or (K, 64). The window is centred on the rectangle's
    centre, placed inside the image, and - as in the JAX package - bounds
    the pixels that count."""
    height, width = grad.shape
    wsize = min(wsize, height, width)
    half = (wsize - 1) / 2.0
    y0 = torch.floor(y + rect_h * 0.5 - half).to(torch.int64) \
        .clamp_(0, max(height - wsize, 0))
    x0 = torch.floor(x + rect_w * 0.5 - half).to(torch.int64) \
        .clamp_(0, max(width - wsize, 0))
    ar = torch.arange(wsize, device=grad.device)
    idx = ((y0[:, None] + ar)[:, :, None] * width
           + (x0[:, None] + ar)[:, None, :])
    K = x.shape[0]
    dims = lambda v: torch.full((K,), float(v), device=grad.device)
    raw = _descriptor_rect_windows(
        x, y, rect_w, rect_h, grad.reshape(-1)[idx], rot.reshape(-1)[idx],
        x0.to(torch.float32), y0.to(torch.float32), dims(width), dims(height))
    return finalize_descriptors(raw, kvalid, half_sift, normalize)


def normalize_descriptors(desc: torch.Tensor,
                          kvalid: Optional[torch.Tensor] = None):
    """L2-normalize -> clamp at 0.2 -> renormalize (ProgramCU.cu:1983-2008)
    over the last axis of (..., D) descriptors."""
    eps = 1e-12
    n1 = torch.rsqrt((desc * desc).sum(dim=-1, keepdim=True) + eps)
    d = (desc * n1).clamp(max=0.2)
    n2 = torch.rsqrt((d * d).sum(dim=-1, keepdim=True) + eps)
    out = d * n2
    if kvalid is not None:
        out = torch.where(kvalid[..., None], out, 0.0)
    return out


def finalize_descriptors(raw: torch.Tensor, kvalid: torch.Tensor,
                         half_sift: bool, normalize: bool) -> torch.Tensor:
    """Mask + half-SIFT fold + normalize the raw (..., 16, 8) cell/bin tables
    of the descriptor stage -> (..., 128), or (..., 64) with half_sift."""
    d = torch.where(kvalid[..., None, None], raw, 0.0)
    if half_sift:
        d = d[..., :4] + d[..., 4:]
    d = d.flatten(-2)
    return normalize_descriptors(d, kvalid) if normalize else d
