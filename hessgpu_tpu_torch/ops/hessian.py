"""Det-of-Hessian / DoG response and gradient stencils (counterpart of
hessgpu_tpu/ops/hessian.py); with ops/keypoint.py the plain version of the
fused detect kernel (csrc/detect.cu).

Boundary semantics: neighbours outside the image read the clamped pixel.
The detector never accepts border keypoints, so this equals the reference's
texture reads wherever it matters.

The arithmetic order of every expression here is the order of the CUDA
kernel; the two are held equal bit for bit on the card.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """result[..., r, c] = x[..., clamp(r + dy), clamp(c + dx)]."""
    if dy:
        h = x.shape[-2]
        rows = (torch.arange(h, device=x.device) + dy).clamp_(0, h - 1)
        x = x.index_select(-2, rows)
    if dx:
        w = x.shape[-1]
        cols = (torch.arange(w, device=x.device) + dx).clamp_(0, w - 1)
        x = x.index_select(-1, cols)
    return x


def _grad_rot(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """0.5*|grad| and atan2(dy, dx) of Gaussian planes (..., H, W); the
    angle is 0 where the magnitude is."""
    dx = _shift(g, 0, 1) - _shift(g, 0, -1)
    dy = _shift(g, 1, 0) - _shift(g, -1, 0)
    mag = 0.5 * torch.sqrt(dx * dx + dy * dy)
    rot = torch.where(mag == 0.0, torch.zeros_like(mag), torch.atan2(dy, dx))
    return mag, rot


def hessian_response_and_gradient(
    gauss: torch.Tensor, norms: Sequence[float],
    grad_levels: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-level normalized det-of-Hessian response and gradients.

    gauss: (..., L, H, W) Gaussian stack (leading batch dims allowed).
    norms: per-level normalization = level_sigma^4 (the reference passes
           sigma^2 and squares it in the kernel, ProgramCU.cu:592).
    grad_levels: level indices that get gradient/orientation maps; None =
    all. Other levels get zero maps.
    Returns (response, grad_mag, grad_rot), each (..., L, H, W).
    """
    v12 = _shift(gauss, -1, 0)   # row above
    v32 = _shift(gauss, 1, 0)    # row below
    v21 = _shift(gauss, 0, -1)   # left
    v23 = _shift(gauss, 0, 1)    # right
    v11 = _shift(v12, 0, -1)
    v13 = _shift(v12, 0, 1)
    v31 = _shift(v32, 0, -1)
    v33 = _shift(v32, 0, 1)

    lxx = v21 - 2.0 * gauss + v23
    lyy = v12 - 2.0 * gauss + v32
    lxy = (v13 - v11 + v31 - v33) * 0.25

    norm = torch.tensor([float(n) for n in norms], dtype=gauss.dtype,
                        device=gauss.device).reshape(-1, 1, 1)
    response = (lxx * lyy - lxy * lxy) * norm

    L = gauss.shape[-3]
    levels = list(range(L)) if grad_levels is None \
        else sorted({int(l) for l in grad_levels})
    grad = torch.zeros_like(gauss)
    rot = torch.zeros_like(gauss)
    if levels:
        mag, ang = _grad_rot(gauss[..., levels, :, :])
        grad[..., levels, :, :] = mag
        rot[..., levels, :, :] = ang
    return response, grad, rot


def dog_response_and_gradient(
    gauss: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DoG personality: response[l] = gauss[l+1] - gauss[l]; gradients from
    gauss[l+1] (reference ComputeDOG_Kernel, ProgramCU.cu:599-653).

    gauss: (..., L, H, W); returns (..., L-1, H, W) tensors.
    """
    cur = gauss[..., 1:, :, :]
    dog = cur - gauss[..., :-1, :, :]
    grad, rot = _grad_rot(cur)
    return dog, grad, rot
