"""Separable Gaussian filtering: the plain PyTorch versions of the blur and
octave-chain kernels (counterpart of hessgpu_tpu/ops/gaussian.py).

Each 1-D pass is written as explicit shifted weighted adds, accumulated left
to right in float32: out = t[0]*x[0:] ; out = out + t[k]*x[k:] - the tap
order of the CUDA kernels (csrc/conv.cu) and of the TPU kernel they replace
(hessgpu_tpu/ops/pallas/conv.py blur_pallas). No F.conv1d/2d: on the card
those run through cuDNN, in TF32 by default, and in another summation
order; with the adds written out, kernel and plain version agree bit for
bit.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..params import ScaleSpaceParams, gaussian_taps


def taps_f32(taps: Sequence[float]) -> np.ndarray:
    """Tap vector rounded to float32 once, on the host; kernels and plain
    versions both consume exactly these values."""
    return np.asarray(taps, dtype=np.float32)


def conv1d_clamped(x: torch.Tensor, taps: Sequence[float], axis: int) -> torch.Tensor:
    """1-D convolution along `axis` with clamp-to-edge borders
    (reference filter kernels, ProgramCU.cu:117-231). x: (..., H, W) f32."""
    t = taps_f32(taps)
    r = len(t) // 2
    n = x.shape[axis]
    idx = torch.arange(-r, n + r, device=x.device).clamp_(0, n - 1)
    xp = x.index_select(axis, idx)
    out = float(t[0]) * xp.narrow(axis, 0, n)
    for k in range(1, len(t)):
        out = out + float(t[k]) * xp.narrow(axis, k, n)
    return out


def blur_taps(x: torch.Tensor, taps: Sequence[float]) -> torch.Tensor:
    """Separable blur with a given tap vector: horizontal pass, then
    vertical pass over the horizontal result."""
    x = conv1d_clamped(x, taps, axis=x.ndim - 1)
    return conv1d_clamped(x, taps, axis=x.ndim - 2)


def blur(x: torch.Tensor, sigma: float, filter_width_factor: float = 4.0) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W)."""
    if sigma <= 0.0:
        return x
    return blur_taps(x, gaussian_taps(sigma, filter_width_factor))


def octave_chain_taps(base: torch.Tensor,
                      taps_list: Sequence[Sequence[float]]) -> torch.Tensor:
    """Chained blurs: level l+1 = blur(level l, taps_list[l]), clamp-to-edge
    at every level (empty taps = identity). base (..., H, W) ->
    (..., 1 + len(taps_list), H, W)."""
    levels = [base]
    for tp in taps_list:
        levels.append(blur_taps(levels[-1], tp) if len(tp) else levels[-1])
    return torch.stack(levels, dim=-3)


def build_octave_chain(base: torch.Tensor, params: ScaleSpaceParams) -> torch.Tensor:
    """One octave's Gaussian stack by chained incremental blurs (reference
    PyramidCU::BuildPyramid, PyramidCU.cpp:1542-1548). base: (..., H, W)
    already at level_min. Returns (..., num_levels, H, W)."""
    return octave_chain_taps(base, chain_taps(params))


def chain_taps(params: ScaleSpaceParams):
    """Per-transition tap vectors of one octave (empty = identity)."""
    return [gaussian_taps(s, params.filter_width_factor) if s > 0 else ()
            for s in params.incremental_sigmas()]


def direct_taps(params: ScaleSpaceParams):
    """Per-level tap vectors from the octave base (conv_mode="direct"; empty
    = identity, level 0)."""
    return [gaussian_taps(s, params.filter_width_factor) if s > 0 else ()
            for s in params.direct_sigmas()]


def octave_direct_taps(base: torch.Tensor,
                       taps_list: Sequence[Sequence[float]]) -> torch.Tensor:
    """Independent blurs of one base: level l = blur(base, taps_list[l])
    (empty taps = identity). base (..., H, W) -> (..., len(taps_list), H, W).
    With direct_taps(params) it is hessgpu_tpu/ops/gaussian.py
    build_octave_direct, which pads the taps to one width and runs one
    grouped XLA convolution: the same function, the terms summed in another
    order."""
    return torch.stack([blur_taps(base, tp) if len(tp) else base
                        for tp in taps_list], dim=-3)
