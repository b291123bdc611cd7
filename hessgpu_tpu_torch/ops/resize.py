"""Image resampling and input conversion (counterpart of
hessgpu_tpu/ops/resize.py).

  * downsample: decimation by 2^k taking every 2^k-th pixel from (0, 0)
    (reference DownsampleKernel / SampleImageD, ProgramCU.cu:312-367). The
    pyramid's by-2 decimation on the card is the downsample2 kernel
    (ops/cuda/conv.py); this is the general strided view.
  * upsample: corner-aligned x2^k upsample for first_octave < 0 (reference
    UpsampleKernel / SampleImageU, ProgramCU.cu:233-310).
  * rgb_to_gray / to_float: BT.601 luminance and u8 -> f32 scaling
    (ProgramCU.cu:369-421).
"""

from __future__ import annotations

import torch

# BT.601 luminance weights (reference ProgramCU.cu:381)
_LUMA = (0.299, 0.587, 0.114)


def downsample(x: torch.Tensor, log_scale: int = 1) -> torch.Tensor:
    """Decimate (..., H, W) by 2**log_scale, keeping pixels at multiples of
    the step (a strided view, ceil sizes for odd dims)."""
    s = 1 << log_scale
    return x[..., ::s, ::s]


def upsample(x: torch.Tensor, log_scale: int = 1) -> torch.Tensor:
    """Bilinear upsample of (..., H, W) by 2**log_scale, corner-aligned like
    the reference: pixel (2r, 2c) copies (r, c), odd rows and columns are
    midpoint blends (src = dst / 2, clamped at the edges). Not
    F.interpolate's half-pixel convention. The f32 expressions are the JAX
    package's, so the two agree bit for bit."""
    for _ in range(log_scale):
        h, w = x.shape[-2], x.shape[-1]
        lead = x.shape[:-2]
        r = torch.cat([x[..., :, 1:], x[..., :, -1:]], dim=-1)
        d = torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)
        dr = torch.cat([d[..., :, 1:], d[..., :, -1:]], dim=-1)
        top = torch.stack([x, 0.5 * (x + r)], dim=-1).reshape(*lead, h, 2 * w)
        bot = torch.stack([0.5 * (x + d), 0.25 * (x + r + d + dr)],
                          dim=-1).reshape(*lead, h, 2 * w)
        x = torch.stack([top, bot], dim=-2).reshape(*lead, 2 * h, 2 * w)
    return x


def rgb_to_gray(x: torch.Tensor) -> torch.Tensor:
    """(H, W, 3|4) -> (H, W) luminance."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    return _LUMA[0] * r + _LUMA[1] * g + _LUMA[2] * b


def to_float(x: torch.Tensor) -> torch.Tensor:
    """u8 [0,255] -> f32 [0,1]; other input passed through as f32.

    u8 values go through a table of the 256 quotients v / 255, divided on
    the host: PyTorch's CUDA division by a scalar multiplies by its
    reciprocal, which misses the IEEE quotient (the JAX package's) on 126
    of the 256 values."""
    if x.dtype == torch.uint8:
        table = torch.arange(256, dtype=torch.float32) / 255.0
        return table.to(x.device)[x.long()]
    return x.to(torch.float32)
