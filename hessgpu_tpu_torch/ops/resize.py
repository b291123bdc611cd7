"""Image resampling and input conversion (counterpart of
hessgpu_tpu/ops/resize.py).

  * downsample: decimation by 2^k taking every 2^k-th pixel from (0, 0)
    (reference DownsampleKernel / SampleImageD, ProgramCU.cu:312-367). The
    pyramid's by-2 decimation on the card is the downsample2 kernel
    (ops/cuda/conv.py); this is the general strided view.
  * rgb_to_gray / to_float: BT.601 luminance and u8 -> f32 scaling
    (ProgramCU.cu:369-421).

upsample (first_octave < 0) is not ported yet.
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


def rgb_to_gray(x: torch.Tensor) -> torch.Tensor:
    """(H, W, 3|4) -> (H, W) luminance."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    return _LUMA[0] * r + _LUMA[1] * g + _LUMA[2] * b


def to_float(x: torch.Tensor) -> torch.Tensor:
    """u8 [0,255] -> f32 [0,1]; other input passed through as f32."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    return x.to(torch.float32)
