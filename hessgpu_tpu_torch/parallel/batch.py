"""Batched detect + describe (counterpart of hessgpu_tpu/parallel/batch.py).

One device: the whole batch rides the kernels' batch dimension. Sharding a
batch over several GPUs (the JAX package's mesh= argument) is not ported
yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import SiftConfig
from ..features import FeatureTable
from ..pyramid import make_plan, resolve_device, run_pipeline_batched


def detect_batch(images, cfg: Optional[SiftConfig] = None,
                 device="cuda", plain: bool = False) -> FeatureTable:
    """Detect and describe keypoints in a batch of same-sized grayscale
    images.

    images: (B, H, W) float32 in [0, 1], a NumPy array or a tensor (moved to
    `device` if it lies elsewhere), taken as octave 0's input as given: for
    first_octave != 0 the caller resamples (ops.resize.upsample, or a
    strided slice), as with the JAX package's detect_batch.
    device="cuda" without a card raises.
    plain=True runs the kernels' plain PyTorch versions instead (a check,
    not a fallback).
    Returns a batched FeatureTable (leading dim B) on `device`: N slots per
    frame, N = global_feature_cap, or expansion_factor times that when a
    keypoint may get several orientations; desc (B, N, descriptor_dim).
    """
    cfg = cfg or SiftConfig()
    device = resolve_device(device)
    if isinstance(images, np.ndarray):
        images = torch.from_numpy(np.ascontiguousarray(images, np.float32))
    arr = images.to(device=device, dtype=torch.float32)
    if arr.ndim != 3:
        raise ValueError(f"detect_batch: expected (B, H, W), got "
                         f"{tuple(arr.shape)}")
    _, h, w = arr.shape
    plan = make_plan(h, w, cfg)
    return run_pipeline_batched(arr, plan, cfg, plain)[0]
