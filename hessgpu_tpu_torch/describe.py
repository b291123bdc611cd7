"""Descriptor service for externally supplied keypoints (counterpart of
hessgpu_tpu/describe.py).

Equivalent of RunSIFT(num, keys, has_orientation) - the keypoint-list
re-entry path (reference SiftGPU.cpp:307-315, SiftPyramid::SetKeypointList
SiftPyramid.cpp:326-355, PyramidCU::GenerateFeatureListTex
PyramidCU.cpp:555-718). SfM systems use it to compute descriptors at
externally detected or tracked locations.

Keypoints are binned to (octave, level) by scale on the host, as the
reference does. Everything after that is one (1, N) table in input order
through the same orientation and descriptor stages as the detection
pipeline: the kernels on the card, their plain versions on the CPU.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from .config import SiftConfig
from .ops.descriptor import compute_descriptors_rect
from .ops.gather import LevelMaps
from .pyramid import (GlobalTable, _build_pyramid, describe_table,
                      key_level_gradients, orient_table, prepare_input,
                      window_sizes)

TWO_PI = 2.0 * math.pi


def _pyramid_gradients(image: np.ndarray, cfg: SiftConfig, device,
                       plain: bool):
    """Build the pyramid and return (plan, cfg, LevelMaps of the per-(octave,
    key level) gradient maps, batch 1). Reference: BuildPyramid +
    ComputeGradient (PyramidCU.cpp:1736-1790)."""
    arr, plan, cfg = prepare_input(image, cfg, device)
    octaves = _build_pyramid(arr[None], plan, cfg, plain)
    grads, rots = zip(*(key_level_gradients(g, cfg, plain) for g in octaves))
    return plan, cfg, LevelMaps(tuple(grads), tuple(rots))


def _bin_by_scale(scale: np.ndarray, num_octaves: int, cfg: SiftConfig):
    """Host-side binning by scale (GenerateFeatureListTex semantics): the
    level id o * s + key index of every entry, and 2^octave * 2^first_octave
    of its level."""
    p = cfg.scale_params()
    s = p.num_scales
    shalf = 2.0 ** (0.5 / s)
    assigned = np.full(scale.shape[0], -1, np.int32)
    octave_sigma = 2.0 ** cfg.first_octave
    for o in range(num_octaves):
        for li, kl in enumerate(p.key_levels):
            level_sigma = p.key_level_sigma(kl) * octave_sigma
            smin, smax = level_sigma / shalf, level_sigma * shalf
            sel = (scale >= smin) & (scale < smax)
            if o == 0 and li == 0:
                sel |= scale < smin
            if o == num_octaves - 1 and li == s - 1:
                sel |= scale >= smax
            sel &= assigned < 0
            assigned[sel] = o * s + li
        octave_sigma *= 2.0
    osig = (2.0 ** (assigned // s).astype(np.float32)) \
        * 2.0 ** cfg.first_octave
    return assigned, osig


def describe_keypoints(
    image: np.ndarray,
    keys: np.ndarray,
    cfg: Optional[SiftConfig] = None,
    has_orientation: bool = True,
    device="cuda",
    plain: bool = False,
) -> Dict[str, np.ndarray]:
    """Compute SIFT descriptors (and optionally orientations) for given
    keypoints on an image.

    image: grayscale (H, W) float/uint8 or RGB (H, W, 3).
    keys: (N, >=3) columns x, y, sigma[, theta] in image coordinates.
    has_orientation: if False (or no theta column), the strongest
    orientation is computed per keypoint (reference: SKIP_ORIENTATION unset).
    device="cuda" without a card raises; plain=True runs the kernels' plain
    PyTorch versions (a check, not a fallback).

    Returns dict with x, y, sigma, theta, desc as NumPy arrays in the
    ORIGINAL input order.
    """
    cfg = cfg or SiftConfig()
    plan, cfg, maps = _pyramid_gradients(image, cfg, device, plain)
    dev = maps.grad[0].device

    keys = np.asarray(keys, np.float32)
    n = keys.shape[0]
    kx, ky, ks = keys[:, 0], keys[:, 1], keys[:, 2]
    skip_orientation = has_orientation and keys.shape[1] > 3
    kt = keys[:, 3] if skip_orientation else np.zeros(n, np.float32)
    out = {"x": kx, "y": ky, "sigma": ks, "theta": np.zeros(n, np.float32),
           "desc": np.zeros((n, cfg.descriptor_dim), np.float32)}
    if n == 0:
        return out

    # level-frame coordinates (PyramidCU.cpp:616-626)
    assigned, osig = _bin_by_scale(ks, plan.num_octaves, cfg)
    offset = 0.0 if cfg.lowe_origin else 0.5
    fx = (kx - offset) / osig + 0.5
    fy = (ky - offset) / osig + 0.5
    fs = ks / osig
    ft = np.mod(TWO_PI - kt, TWO_PI).astype(np.float32)

    row = lambda a, dt: torch.as_tensor(
        np.ascontiguousarray(a)[None]).to(device=dev, dtype=dt)
    f = torch.float32
    table = GlobalTable(
        x=row(fx, f), y=row(fy, f), sigma=row(fs, f), theta=row(ft, f),
        response=torch.zeros((1, n), dtype=f, device=dev),
        ftype=torch.zeros((1, n), dtype=torch.int32, device=dev),
        level_id=row(assigned, torch.int32),
        valid=torch.ones((1, n), dtype=torch.bool, device=dev))

    owin, dwin = window_sizes(cfg, float(fs.max()))
    if not skip_orientation:
        # existing keypoints keep only the strongest orientation
        ores = orient_table(table, maps, cfg, owin, True, plain)
        table = table._replace(theta=ores.thetas[..., 0].contiguous())
        out["theta"] = np.mod(TWO_PI - table.theta[0].cpu().numpy(), TWO_PI)
    else:
        out["theta"] = kt
    out["desc"] = describe_table(table, maps, cfg, dwin, plain)[0] \
        .cpu().numpy()
    return out


def describe_rectangles(
    image: np.ndarray,
    rects: np.ndarray,
    cfg: Optional[SiftConfig] = None,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Axis-aligned rectangle description (reference RECT mode:
    SetKeypointList(..., skip_orientation=-1), ComputeDescriptorRECT).

    rects: (N, 4) columns x, y (top-left), width, height in image coords.
    Rectangles are binned to levels by min(w, h)/12 (the reference's rect
    scale proxy, PyramidCU.cpp:598-599). The rect descriptor is tensor code
    on either device: the JAX package has no kernel for it either.
    """
    cfg = cfg or SiftConfig()
    plan, cfg, maps = _pyramid_gradients(image, cfg, device, False)
    dev = maps.grad[0].device
    s = cfg.scale_params().num_scales

    rects = np.asarray(rects, np.float32)
    n = rects.shape[0]
    out_desc = np.zeros((n, cfg.descriptor_dim), np.float32)
    assigned, osig = _bin_by_scale(
        np.minimum(rects[:, 2], rects[:, 3]) / 12.0, plan.num_octaves, cfg)
    offset = 0.0 if cfg.lowe_origin else 0.5
    col = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)
    for idx in np.unique(assigned):
        members = np.nonzero(assigned == idx)[0]
        scale = osig[members]
        frw = rects[members, 2] / scale
        frh = rects[members, 3] / scale
        wsize = int(math.ceil(max(frw.max(), frh.max()))) + 4
        o, li = divmod(int(idx), s)
        desc = compute_descriptors_rect(
            col((rects[members, 0] - offset) / scale + 0.5),
            col((rects[members, 1] - offset) / scale + 0.5),
            col(frw), col(frh),
            torch.ones(len(members), dtype=torch.bool, device=dev),
            maps.grad[o][0, li], maps.rot[o][0, li], wsize=wsize,
            half_sift=cfg.half_sift, normalize=cfg.normalized_sift)
        out_desc[members] = desc.cpu().numpy()
    return {"x": rects[:, 0], "y": rects[:, 1], "w": rects[:, 2],
            "h": rects[:, 3], "desc": out_desc}
