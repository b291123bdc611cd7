"""Descriptor service for externally supplied keypoints (counterpart of
hessgpu_tpu/describe.py).

Equivalent of RunSIFT(num, keys, has_orientation) - the keypoint-list
re-entry path (reference SiftGPU.cpp:307-315, SiftPyramid::SetKeypointList
SiftPyramid.cpp:326-355, PyramidCU::GenerateFeatureListTex
PyramidCU.cpp:555-718). SfM systems use it to compute descriptors at
externally detected or tracked locations.

Keypoints are binned to (octave, level) by scale on the host, as the
reference does. Everything after that is one (1, cap) table in input order,
padded to the JAX package's bucket, through the same orientation and
descriptor stages as the detection pipeline: the kernels on the card, their
plain versions on the CPU.

On the card the pyramid, the key levels' gradient maps and both
per-keypoint stages replay one captured CUDA graph per (plan, config,
skip_orientation, cap, device): the JAX package's jitted
_describe_all_pallas, which also stands for its per-level
_orient_and_describe_level (the port's one table covers every level).
describe_rectangles replays the graph of the pyramid and its gradient maps
(the JAX package's _pyramid_gradients); its rectangle descriptor stays
eager per level, as in the JAX package. Inside utils.graphs.disable_graphs()
both run their eager bodies. describe_keypoints.clear_cache() frees the
graphs of both.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from .config import SiftConfig
from .ops.descriptor import compute_descriptors_rect
from .ops.gather import LevelMaps
from .pyramid import (GlobalTable, PipelinePlan, _build_pyramid, _CfgKey,
                      describe_table, key_level_gradients, orient_table,
                      prepare_input, window_sizes)
from .utils.graphs import GraphCache, graphs_enabled

TWO_PI = 2.0 * math.pi

# The bytes the captured re-entry programs may reserve, the least recently
# used dropped first. One graph's pool holds its call's pyramid and maps
# (PERF.md, chip_smoke.py's compiled phase).
DESCRIBE_GRAPH_BYTES = 1 << 30
_DESCRIBE_GRAPHS = GraphCache(DESCRIBE_GRAPH_BYTES)


def _graphs_on(arr: torch.Tensor, plain: bool) -> bool:
    return arr.is_cuda and not plain and graphs_enabled(_DESCRIBE_GRAPHS)


def _gradients(arr: torch.Tensor, plan: PipelinePlan, cfg: SiftConfig,
               plain: bool = False):
    """The pyramid of arr (H, W) and its per-(octave, key level) gradient
    magnitude and angle maps: two tuples of (1, NK, h, w), one per octave.
    Reference: BuildPyramid + ComputeGradient (PyramidCU.cpp:1736-1790)."""
    octaves = _build_pyramid(arr[None], plan, cfg, plain)
    grads, rots = zip(*(key_level_gradients(g, cfg, plain) for g in octaves))
    return tuple(grads), tuple(rots)


def _pyramid_gradients(image: np.ndarray, cfg: SiftConfig, device,
                       plain: bool):
    """Build the pyramid and return (plan, cfg, LevelMaps of the per-(octave,
    key level) gradient maps, batch 1): on the card the replay of one graph
    per (plan, cfg, device), the JAX package's jitted _pyramid_gradients."""
    arr, plan, cfg = prepare_input(image, cfg, device)
    if _graphs_on(arr, plain):
        grads, rots = _DESCRIBE_GRAPHS(
            ("gradients", plan, _CfgKey(cfg)),
            lambda a: _gradients(a, plan, cfg), arr)
    else:
        grads, rots = _gradients(arr, plan, cfg, plain)
    return plan, cfg, LevelMaps(grads, rots)


def _bucket(n: int) -> int:
    """The JAX package's list bucket: a power of two, at least 8."""
    return max(8, 1 << int(math.ceil(math.log2(max(n, 2)))))


def _describe_all(arr, x, y, sigma, theta, valid, level_id,
                  plan: PipelinePlan, cfg: SiftConfig,
                  skip_orientation: bool, owin: int, dwin: int,
                  plain: bool = False):
    """Pyramid, key-level gradient maps, the strongest orientation (unless
    skip_orientation) and descriptors of a (1, cap) table in level
    coordinates (the JAX package's _describe_all_pallas). Returns theta
    (1, cap) in the device frame and desc (1, cap, descriptor_dim); a slot
    that is not valid gives zeros, and every slot is computed on its own.
    owin and dwin size the plain versions' windows; the kernels size theirs
    per keypoint and do not read them."""
    maps = LevelMaps(*_gradients(arr, plan, cfg, plain))
    zeros = torch.zeros_like(x)
    table = GlobalTable(x=x, y=y, sigma=sigma, theta=theta, response=zeros,
                        ftype=torch.zeros_like(level_id), level_id=level_id,
                        valid=valid)
    if not skip_orientation:
        # existing keypoints keep only the strongest orientation
        ores = orient_table(table, maps, cfg, owin, True, plain)
        table = table._replace(theta=ores.thetas[..., 0].contiguous())
    return table.theta, describe_table(table, maps, cfg, dwin, plain)


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
    arr, plan, cfg = prepare_input(image, cfg, device)
    keys = np.asarray(keys, np.float32)
    n = keys.shape[0]
    kx, ky, ks = keys[:, 0], keys[:, 1], keys[:, 2]
    skip_orientation = has_orientation and keys.shape[1] > 3
    kt = keys[:, 3] if skip_orientation else np.zeros(n, np.float32)
    out = {"x": kx, "y": ky, "sigma": ks, "theta": kt.copy(),
           "desc": np.zeros((n, cfg.descriptor_dim), np.float32)}
    if n == 0:
        return out
    theta, desc = _describe_padded(arr, plan, cfg, kx, ky, ks, kt,
                                   skip_orientation, _bucket(n), plain)
    if not skip_orientation:
        out["theta"] = np.mod(TWO_PI - theta[:n], TWO_PI)
    out["desc"] = desc[:n]
    return out


def _describe_padded(arr, plan, cfg, kx, ky, ks, kt, skip_orientation,
                     cap: int, plain: bool = False):
    """The device part of describe_keypoints for n keypoints in image
    coordinates, padded to cap >= n slots (pad values as the JAX package's:
    sigma 1.0, level 0, not valid). Returns the cap slots' theta (device
    frame) and descriptors as NumPy arrays."""
    n = len(kx)
    # level-frame coordinates (PyramidCU.cpp:616-626)
    assigned, osig = _bin_by_scale(ks, plan.num_octaves, cfg)
    offset = 0.0 if cfg.lowe_origin else 0.5
    pad = lambda a, v=0: np.pad(a, (0, cap - n), constant_values=v)[None]
    fs = ks / osig
    cols = (pad((kx - offset) / osig + 0.5), pad((ky - offset) / osig + 0.5),
            pad(fs, 1.0), pad(np.mod(TWO_PI - kt, TWO_PI)),
            pad(np.ones(n, bool), False), pad(assigned))
    dtypes = (torch.float32,) * 4 + (torch.bool, torch.int32)
    x, y, sigma, theta, valid, lid = (
        torch.as_tensor(np.ascontiguousarray(c)).to(device=arr.device,
                                                    dtype=dt)
        for c, dt in zip(cols, dtypes))
    owin, dwin = window_sizes(cfg, float(fs.max()))
    if _graphs_on(arr, plain):
        # the key leaves owin and dwin out: the kernels do not read them
        theta, desc = _DESCRIBE_GRAPHS(
            ("describe", plan, _CfgKey(cfg), skip_orientation),
            lambda *a: _describe_all(*a, plan, cfg, skip_orientation, owin,
                                     dwin),
            arr, x, y, sigma, theta, valid, lid)
    else:
        theta, desc = _describe_all(arr, x, y, sigma, theta, valid, lid,
                                    plan, cfg, skip_orientation, owin, dwin,
                                    plain)
    return theta[0].cpu().numpy(), desc[0].cpu().numpy()


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


describe_keypoints.clear_cache = _DESCRIBE_GRAPHS.clear
