"""Wrappers of the per-keypoint kernels (csrc/patch.cu), the counterparts of
hessgpu_tpu/ops/pallas/patch.py orientation_pallas and descriptor_pallas.

orientation and descriptor launch their kernel for CUDA tensors and count
the launch; for tensors on the CPU, and only then, they return
orientation_plain / descriptor_plain, the plain PyTorch versions
(ops/orientation.py, ops/descriptor.py). Nothing falls back from a failed
build or launch.

Both take (B, G) keypoint tables in level coordinates and the LevelMaps of
the pyramid (ops/gather.py); level_id indexes the maps' levels, slot (b, i)
reads batch item b. A level may be a band of rows read in global rows
through its row origin (ops/gather.py). `wsize` is the static window the
plain version gathers; the kernels size their loop per keypoint and do not
use it. Slots that are not valid give zeros on both routes.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..descriptor import compute_descriptors_flat
from ..gather import LevelMaps
from ..keypoint import f32
from ..orientation import (BINS_PER_RADIAN, TWO_PI, OrientationResult,
                           check_tables, compute_orientations_flat)
from . import build

MAX_LEVELS = 64   # kMaxLevels in csrc/patch.cu

_ptr = ctypes.c_void_p
_LEVELS = [_ptr] * 7 + [ctypes.c_int]
_ORI_ARGTYPES = ([_ptr] * 8 + [ctypes.c_int] * 2 + _LEVELS
                 + [ctypes.c_float] * 5 + [ctypes.c_int] * 3 + [_ptr])
_DESC_ARGTYPES = ([_ptr] * 7 + [ctypes.c_int] * 2 + _LEVELS
                  + [ctypes.c_float] * 4 + [_ptr])


def _level_args(maps: LevelMaps):
    """Host arrays of the kernels' level table (kept alive by the caller):
    per level, batch item 0's grad and rot plane, the batch stride, the
    global height, the width, the row origin and its step per batch item."""
    geo = maps.geometry()
    if len(geo) > MAX_LEVELS:
        raise ValueError(f"{len(geo)} levels exceed the kernels' "
                         f"{MAX_LEVELS}")
    for g, r in zip(maps.grad, maps.rot):
        if not (g.is_contiguous() and r.is_contiguous()):
            raise ValueError("LevelMaps: maps must be contiguous")
    plane = lambda ts, g: ts[g.group].data_ptr() + 4 * g.index * g.rows * g.w
    arrays = (
        np.asarray([plane(maps.grad, g) for g in geo], np.int64),
        np.asarray([plane(maps.rot, g) for g in geo], np.int64),
        np.asarray([g.bstride for g in geo], np.int64),
        np.asarray([g.height for g in geo], np.int32),
        np.asarray([g.w for g in geo], np.int32),
        np.asarray([g.row0 for g in geo], np.int32),
        np.asarray([g.row_step for g in geo], np.int32))
    return arrays, [a.ctypes.data for a in arrays] + [len(geo)]


def _table(name: str, t: torch.Tensor, dtype) -> torch.Tensor:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tables must be contiguous")
    return t


def orientation_plain(x, y, sigma, valid, level_id, maps: LevelMaps,
                      wsize: int, gaussian_factor: float = 1.5,
                      window_factor: float = 2.0,
                      peak_threshold: float = 0.8, half_sift: bool = False,
                      single: bool = False, max_peaks: int = 4,
                      ) -> OrientationResult:
    """Plain PyTorch version of orientation (same arguments; the result
    always carries the histograms and the count of pixels that voted)."""
    return compute_orientations_flat(
        x, y, sigma, valid, level_id, maps, wsize,
        gaussian_factor=gaussian_factor, window_factor=window_factor,
        peak_threshold=peak_threshold, half_sift=half_sift,
        max_peaks=max_peaks, single=single)


def orientation(x, y, sigma, valid, level_id, maps: LevelMaps, wsize: int,
                gaussian_factor: float = 1.5, window_factor: float = 2.0,
                peak_threshold: float = 0.8, half_sift: bool = False,
                single: bool = False, max_peaks: int = 4,
                return_votes: bool = False) -> OrientationResult:
    """Orientation histograms and peaks for a keypoint table - one launch.

    x, y, sigma f32, valid bool, level_id i32, all (B, G). Returns thetas
    (B, G, 4) f32 and valid (B, G, 4) bool: `single` gives the strongest
    orientation at full precision in column 0, else up to max_peaks <= 4
    peaks above peak_threshold * max, by vote descending, quantized to
    2pi / 255. return_votes adds the smoothed (half_sift: folded) histograms
    (B, G, 36).
    """
    if not x.is_cuda:
        return orientation_plain(x, y, sigma, valid, level_id, maps, wsize,
                                 gaussian_factor, window_factor,
                                 peak_threshold, half_sift, single, max_peaks)
    check_tables("orientation", maps, level_id, x, y, sigma, valid)
    for t in (x, y, sigma):
        _table("orientation", t, torch.float32)
    _table("orientation", valid, torch.bool)
    _table("orientation", level_id, torch.int32)
    B, G = x.shape
    keep, levels = _level_args(maps)
    thetas = torch.empty((B, G, 4), dtype=torch.float32, device=x.device)
    ovalid = torch.empty((B, G, 4), dtype=torch.bool, device=x.device)
    votes = torch.empty((B, G, 36), dtype=torch.float32, device=x.device) \
        if return_votes else None
    single = bool(single or max_peaks <= 1)
    fn = build.function("hg_orientation", _ORI_ARGTYPES)
    with build.on_device_of(x):
        err = fn(x.data_ptr(), y.data_ptr(), sigma.data_ptr(),
                 valid.data_ptr(), level_id.data_ptr(), thetas.data_ptr(),
                 ovalid.data_ptr(),
                 votes.data_ptr() if return_votes else None,
                 B * G, G, *levels, f32(gaussian_factor),
                 f32(gaussian_factor * window_factor), f32(BINS_PER_RADIAN),
                 f32(peak_threshold), f32(TWO_PI / 255.0),
                 int(bool(half_sift)), int(single), int(max_peaks),
                 build.stream_of(x))
    del keep
    build.check(err, "orientation")
    build.count_launch("orientation")
    return OrientationResult(thetas, ovalid, votes)


def descriptor_plain(x, y, sigma, theta, valid, level_id, maps: LevelMaps,
                     wsize: int, window_factor: float = 3.0) -> torch.Tensor:
    """Plain PyTorch version of descriptor (same arguments and result)."""
    return compute_descriptors_flat(x, y, sigma, theta, valid, level_id, maps,
                                    wsize, window_factor)[0]


def descriptor(x, y, sigma, theta, valid, level_id, maps: LevelMaps,
               wsize: int, window_factor: float = 3.0) -> torch.Tensor:
    """Raw SIFT descriptors for a keypoint table - one launch.

    x, y, sigma, theta f32, valid bool, level_id i32, all (B, G); theta in
    the device frame. Returns (B, G, 16, 8) f32, unnormalized, indexed
    [cell cy * 4 + cx, orientation bin]; ops.descriptor.finalize_descriptors
    folds and normalizes.
    """
    if not x.is_cuda:
        return descriptor_plain(x, y, sigma, theta, valid, level_id, maps,
                                wsize, window_factor)
    check_tables("descriptor", maps, level_id, x, y, sigma, theta, valid)
    for t in (x, y, sigma, theta):
        _table("descriptor", t, torch.float32)
    _table("descriptor", valid, torch.bool)
    _table("descriptor", level_id, torch.int32)
    B, G = x.shape
    keep, levels = _level_args(maps)
    out = torch.empty((B, G, 16, 8), dtype=torch.float32, device=x.device)
    fn = build.function("hg_descriptor", _DESC_ARGTYPES)
    with build.on_device_of(x):
        err = fn(x.data_ptr(), y.data_ptr(), sigma.data_ptr(),
                 theta.data_ptr(), valid.data_ptr(), level_id.data_ptr(),
                 out.data_ptr(), B * G, G, *levels, f32(window_factor),
                 f32(math.pi), f32(2.0 * math.pi), f32(4.0 / math.pi),
                 build.stream_of(x))
    del keep
    build.check(err, "descriptor")
    build.count_launch("descriptor")
    return out
