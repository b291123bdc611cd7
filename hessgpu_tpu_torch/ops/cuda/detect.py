"""Wrapper of the fused detect kernel (csrc/detect.cu), the counterpart of
hessgpu_tpu/ops/pallas/detect.py detect_octave_pallas (its plain output set).

detect_octave launches the kernel for a CUDA tensor and counts the launch;
for a tensor on the CPU, and only then, it returns detect_octave_plain, the
plain PyTorch version built from ops/hessian.py + ops/keypoint.py. Nothing
falls back from a failed build or launch. Every octave size goes through the
kernel: there is no small-octave gate.

The two differ in one way, by contract: the kernel writes the keypoint
payload (response, dx, dy, ds, ftype) only at cells where valid is set and
leaves the rest of those maps as torch.empty gave them; the plain version
keeps them dense, with zeros and TYPE_NONE off the keypoints. valid, grad
and rot are dense on both. Read the payload at valid cells only, as
ops/compaction.py does.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import hessian
from ..keypoint import KeypointMaps, detect_keypoints_level, f32
from . import build

MAX_PLANES = 16   # kMaxPlanes in csrc/detect.cu
MAX_KEYS = 8      # kMaxKeys

_ptr = ctypes.c_void_p
_ARGTYPES = ([_ptr] * 9 + [ctypes.c_int] * 4 + [_ptr, ctypes.c_int, _ptr]
             + [ctypes.c_int] * 3 + [ctypes.c_float] * 3 + [_ptr])


def _check_args(gauss_oct: torch.Tensor, norms, key_levels, detector: str):
    if detector not in ("hessian", "dog"):
        raise ValueError(f"detect_octave: unknown detector {detector!r}")
    if gauss_oct.dtype != torch.float32:
        raise TypeError(f"detect_octave: expected float32, got "
                        f"{gauss_oct.dtype}")
    if gauss_oct.ndim != 4:
        raise ValueError(f"detect_octave: expected (B, L, H, W), got "
                         f"{tuple(gauss_oct.shape)}")
    B, L = gauss_oct.shape[:2]
    kl = [int(k) for k in key_levels]
    if not kl or len(kl) > MAX_KEYS or any(b <= a for a, b in zip(kl, kl[1:])):
        raise ValueError(f"detect_octave: key levels {kl} must be 1..{MAX_KEYS}"
                         " ascending values")
    # Gaussian planes read: key-1 .. key+1, one more for DoG (response i =
    # gauss[i+1] - gauss[i])
    top = kl[-1] + (1 if detector == "hessian" else 2)
    if kl[0] < 1 or top > L - 1 or top - kl[0] + 2 > MAX_PLANES:
        raise ValueError(f"detect_octave: key levels {kl} do not fit a stack "
                         f"of {L} levels ({detector})")
    if len(norms) != L:
        raise ValueError(f"detect_octave: {len(norms)} norms for {L} levels")
    if B > 65535:
        raise ValueError(f"detect_octave: batch {B} exceeds 65535")
    return kl


def detect_octave_plain(
    gauss_oct: torch.Tensor, norms: Sequence[float],
    key_levels: Sequence[int], threshold: float, edge_threshold: float,
    subpixel: bool = True, darkness_adaption: bool = False,
    detector: str = "hessian",
) -> Tuple[KeypointMaps, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of detect_octave (same arguments and result)."""
    kl = _check_args(gauss_oct, norms, key_levels, detector)
    is_hessian = detector == "hessian"
    if is_hessian:
        resp, grad, rot = hessian.hessian_response_and_gradient(
            gauss_oct, norms, grad_levels=kl)
    else:
        resp, grad, rot = hessian.dog_response_and_gradient(gauss_oct)
        # DoG gradients come from gauss[1:], so grad[i] belongs to Gaussian
        # level i+1; index them by Gaussian level like the Hessian ones
        grad = torch.cat([grad[:, :1], grad], dim=1)
        rot = torch.cat([rot[:, :1], rot], dim=1)
    maps = [detect_keypoints_level(
        resp[:, k - 1], resp[:, k], resp[:, k + 1], gauss_oct[:, k],
        threshold=threshold, edge_threshold=edge_threshold,
        subpixel=subpixel, hessian=is_hessian,
        darkness_adaption=darkness_adaption) for k in kl]
    stacked = KeypointMaps(*(torch.stack(xs, dim=1) for xs in zip(*maps)))
    return stacked, grad[:, kl].contiguous(), rot[:, kl].contiguous()


def detect_octave(
    gauss_oct: torch.Tensor, norms: Sequence[float],
    key_levels: Sequence[int], threshold: float, edge_threshold: float,
    subpixel: bool = True, darkness_adaption: bool = False,
    detector: str = "hessian",
) -> Tuple[KeypointMaps, torch.Tensor, torch.Tensor]:
    """Fused detection for one octave - one kernel launch.

    gauss_oct: (B, L, H, W) float32 Gaussian stack. norms: per-level response
    normalisation (sigma^4 for the Hessian personality; unused for DoG).
    key_levels: ascending stack indices where keypoints are detected.

    Returns (KeypointMaps with (B, NK, H, W) leaves - row i = key level
    key_levels[i]; grad (B, NK, H, W); rot (B, NK, H, W)): for each key
    level the keypoint test (response, 3x3x3 NMS, threshold incl.
    darkness_adaption, edge test, subpixel solve, typing; response rounded
    through fp16) and the gradient magnitude/angle of its Gaussian plane.
    On a CUDA tensor the maps' response, dx, dy, ds and ftype hold defined
    values only where valid is set (see the module docstring).
    detector: "hessian" (det-of-Hessian * norm, sign-consistent NMS,
    saddle/blob typing) or "dog" (response[l] = gauss[l+1] - gauss[l],
    bright/dark typing by extremum sign).
    """
    kl = _check_args(gauss_oct, norms, key_levels, detector)
    if not gauss_oct.is_cuda:
        return detect_octave_plain(gauss_oct, norms, kl, threshold,
                                   edge_threshold, subpixel,
                                   darkness_adaption, detector)
    if not gauss_oct.is_contiguous():
        raise ValueError("detect_octave: input must be contiguous")
    B, L, H, W = gauss_oct.shape
    NK = len(kl)
    shape = (B, NK, H, W)
    dev = gauss_oct.device
    new = lambda dt: torch.empty(shape, dtype=dt, device=dev)
    valid = new(torch.bool)
    resp, dx, dy, ds = (new(torch.float32) for _ in range(4))
    ftype = new(torch.int32)
    grad, rot = new(torch.float32), new(torch.float32)

    kl_np = np.asarray(kl, np.int32)
    norms_np = np.asarray([float(n) for n in norms], np.float32)
    thr0 = f32(0.8 * threshold) if subpixel else f32(threshold)
    te = f32((edge_threshold + 1.0) ** 2 / edge_threshold)
    fn = build.function("hg_detect_octave", _ARGTYPES)
    with build.on_device_of(gauss_oct):
        err = fn(gauss_oct.data_ptr(), valid.data_ptr(), resp.data_ptr(),
                 dx.data_ptr(), dy.data_ptr(), ds.data_ptr(),
                 ftype.data_ptr(), grad.data_ptr(), rot.data_ptr(),
                 B, L, H, W, kl_np.ctypes.data, NK, norms_np.ctypes.data,
                 int(detector == "hessian"), int(bool(subpixel)),
                 int(bool(darkness_adaption)), f32(threshold), thr0, te,
                 build.stream_of(gauss_oct))
    build.check(err, "detect_octave")
    build.count_launch("detect_octave")
    maps = KeypointMaps(valid=valid, response=resp, dx=dx, dy=dy, ds=ds,
                        ftype=ftype)
    return maps, grad, rot
