"""Wrappers of the blur, octave-chain and decimation kernels (csrc/conv.cu),
the counterparts of hessgpu_tpu/ops/pallas/conv.py.

Each wrapper launches its kernel for a CUDA tensor and counts the launch; for
a tensor on the CPU, and only then, it returns the plain PyTorch version
(`*_plain`, from ops/gaussian.py and a strided slice). Nothing falls back
from a failed build or launch.

The pyramid builds each octave's stack in place: blur(..., out=stack[:, 0])
writes octave 0's base, and octave_chain_into computes the levels from
level 0 and decimates level level_ds into level 0 of the next octave's stack
(the counterpart of downsample2_pallas on the main path). downsample2 is the
decimation called alone.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from ..gaussian import blur_taps, octave_chain_taps, taps_f32
from . import build

MAX_TAPS = 33   # params.KERNEL_MAX_WIDTH, kMaxTaps in csrc/conv.cu

_ptr = ctypes.c_void_p
_ARGTYPES = {
    "hg_blur": [_ptr, _ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_longlong, _ptr, ctypes.c_int, _ptr],
    "hg_blur_segment_rows": [ctypes.c_int, ctypes.c_int, ctypes.c_int],
    "hg_octave_chain": [_ptr, _ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, _ptr, _ptr, ctypes.c_int, _ptr,
                        ctypes.c_longlong, _ptr],
    "hg_octave_chain_groups": [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, _ptr],
    "hg_downsample2": [_ptr, _ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong, _ptr],
}


def _fn(name: str):
    return build.function(name, _ARGTYPES[name])


def _check_planes(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"{name}: expected (B, H, W), got {tuple(x.shape)}")
    if x.shape[0] > 65535:
        raise ValueError(f"{name}: batch {x.shape[0]} exceeds 65535")


def _check_plane_view(out: torch.Tensor, shape, like: torch.Tensor,
                      name: str) -> None:
    """An output the kernels write through a batch stride: (B, h, w) float32
    on like's device, rows contiguous (e.g. plane [:, l] of a stack)."""
    if out.dtype != torch.float32 or out.device != like.device:
        raise TypeError(f"{name}: expected float32 on {like.device}, got "
                        f"{out.dtype} on {out.device}")
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {tuple(shape)}, got "
                         f"{tuple(out.shape)}")
    if out.stride(2) != 1 or out.stride(1) != shape[2] \
            or out.stride(0) < shape[1] * shape[2]:
        raise ValueError(f"{name}: rows must be contiguous and planes apart")


def _check_taps(taps: np.ndarray, name: str) -> None:
    if not (1 <= len(taps) <= MAX_TAPS) or len(taps) % 2 == 0:
        raise ValueError(f"{name}: tap count {len(taps)} must be odd, <= "
                         f"{MAX_TAPS}")


# ---------------------------------------------------------------------------
# blur
# ---------------------------------------------------------------------------

def blur_plain(x: torch.Tensor, taps: Sequence[float]) -> torch.Tensor:
    """Plain PyTorch version of blur: shifted weighted adds, kernel order."""
    return blur_taps(x, taps)


def blur(x: torch.Tensor, taps: Sequence[float],
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Separable clamp-to-edge blur of (B, H, W) float32 with the given odd
    tap vector (<= 33 taps). out: where to write it, a (B, H, W) view with
    contiguous rows and planes apart, such as level 0 of a (B, L, H, W)
    stack; by default a new tensor. Returns out."""
    _check_planes(x, "blur")
    t = taps_f32(taps)
    _check_taps(t, "blur")
    if out is not None:
        _check_plane_view(out, x.shape, x, "blur")
    if not x.is_cuda:
        if out is None:
            return blur_plain(x, t)
        return out.copy_(blur_plain(x, t))
    if not x.is_contiguous():
        raise ValueError("blur: input must be contiguous")
    if out is None:
        out = torch.empty_like(x)
    B, H, W = x.shape
    with build.on_device_of(x):
        err = _fn("hg_blur")(x.data_ptr(), out.data_ptr(), B, H, W,
                             out.stride(0), t.ctypes.data, len(t),
                             build.stream_of(x))
    build.check(err, "blur")
    build.count_launch("blur")
    return out


def blur_segment_rows(x: torch.Tensor) -> int:
    """The rows of each segment that blur(x, taps) walks down a column strip
    on x's CUDA device (the kernel's one size choice; the last segment may
    be shorter). Launches nothing."""
    _check_planes(x, "blur_segment_rows")
    if not x.is_cuda:
        raise ValueError("blur_segment_rows: needs a CUDA tensor")
    with build.on_device_of(x):
        rows = _fn("hg_blur_segment_rows")(*x.shape)
    if rows < 1:
        raise RuntimeError("blur_segment_rows: shape refused")
    return rows


# ---------------------------------------------------------------------------
# octave chain
# ---------------------------------------------------------------------------

def octave_chain_plain(base: torch.Tensor,
                       taps_list: Sequence[Sequence[float]]) -> torch.Tensor:
    """Plain PyTorch version of octave_chain: chained blur_plain."""
    return octave_chain_taps(base, taps_list)


def _chain_args(base: torch.Tensor, taps_list, name: str):
    """Checked arguments of the chain's C functions: the float32 taps, their
    (L-1, 33) rows and their widths."""
    _check_planes(base, name)
    tl = [taps_f32(tp) for tp in taps_list]
    for tp in tl:
        if len(tp):
            _check_taps(tp, name)
    flat = np.zeros((max(len(tl), 1), MAX_TAPS), np.float32)
    ntaps = np.zeros(max(len(tl), 1), np.int32)
    for l, tp in enumerate(tl):
        flat[l, :len(tp)] = tp
        ntaps[l] = len(tp)
    return tl, flat, ntaps


def octave_chain(base: torch.Tensor,
                 taps_list: Sequence[Sequence[float]]) -> torch.Tensor:
    """Whole-octave Gaussian chain: level 0 = base, level l+1 = blur(level l,
    taps_list[l]) with clamp-to-edge at every level (empty taps = identity).
    base (B, H, W) float32 -> (B, 1 + len(taps_list), H, W); equals chained
    blur() exactly."""
    tl, _, _ = _chain_args(base, taps_list, "octave_chain")
    if not base.is_cuda:
        return octave_chain_plain(base, tl)
    if not base.is_contiguous():
        raise ValueError("octave_chain: input must be contiguous")
    out = torch.empty((base.shape[0], 1 + len(tl)) + base.shape[1:],
                      dtype=torch.float32, device=base.device)
    return octave_chain_into(out, tl, base=base)


def octave_chain_into(stack: torch.Tensor,
                      taps_list: Sequence[Sequence[float]], *,
                      base: Optional[torch.Tensor] = None,
                      decimate_level: Optional[int] = None,
                      next_base: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """octave_chain computed into a given (B, L, H, W) float32 stack, L =
    1 + len(taps_list): levels 1..L-1 from level 0, which is `base` (written
    into stack[:, 0]) or, with base=None, what stack[:, 0] already holds.
    With decimate_level, level decimate_level is also decimated into
    next_base: next_base[b, y, x] = stack[b, decimate_level, 2y, 2x] for
    y < H // 2, x < W // 2 (downsample2 cropped to the floor-halved shape),
    next_base being a (B, H // 2, W // 2) view with contiguous rows, such as
    level 0 of the next octave's stack. One launch per group of levels (one
    for the default taps); the decimation is its epilogue. Returns stack."""
    if stack.ndim != 4:
        raise ValueError("octave_chain_into: expected (B, L, H, W), got "
                         f"{tuple(stack.shape)}")
    tl, flat, ntaps = _chain_args(stack[:, 0], taps_list, "octave_chain_into")
    B, L, H, W = stack.shape
    if L != 1 + len(tl):
        raise ValueError(f"octave_chain_into: a stack of {L} levels for "
                         f"{len(tl)} transitions")
    if base is not None:
        _check_plane_view(base, (B, H, W), stack, "octave_chain_into base")
    if (decimate_level is None) != (next_base is None):
        raise ValueError("octave_chain_into: decimate_level and next_base "
                         "go together")
    if decimate_level is not None:
        if not 0 <= decimate_level < L:
            raise ValueError(f"octave_chain_into: no level {decimate_level}")
        _check_plane_view(next_base, (B, H // 2, W // 2), stack,
                          "octave_chain_into next_base")
    if not stack.is_cuda:
        if base is not None:
            stack[:, 0] = base
        stack.copy_(octave_chain_plain(stack[:, 0], tl))
        if decimate_level is not None:
            next_base.copy_(downsample2_plain(stack[:, decimate_level])
                            [..., :H // 2, :W // 2])
        return stack
    if not stack.is_contiguous():
        raise ValueError("octave_chain_into: the stack must be contiguous")
    if base is not None and not base.is_contiguous():
        raise ValueError("octave_chain_into: base must be contiguous")
    with build.on_device_of(stack):
        err = _fn("hg_octave_chain")(
            None if base is None else base.data_ptr(), stack.data_ptr(), B, L,
            H, W, flat.ctypes.data, ntaps.ctypes.data,
            -1 if decimate_level is None else decimate_level,
            None if next_base is None else next_base.data_ptr(),
            0 if next_base is None else next_base.stride(0),
            build.stream_of(stack))
    build.check(err, "octave_chain")
    build.count_launch("octave_chain")
    return stack


def octave_chain_groups(base: torch.Tensor,
                        taps_list: Sequence[Sequence[float]]) -> int:
    """The number of device launches octave_chain(base, taps_list) makes on
    base's CUDA device: one per group of levels the kernel keeps in shared
    memory (1 for the default Hessian and DoG taps). Launches nothing."""
    tl, _, ntaps = _chain_args(base, taps_list, "octave_chain_groups")
    if not base.is_cuda:
        raise ValueError("octave_chain_groups: needs a CUDA tensor")
    B, H, W = base.shape
    with build.on_device_of(base):
        groups = _fn("hg_octave_chain_groups")(B, 1 + len(tl), H, W,
                                               ntaps.ctypes.data)
    if groups < 0:
        raise RuntimeError("octave_chain_groups: arguments refused")
    return groups


# ---------------------------------------------------------------------------
# decimation
# ---------------------------------------------------------------------------

def downsample2_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of downsample2: the strided slice, copied."""
    return x[..., ::2, ::2].contiguous()


def downsample2(x: torch.Tensor) -> torch.Tensor:
    """Exact decimation by 2 (even rows/cols, ceil sizes for odd dims) of
    (B, h, w) float32. The source may be a strided view with unit column
    stride - e.g. plane [:, l] of a (B, L, H, W) stack is read in place."""
    _check_planes(x, "downsample2")
    if not x.is_cuda:
        return downsample2_plain(x)
    if x.stride(2) != 1:
        raise ValueError("downsample2: columns must be contiguous")
    B, h, w = x.shape
    out = torch.empty((B, (h + 1) // 2, (w + 1) // 2), dtype=torch.float32,
                      device=x.device)
    with build.on_device_of(x):
        err = _fn("hg_downsample2")(x.data_ptr(), out.data_ptr(), B, h, w,
                                    x.stride(0), x.stride(1),
                                    build.stream_of(x))
    build.check(err, "downsample2")
    build.count_launch("downsample2")
    return out
