"""Wrappers of the feature-list kernels (csrc/compact.cu): the
GENERATE_FEATURE_LIST stage of pyramid.detect_from_octaves on the card.

The stage has two halves, as detect_from_octaves calls them. compact_octave
runs once an octave, right after its detection; feature_table runs once
over all octaves and returns the GlobalTable (B, G), its level counts
(B, n_oct * NK) and its count (B,).

On a CUDA tensor compact_octave launches row_count_kernel (counted as
"row_counts") and returns the octave's maps with each row's capped count
(OctaveRows). feature_table then launches level_scan_kernel and
table_scatter_kernel ("level_scan", "table_scatter"), which write the table
straight from the maps: no per-octave FeatureList exists on this route.
For a tensor on the CPU, and only then, the two return the plain route:
ops/compaction.py's compact_octave_keypoints (a FeatureList an octave) and
_globalize. Nothing falls back from a failed build or launch.

No host synchronisation: shapes and capacities come from the maps and the
plan, the key levels' sigmas from a device tensor (the pipeline's plan
constants), so the two run inside a CUDA graph capture.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from ..compaction import (FeatureList, GlobalTable, _globalize, _row_cap,
                          compact_octave_keypoints)
from ..keypoint import KeypointMaps, f32
from . import build

MAX_OCTAVES = 16   # kMaxOctaves in csrc/compact.cu
MAX_KEYS = 8       # kMaxKeys

_ptr, _int = ctypes.c_void_p, ctypes.c_int
_ROW_ARGTYPES = [_ptr, _ptr, ctypes.c_longlong, _int, _int, _ptr]
_TABLE_ARGTYPES = ([_ptr, _ptr] + [_int] * 4 + [_ptr, ctypes.c_float]
                   + [_ptr] * 11)


class OctaveRows(NamedTuple):
    """One octave's compaction on the card, before the table is made."""
    maps: KeypointMaps          # (B, NK, H, W) leaves, from the detect kernel
    rows: torch.Tensor          # i32 (2, B, NK, H): capped counts, offsets
    capacity: int               # the octave's level cap
    sigmas: torch.Tensor        # f32 (NK,) the key levels' sigmas
    sigma_step: float           # f32-exact


def _check_maps(maps: KeypointMaps):
    v = maps.valid
    if v.dtype != torch.bool or v.ndim != 4:
        raise ValueError(f"compact_octave: expected a (B, NK, H, W) bool "
                         f"valid map, got {v.dtype} {tuple(v.shape)}")
    B, NK = v.shape[:2]
    if NK > MAX_KEYS or B > 65535:
        raise ValueError(f"compact_octave: {NK} key levels, batch {B}: at "
                         f"most {MAX_KEYS} and 65535")
    want = {"valid": torch.bool, "response": torch.float32,
            "dx": torch.float32, "dy": torch.float32, "ds": torch.float32,
            "ftype": torch.int32}
    for name, a in zip(maps._fields, maps):
        if a.dtype != want[name] or a.shape != v.shape \
                or a.device != v.device or not a.is_contiguous():
            raise ValueError(
                f"compact_octave: {name} must be a contiguous {want[name]} "
                f"tensor of shape {tuple(v.shape)} on {v.device}")


def compact_octave(maps: KeypointMaps, sigmas, sigma_step: float,
                   capacity: int):
    """One octave's half of GENERATE_FEATURE_LIST: compact_octave_keypoints'
    arguments (maps with (B, NK, H, W) leaves). On a CUDA tensor one launch
    of row_count_kernel, each row's valid cells counted and capped at
    min(W, _row_cap(W)), and the OctaveRows that feature_table reads; sigmas
    must then be an f32 tensor (NK,) on the maps' device. On a CPU tensor
    compact_octave_keypoints' FeatureList."""
    if not maps.valid.is_cuda:
        return compact_octave_keypoints(maps, sigmas, sigma_step, capacity)
    _check_maps(maps)
    valid = maps.valid
    B, NK, H, W = valid.shape
    if not isinstance(sigmas, torch.Tensor) or sigmas.dtype != torch.float32 \
            or tuple(sigmas.shape) != (NK,) or sigmas.device != valid.device \
            or not sigmas.is_contiguous():
        raise ValueError(f"compact_octave: sigmas must be a contiguous "
                         f"float32 tensor of shape ({NK},) on {valid.device}")
    rows = torch.empty((2, B, NK, H), dtype=torch.int32, device=valid.device)
    fn = build.function("hg_row_counts", _ROW_ARGTYPES)
    with build.on_device_of(valid):
        err = fn(valid.data_ptr(), rows.data_ptr(), B * NK * H, W,
                 min(W, _row_cap(W)), build.stream_of(valid))
    build.check(err, "row_counts")
    build.count_launch("row_counts")
    return OctaveRows(maps, rows, int(capacity), sigmas, f32(sigma_step))


def feature_table_plain(lists: Sequence[FeatureList], cap: int,
                        level_ids: torch.Tensor):
    """The plain route of feature_table: the level counts of the per-octave
    lists and _globalize's table and count."""
    level_counts = torch.cat([fl.count() for fl in lists], dim=-1)
    table = _globalize(list(lists), cap, level_ids)
    return table, level_counts, table.count()


def feature_table(lists, cap: int, level_ids: torch.Tensor):
    """The global table, G = cap slots a frame, from every octave's
    compact_octave result. level_ids: the plan's level id of each slot of
    the concatenated lists (_PlanConstants.level_ids), read on the CPU route;
    on the card the kernels give each slot's level id as octave * NK + key
    index, the same value.

    Returns (GlobalTable (B, G) in level coordinates, theta 0; level counts
    (B, n_oct * NK) i32, min(kept cells, cap) per level; count (B,) i32). On
    a CUDA tensor two launches: level_scan_kernel, then
    table_scatter_kernel."""
    if not level_ids.is_cuda:
        return feature_table_plain(lists, cap, level_ids)
    octs: List[OctaveRows] = list(lists)
    if not octs or len(octs) > MAX_OCTAVES \
            or not all(isinstance(o, OctaveRows) for o in octs):
        raise ValueError(f"feature_table: expected 1 to {MAX_OCTAVES} "
                         "compact_octave results of CUDA tensors")
    first = octs[0]
    B, NK = first.maps.valid.shape[:2]
    dev = first.maps.valid.device
    for o in octs:
        if tuple(o.maps.valid.shape[:2]) != (B, NK) \
                or o.maps.valid.device != dev or o.sigmas is not first.sigmas \
                or o.sigma_step != first.sigma_step:
            raise ValueError("feature_table: the octaves differ in batch, "
                             "key levels, device or sigmas")
    ptrs = np.array([[o.maps.valid.data_ptr(), o.maps.dx.data_ptr(),
                      o.maps.dy.data_ptr(), o.maps.ds.data_ptr(),
                      o.maps.response.data_ptr(), o.maps.ftype.data_ptr(),
                      o.rows.data_ptr()] for o in octs], dtype=np.uint64)
    dims = np.array([[*o.maps.valid.shape[2:], o.capacity] for o in octs],
                    dtype=np.int32)
    new = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)  # noqa: E731
    x, y, sigma, theta, resp = (new((B, cap), torch.float32)
                                for _ in range(5))
    ftype, level_id = new((B, cap), torch.int32), new((B, cap), torch.int32)
    valid = new((B, cap), torch.bool)
    level_counts = new((B, len(octs) * NK), torch.int32)
    pre_count = new((B,), torch.int32)
    fn = build.function("hg_feature_table", _TABLE_ARGTYPES)
    with build.on_device_of(valid):
        err = fn(ptrs.ctypes.data, dims.ctypes.data, len(octs), B, NK, cap,
                 first.sigmas.data_ptr(), first.sigma_step, x.data_ptr(),
                 y.data_ptr(), sigma.data_ptr(), theta.data_ptr(),
                 resp.data_ptr(), ftype.data_ptr(), level_id.data_ptr(),
                 valid.data_ptr(), level_counts.data_ptr(),
                 pre_count.data_ptr(), build.stream_of(valid))
    build.check(err, "feature_table")
    build.count_launch("level_scan")
    build.count_launch("table_scatter")
    table = GlobalTable(x=x, y=y, sigma=sigma, theta=theta, response=resp,
                        ftype=ftype, level_id=level_id, valid=valid)
    return table, level_counts, pre_count
