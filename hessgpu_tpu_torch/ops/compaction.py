"""Stream compaction with static shapes (counterpart of
hessgpu_tpu/ops/compaction.py).

A dense boolean keypoint map becomes a fixed-capacity list: the first
`capacity` valid cells in raster order, zeros past `count`. Membership is
the JAX package's; its sort keys, per-row candidate cap and packed
payloads are TPU cost decisions and are not carried over. Here an
inclusive prefix sum numbers the valid cells and one scatter writes their
flat indices into their slots. Shapes never depend on the data, so nothing
synchronises with the host (torch.nonzero and boolean indexing would).

Capacity policy mirrors the reference: per-level cap
min(0.5% of pixels, 4096) (PyramidCU.cpp:443-451, GlobalUtil.cpp:67-68);
overflowing keypoints are dropped in raster order.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .keypoint import f32


class FeatureList(NamedTuple):
    """Fixed-capacity SoA keypoint list; leaves (..., K)."""
    x: torch.Tensor         # f32 column + 0.5 + dx (level pixel coords)
    y: torch.Tensor         # f32 row + 0.5 + dy
    sigma: torch.Tensor     # f32 scale in level coords
    theta: torch.Tensor     # f32 orientation (device frame, radians)
    response: torch.Tensor  # f32
    ftype: torch.Tensor     # i32
    valid: torch.Tensor     # bool

    @property
    def capacity(self) -> int:
        return int(self.x.shape[-1])

    def count(self) -> torch.Tensor:
        return self.valid.sum(dim=-1, dtype=torch.int32)


def compact_indices(valid: torch.Tensor, capacity: int):
    """First-`capacity` valid indices along the last axis, in index order.

    valid: bool (..., n). Returns (src (..., capacity) i64 indices into the
    last axis, 0 past count; slot_valid (..., capacity) bool; count (...,)
    i32)."""
    n = valid.shape[-1]
    # pos = 1-based rank of each valid cell; slot 0 of the scatter buffer is
    # never a valid cell's, slot capacity+1 collects every cell that is not
    # kept, and both are cut off
    pos = torch.cumsum(valid, dim=-1, dtype=torch.int32)
    count = pos[..., -1].clamp(max=capacity)
    dest = torch.where(valid, pos, capacity + 1).clamp_(max=capacity + 1)
    idx = torch.arange(n, device=valid.device).expand(valid.shape)
    src = torch.zeros(valid.shape[:-1] + (capacity + 2,), dtype=torch.int64,
                      device=valid.device)
    src.scatter_(-1, dest.to(torch.int64), idx)
    slot_valid = torch.arange(capacity, device=valid.device) < count[..., None]
    return src[..., 1:capacity + 1], slot_valid, count


def compact_sorted(valid: torch.Tensor, values: Sequence[torch.Tensor],
                   capacity: int):
    """Compact `values` (each shaped like valid, (..., n)) to the first
    `capacity` valid slots in index order; every output is zero past
    `count`. Keeps the name of the JAX function whose contract it has.

    Returns (count, [compacted values...], slot_valid)."""
    src, slot_valid, count = compact_indices(valid, capacity)
    outs = []
    for val in values:
        o = torch.gather(val, -1, src)
        outs.append(torch.where(slot_valid, o, torch.zeros_like(o)))
    return count, outs, slot_valid


def compact_octave_keypoints(maps, sigmas, sigma_step: float,
                             capacity: int) -> FeatureList:
    """Dense KeypointMaps for all key levels of one octave ((..., NK, H, W)
    leaves, leading batch dims allowed) -> one blocked FeatureList with
    (..., NK, capacity) leaves (row k = key level k).

    Coordinates follow the reference convention: x = col + 0.5 + dx
    (ComputeOrientation_Kernel, ProgramCU.cu:1281-1298), scale =
    level_sigma * sigma_step**ds. sigmas: the NK level sigmas, as floats or
    as one f32 tensor on the maps' device (saves a host-to-device copy per
    call). Only valid cells of response, dx, dy, ds and ftype reach the
    result: the detect kernel leaves the others undefined.
    """
    h, w = maps.valid.shape[-2:]
    flat = lambda a: a.reshape(a.shape[:-2] + (h * w,))
    src, sv, _ = compact_indices(flat(maps.valid), capacity)
    take = lambda a: torch.gather(flat(a), -1, src)
    # slots past count gathered cell 0: everything is masked below
    dx, dy, ds = take(maps.dx), take(maps.dy), take(maps.ds)
    row = torch.div(src, w, rounding_mode="floor")
    x = ((src - row * w) + 0.5) + dx          # int + 0.5 is exact in f32
    y = (row + 0.5) + dy
    if not isinstance(sigmas, torch.Tensor):
        sigmas = torch.tensor([float(s) for s in sigmas], dtype=torch.float32,
                              device=dx.device)
    sig = sigmas[:, None] * torch.pow(f32(sigma_step), ds)
    fields = torch.where(sv, torch.stack([x, y, sig, take(maps.response)]), 0)
    return FeatureList(
        x=fields[0], y=fields[1], sigma=fields[2],
        theta=torch.zeros_like(x), response=fields[3],
        ftype=torch.where(sv, take(maps.ftype), 0), valid=sv)


def compact_level_keypoints(maps, sigma: float, sigma_step: float,
                            capacity: int) -> FeatureList:
    """Dense KeypointMaps ((..., H, W) leaves) -> FeatureList for one level
    ((..., capacity) leaves); the one-level case of
    compact_octave_keypoints."""
    stacked = type(maps)(*(a.unsqueeze(-3) for a in maps))
    fl = compact_octave_keypoints(stacked, [sigma], sigma_step, capacity)
    return FeatureList(*(a.squeeze(-2) for a in fl))
