"""Stream compaction with static shapes (counterpart of
hessgpu_tpu/ops/compaction.py).

A dense boolean keypoint map becomes a fixed-capacity list. Membership is
the JAX package's: per key level, the leftmost `min(w, _row_cap(w))` valid
cells of each row (the per-row candidate cap, which decides which keypoints
are kept), then the first `capacity` of those in raster order, zeros past
`count`. Its sort keys and packed payloads are TPU cost decisions and are
not carried over. Here each kept cell gets its 1-based rank from prefix
sums, a non-decreasing `pos` that steps by exactly 1 at each kept cell, and
slot s takes the first cell whose `pos` reaches s + 1 (a binary search).
Shapes never depend on the data, so nothing synchronises with the host
(torch.nonzero and boolean indexing would).

_globalize concatenates the per-octave lists into the global table
(GlobalTable), level-major. On the card ops/cuda/compact.py does both steps
in kernels; these functions are its plain route.

Capacity policy mirrors the reference: per-level cap
min(0.5% of pixels, 4096) (PyramidCU.cpp:443-451, GlobalUtil.cpp:67-68);
overflowing keypoints are dropped in raster order.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch

from .keypoint import f32

# Per-row candidate floor of the octave compaction (the cap scales with
# width, _row_cap). The JAX package chose 32 as far above observed densities
# at bench widths (the reference's own saddle-flood demo, checkerboard.png
# at -t 0.000001, peaks at 10 detections in a row); the cap decides
# membership, so the port keeps it.
_ROW_CAP = 32


def _row_cap(w: int) -> int:
    """Per-row candidate cap for a w-wide level: max(32, w/32), <= 256.

    The 3x3 NMS admits up to w/2 survivors per row, so a fixed cap can
    truncate where the reference (per-level area cap only,
    PyramidCU.cpp:443-451) would not. Scaling with width bounds the
    divergence: truncation requires ONE row of ONE level to sustain more
    than 1 NMS survivor per 32 px across its whole extent while the level
    is still under its 0.5%-of-pixels cap - e.g. >64 survivors in a single
    2048-px row."""
    return max(_ROW_CAP, min(256, w // 32))


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


def _first_slots(pos: torch.Tensor, capacity: int):
    """Slots from ranks. pos: int32 (..., n), non-decreasing along the last
    axis and stepping by exactly 1 at each cell to keep (so a kept cell's pos
    is its 1-based rank). Slot s is the first cell whose pos reaches s + 1.

    Returns (src (..., capacity) i64 indices into the last axis, the last
    index past count; slot_valid (..., capacity) bool; count (...,) i32)."""
    n = pos.shape[-1]
    count = pos[..., -1].clamp(max=capacity)
    want = torch.arange(1, capacity + 1, dtype=torch.int32, device=pos.device)
    src = torch.searchsorted(
        pos, want.expand(pos.shape[:-1] + (capacity,)).contiguous())
    # a slot past count finds no cell (n); callers mask every such slot
    return src.clamp_(max=n - 1), want <= count[..., None], count


def compact_indices(valid: torch.Tensor, capacity: int):
    """First-`capacity` valid indices along the last axis, in index order.

    valid: bool (..., n). Returns (src, slot_valid, count) as
    _first_slots."""
    return _first_slots(torch.cumsum(valid, dim=-1, dtype=torch.int32),
                        capacity)


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
                             capacity: int, row_offset=None) -> FeatureList:
    """Dense KeypointMaps for all key levels of one octave ((..., NK, H, W)
    leaves, leading batch dims allowed) -> one blocked FeatureList with
    (..., NK, capacity) leaves (row k = key level k).

    Membership is the JAX package's: the leftmost kpr = min(w, _row_cap(w))
    valid cells of each row, then the first `capacity` of those in raster
    order. A cell's rank within its row comes from a prefix sum along W,
    the rows' capped counts from one along H, so no prefix sum runs over a
    whole H*W map.

    Coordinates follow the reference convention: x = col + 0.5 + dx
    (ComputeOrientation_Kernel, ProgramCU.cu:1281-1298), scale =
    level_sigma * sigma_step**ds. sigmas: the NK level sigmas, as floats or
    as one f32 tensor on the maps' device (saves a host-to-device copy per
    call). Only valid cells of response, dx, dy, ds and ftype reach the
    result: the detect kernel leaves the others undefined. row_offset: an
    int64 tensor broadcast against the (..., NK, capacity) slots, added to
    each row before y is formed - the global row of a band's row 0, so
    that y is the one-device value exactly.
    """
    h, w = maps.valid.shape[-2:]
    flat = lambda a: a.reshape(a.shape[:-2] + (h * w,))
    # rank within the row, capped: a cell past the cap repeats the rank of
    # the row's last kept cell, so pos steps only at kept cells
    rank = torch.cumsum(maps.valid, dim=-1, dtype=torch.int32)
    rank.clamp_(max=min(w, _row_cap(w)))
    kept = rank[..., -1]                          # kept cells per row
    before = torch.cumsum(kept, dim=-1, dtype=torch.int32) - kept
    src, sv, _ = _first_slots(flat(rank.add_(before[..., None])), capacity)
    take = lambda a: torch.gather(flat(a), -1, src)
    # slots past count gathered the last cell: everything is masked below
    dx, dy, ds = take(maps.dx), take(maps.dy), take(maps.ds)
    row = torch.div(src, w, rounding_mode="floor")
    x = ((src - row * w) + 0.5) + dx          # int + 0.5 is exact in f32
    y = ((row if row_offset is None else row + row_offset) + 0.5) + dy
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


class GlobalTable(NamedTuple):
    """Cross-level compacted keypoint table (level coordinates), (B, G)."""
    x: torch.Tensor
    y: torch.Tensor
    sigma: torch.Tensor
    theta: torch.Tensor
    response: torch.Tensor
    ftype: torch.Tensor
    level_id: torch.Tensor   # i32 flattened (octave * s + key_level - 1)
    valid: torch.Tensor

    def count(self) -> torch.Tensor:
        return self.valid.sum(dim=-1, dtype=torch.int32)


def _globalize(lists: List[FeatureList], cap: int,
               level_ids: torch.Tensor) -> GlobalTable:
    """Concatenate per-octave blocked lists ((B, NK, cap_o) leaves) and
    compact into one global table, level-major (= the reference's output
    order). level_ids: the static level id of each concatenated slot
    (_PlanConstants.level_ids)."""
    def cat(field):
        return torch.cat([getattr(fl, field).flatten(-2) for fl in lists],
                         dim=-1)

    valid = cat("valid")
    lid = level_ids.expand(valid.shape)
    _, outs, slot_valid = compact_sorted(
        valid,
        [cat("x"), cat("y"), cat("sigma"), cat("response"), cat("ftype"),
         lid],
        cap,
    )
    x, y, s, r, ft, lid = outs
    return GlobalTable(x=x, y=y, sigma=s, theta=torch.zeros_like(x),
                       response=r, ftype=ft, level_id=lid, valid=slot_valid)
