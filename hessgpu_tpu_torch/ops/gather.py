"""Per-level gradient maps and cross-level window gathers (counterpart of
hessgpu_tpu/ops/gather.py).

The per-keypoint stages read a window of the gradient magnitude / angle maps
of the level each keypoint lies on. LevelMaps holds those maps as the detect
stage leaves them - one contiguous (B, NK, h, w) tensor per octave - and
numbers the levels octave-major (level id = octave * NK + key index). The
CUDA kernels take a pointer per level (nothing is copied); the plain PyTorch
versions gather static-size windows from one flat buffer with window_gather,
like the JAX package's jnp path. A level may also be a band of rows of a
taller one, read in global rows through its row origin (the row-sharded
path).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class LevelGeometry(NamedTuple):
    """Where one level's maps lie: group `group`, index `index` within it;
    the buffer's rows and width (rows, w); the element offset of batch
    item 0's plane in the flat buffer (base) and from one item to the next
    (bstride); the level's global height (height) and the global row of
    batch item b's buffer row 0 (row0 + b * row_step)."""
    group: int
    index: int
    rows: int
    w: int
    base: int
    bstride: int
    height: int
    row0: int
    row_step: int


class LevelMaps(NamedTuple):
    """Gradient magnitude and angle maps of every key level of a pyramid.

    grad, rot: one float32 (B, NK_o, h_o, w_o) tensor per octave (any group
    of equal-sized levels); level ids run over the groups in order.

    A group may hold a band of a taller level (the row-sharded path,
    parallel/spatial.py): row0, row_step and height give, per group, the
    global row of batch item b's buffer row 0 (row0 + b * row_step) and the
    level's global height. Keypoints and the [1, height - 2] clamp are in
    global rows, and global row iy is read from buffer row iy - row0 -
    row_step * b. Empty (the default): every buffer is its whole level."""
    grad: Tuple[torch.Tensor, ...]
    rot: Tuple[torch.Tensor, ...]
    row0: Tuple[int, ...] = ()
    row_step: Tuple[int, ...] = ()
    height: Tuple[int, ...] = ()

    @property
    def batch(self) -> int:
        return int(self.grad[0].shape[0])

    def geometry(self):
        """One LevelGeometry per level, in level-id order."""
        out, base = [], 0
        for gi, g in enumerate(self.grad):
            B, nk, h, w = (int(s) for s in g.shape)
            r0 = self.row0[gi] if self.row0 else 0
            step = self.row_step[gi] if self.row_step else 0
            hg = self.height[gi] if self.height else h
            for k in range(nk):
                out.append(LevelGeometry(gi, k, h, w, base + k * h * w,
                                         nk * h * w, hg, r0, step))
            base += B * nk * h * w
        return out

    def flat(self):
        """The flattened form the plain versions gather from: (flat_grad,
        flat_rot, columns), columns being the LevelGeometry fields base,
        bstride, height, w, row0, row_step and rows as int64 (NL,) tensors
        on the maps' device."""
        dev = self.grad[0].device
        geo = self.geometry()
        col = lambda f: torch.tensor([getattr(g, f) for g in geo],
                                     dtype=torch.int64, device=dev)
        return (torch.cat([g.reshape(-1) for g in self.grad]),
                torch.cat([r.reshape(-1) for r in self.rot]),
                tuple(col(f) for f in ("base", "bstride", "height", "w",
                                       "row0", "row_step", "rows")))


def check_level_maps(maps: LevelMaps) -> None:
    if len(maps.grad) != len(maps.rot) or not maps.grad:
        raise ValueError("LevelMaps: grad and rot need one tensor per octave")
    for g, r in zip(maps.grad, maps.rot):
        if g.ndim != 4 or g.shape != r.shape:
            raise ValueError(f"LevelMaps: expected equal (B, NK, h, w) maps, "
                             f"got {tuple(g.shape)} and {tuple(r.shape)}")
        if g.dtype != torch.float32 or r.dtype != torch.float32:
            raise TypeError("LevelMaps: maps must be float32")
        if g.shape[0] != maps.grad[0].shape[0] or g.device != r.device \
                or g.device != maps.grad[0].device:
            raise ValueError("LevelMaps: one batch size and one device")
    for name in ("row0", "row_step", "height"):
        if getattr(maps, name) and len(getattr(maps, name)) != len(maps.grad):
            raise ValueError(f"LevelMaps: {name} needs one entry per group")


def window_gather(flat: torch.Tensor, base, h, w, ky, kx, wsize: int,
                  row0=None, rows=None):
    """(K, wsize, wsize) windows around the keypoints (ky, kx) of K levels.

    flat: (T,) flattened concatenation of level images. base, h, w: int64
    (K,) - each keypoint's plane offset and level size. ky, kx: float (K,)
    centres; the window starts at floor(k) - (wsize - 1) // 2.
    row0, rows: int64 (K,) or None - for a band buffer, the global row of
    its row 0 and its row count: global row iy (clamped to the level) is
    read from buffer row iy - row0, kept inside the buffer.
    Returns (windows, y0, x0) with y0/x0 the *unclamped* integer window
    origins (absolute level coordinates - the masks downstream use these).
    Out-of-image indices clamp to the border pixel; callers mask them out.
    """
    r = (wsize - 1) // 2
    y0 = torch.floor(ky).to(torch.int64) - r
    x0 = torch.floor(kx).to(torch.int64) - r
    ar = torch.arange(wsize, device=flat.device)
    hm1 = (h - 1)[:, None]
    wm1 = (w - 1)[:, None]
    ys = torch.minimum((y0[:, None] + ar).clamp_(min=0), hm1)     # (K, ws)
    xs = torch.minimum((x0[:, None] + ar).clamp_(min=0), wm1)
    if row0 is not None:
        ys = torch.minimum((ys - row0[:, None]).clamp_(min=0),
                           (rows - 1)[:, None])
    idx = (base[:, None, None] + ys[:, :, None] * w[:, None, None]
           + xs[:, None, :])
    return flat[idx], y0, x0
