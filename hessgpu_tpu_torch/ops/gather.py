"""Per-level gradient maps and cross-level window gathers (counterpart of
hessgpu_tpu/ops/gather.py).

The per-keypoint stages read a window of the gradient magnitude / angle maps
of the level each keypoint lies on. LevelMaps holds those maps as the detect
stage leaves them - one contiguous (B, NK, h, w) tensor per octave - and
numbers the levels octave-major (level id = octave * NK + key index). The
CUDA kernels take a pointer per level (nothing is copied); the plain PyTorch
versions gather static-size windows from one flat buffer with window_gather,
like the JAX package's jnp path.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class LevelMaps(NamedTuple):
    """Gradient magnitude and angle maps of every key level of a pyramid.

    grad, rot: one float32 (B, NK_o, h_o, w_o) tensor per octave (any group
    of equal-sized levels); level ids run over the groups in order."""
    grad: Tuple[torch.Tensor, ...]
    rot: Tuple[torch.Tensor, ...]

    @property
    def batch(self) -> int:
        return int(self.grad[0].shape[0])

    def geometry(self):
        """Per level, as Python lists: (group index, index within the group,
        h, w, element offset of batch 0's plane in the flat buffer, elements
        from one batch item to the next)."""
        out, base = [], 0
        for gi, g in enumerate(self.grad):
            B, nk, h, w = (int(s) for s in g.shape)
            for k in range(nk):
                out.append((gi, k, h, w, base + k * h * w, nk * h * w))
            base += B * nk * h * w
        return out

    def flat(self):
        """The flattened form the plain versions gather from: (flat_grad,
        flat_rot, level_base, level_bstride, level_h, level_w), the last four
        int64 (NL,) tensors on the maps' device."""
        dev = self.grad[0].device
        geo = self.geometry()
        col = lambda i: torch.tensor([g[i] for g in geo], dtype=torch.int64,
                                     device=dev)
        return (torch.cat([g.reshape(-1) for g in self.grad]),
                torch.cat([r.reshape(-1) for r in self.rot]),
                col(4), col(5), col(2), col(3))


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


def window_gather(flat: torch.Tensor, base, h, w, ky, kx, wsize: int):
    """(K, wsize, wsize) windows around the keypoints (ky, kx) of K levels.

    flat: (T,) flattened concatenation of level images. base, h, w: int64
    (K,) - each keypoint's plane offset and level size. ky, kx: float (K,)
    centres; the window starts at floor(k) - (wsize - 1) // 2.
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
    idx = (base[:, None, None] + ys[:, :, None] * w[:, None, None]
           + xs[:, None, :])
    return flat[idx], y0, x0
