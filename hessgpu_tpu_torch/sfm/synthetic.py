"""Seeded synthetic frames (own copy of hessgpu_tpu/sfm/synthetic.make_texture).

The frame source of the port's tests and of chip_smoke.py: every input is
made from a seed, none is read from disk.
"""

from __future__ import annotations

import numpy as np


def make_texture(rng: np.random.RandomState, size: int = 512,
                 n_blobs: int = 900) -> np.ndarray:
    """Procedural blob texture in [0, 1]: high-contrast random Gaussians
    at the scales the detector's octaves respond to.

    Blobs are *composited* (each overwrites its disk region toward its own
    intensity) rather than summed, so local contrast survives - summed
    blobs average out and the det-of-Hessian response lands below
    threshold.

    Same values as the JAX package's make_texture for the same rng; each
    blob is composited inside the bounding box of its 3-sigma disk only,
    which is all it touches."""
    t = np.full((size, size), 0.5, np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for _ in range(n_blobs):
        cx, cy = rng.rand(2) * size
        sigma = 1.2 + rng.rand() ** 2 * 7.0
        val = rng.rand()  # target intensity of this blob
        r = 3.0 * sigma
        box = (slice(max(int(cy - r), 0), min(int(cy + r) + 2, size)),
               slice(max(int(cx - r), 0), min(int(cx + r) + 2, size)))
        d2 = (xx[box] - cx) ** 2 + (yy[box] - cy) ** 2
        m = d2 < r ** 2
        alpha = np.exp(-0.5 * d2[m] / (sigma * sigma))
        sub = t[box]
        sub[m] = (1 - alpha) * sub[m] + alpha * val
    t += 0.02 * rng.rand(size, size).astype(np.float32)
    return np.clip(t, 0.0, 1.0)


def texture_frame(seed: int, height: int = 480, width: int = 640) -> np.ndarray:
    """The (height, width) top-left crop of the seed's square texture."""
    side = max(height, width)
    return make_texture(np.random.RandomState(seed), side)[:height, :width]
