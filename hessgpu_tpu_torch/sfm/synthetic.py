"""Seeded synthetic frames and the synthetic-scene renderer (own copy of
hessgpu_tpu/sfm/synthetic.py).

The frame source of the port's tests and of chip_smoke.py: every input is
made from a seed, none is read from disk. The scene renderer is the offline
stand-in for TUM/KITTI sequences, with EXACT ground truth: a three-plane
"room corner" (floor + two walls, each carrying a procedural blob texture
that the detector responds to) ray-cast from a smooth camera arc.
`write_tum_sequence` emits the standard TUM RGB-D layout (rgb/*.png +
rgb.txt + groundtruth.txt) for datasets.load_tum_sequence.

The scene is deliberately non-planar (three planes in general position): a
single textured plane is a degenerate configuration for fundamental-matrix
RANSAC, which the two-view initializer relies on.
"""

from __future__ import annotations

import os
from typing import List, Tuple

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


class Plane:
    """Textured rectangle: p0 + u * eu + v * ev, (u, v) in [0, su] x [0, sv]."""

    def __init__(self, p0, eu, ev, su, sv, tex):
        self.p0 = np.asarray(p0, np.float64)
        self.eu = np.asarray(eu, np.float64)
        self.ev = np.asarray(ev, np.float64)
        self.n = np.cross(self.eu, self.ev)
        self.n /= np.linalg.norm(self.n)
        self.su = float(su)
        self.sv = float(sv)
        self.tex = tex


def corner_scene(rng: np.random.RandomState) -> List[Plane]:
    """Floor + back wall + side wall around the corner (-2, 0, 4)."""
    return [
        Plane((-2, 0, 0), (1, 0, 0), (0, 0, 1), 4.0, 4.0,
              make_texture(rng)),                       # floor y=0
        Plane((-2, 0, 4), (1, 0, 0), (0, 1, 0), 4.0, 3.0,
              make_texture(rng)),                       # back wall z=4
        Plane((-2, 0, 0), (0, 0, 1), (0, 1, 0), 4.0, 3.0,
              make_texture(rng)),                       # side wall x=-2
    ]


def look_at(center: np.ndarray, target: np.ndarray,
            up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """World-to-camera rotation with +z forward (pinhole convention;
    up=-y matches image row direction)."""
    z = target - center
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z])  # rows = camera axes in world coords


def arc_trajectory(n_frames: int, radius: float = 3.0,
                   sweep: float = 1.2,
                   passes: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Camera centers on a horizontal arc in front of the corner, looking
    at a fixed target; returns (R_w2c (N,3,3), centers (N,3)).

    passes > 1 sweeps the arc back and forth (triangle wave): the camera
    revisits earlier positions, so a long sequence carries genuine loop
    closures for the pose graph (each pass crosses every arc position)."""
    target = np.array([0.0, 1.2, 3.0])
    Rs, cs = [], []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1) * passes  # in [0, passes]
        seg = int(min(s, passes - 1e-9))
        frac = s - seg
        u = frac if seg % 2 == 0 else 1.0 - frac
        a = (-0.5 + u) * sweep
        c = np.array([radius * np.sin(a), 1.5 + 0.15 * np.sin(3 * a),
                      3.0 - radius * np.cos(a)])
        Rs.append(look_at(c, target))
        cs.append(c)
    return np.stack(Rs), np.stack(cs)


def render(planes: List[Plane], K: np.ndarray, R_w2c: np.ndarray,
           center: np.ndarray, h: int, w: int) -> np.ndarray:
    """Ray-cast one grayscale view: nearest plane hit per pixel, bilinear
    texture sample. Background = 0.5."""
    Kinv = np.linalg.inv(K)
    vv, uu = np.mgrid[0:h, 0:w].astype(np.float64)
    pix = np.stack([uu + 0.5, vv + 0.5, np.ones_like(uu)], -1)
    d = pix @ Kinv.T @ R_w2c            # ray dirs in world: R^T K^-1 pix
    img = np.full((h, w), 0.5, np.float32)
    depth = np.full((h, w), np.inf)
    for pl in planes:
        dn = d @ pl.n
        lam = ((pl.p0 - center) @ pl.n) / np.where(np.abs(dn) < 1e-12,
                                                   np.inf, dn)
        pts = center + lam[..., None] * d
        rel = pts - pl.p0
        u = rel @ pl.eu / (pl.eu @ pl.eu)
        v = rel @ pl.ev / (pl.ev @ pl.ev)
        hit = (lam > 0.1) & (u >= 0) & (u <= 1.0 * pl.su) \
            & (v >= 0) & (v <= 1.0 * pl.sv) & (lam < depth)
        th, tw = pl.tex.shape
        tu = np.clip(u / pl.su * (tw - 1), 0, tw - 1.000001)
        tv = np.clip(v / pl.sv * (th - 1), 0, th - 1.000001)
        i0 = tv.astype(np.int64)
        j0 = tu.astype(np.int64)
        fv = (tv - i0).astype(np.float32)
        fu = (tu - j0).astype(np.float32)
        tex = pl.tex
        val = (tex[i0, j0] * (1 - fv) * (1 - fu)
               + tex[i0, j0 + 1] * (1 - fv) * fu
               + tex[i0 + 1, j0] * fv * (1 - fu)
               + tex[i0 + 1, j0 + 1] * fv * fu)
        img = np.where(hit, val.astype(np.float32), img)
        depth = np.where(hit, lam, depth)
    return img


def rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w), TUM order."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        x, y, z, w = q
    return np.array([x, y, z, w])


def tum_sequence(n_frames: int = 40, h: int = 240, w: int = 320,
                 seed: int = 7, passes: int = 1):
    """The frames of write_tum_sequence, in memory: (u8 frames (N, h, w),
    K, world->camera rotations (N, 3, 3), camera centers (N, 3))."""
    rng = np.random.RandomState(seed)
    planes = corner_scene(rng)
    f = 0.9 * w
    K = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]])
    Rs, cs = arc_trajectory(n_frames, passes=passes)
    frames = np.stack([
        (render(planes, K, Rs[i], cs[i], h, w) * 255).astype(np.uint8)
        for i in range(n_frames)])
    return frames, K, Rs, cs


def write_tum_sequence(out_dir: str, n_frames: int = 40,
                       h: int = 240, w: int = 320,
                       seed: int = 7, passes: int = 1) -> dict:
    """Render a sequence and write the standard TUM RGB-D layout.

    Returns {"root": out_dir, "K": intrinsics, "gt_centers": (N, 3)}.
    """
    from PIL import Image

    frames, K, Rs, cs = tum_sequence(n_frames, h, w, seed, passes)
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    rgb_lines = []
    gt_lines = []
    for i in range(n_frames):
        name = f"rgb/{i:06d}.png"
        Image.fromarray(frames[i]).save(os.path.join(out_dir, name))
        ts = float(i) * 0.1
        rgb_lines.append(f"{ts:.6f} {name}")
        # TUM groundtruth: camera-to-world pose
        q = rot_to_quat(Rs[i].T)
        gt_lines.append(
            f"{ts:.6f} {cs[i, 0]:.6f} {cs[i, 1]:.6f} {cs[i, 2]:.6f} "
            f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")
    with open(os.path.join(out_dir, "rgb.txt"), "w") as fh:
        fh.write("# timestamp filename\n" + "\n".join(rgb_lines) + "\n")
    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as fh:
        fh.write("# timestamp tx ty tz qx qy qz qw\n"
                 + "\n".join(gt_lines) + "\n")
    return {"root": out_dir, "K": K, "gt_centers": cs}
