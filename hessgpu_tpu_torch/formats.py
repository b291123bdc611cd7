"""Feature file I/O: the reference's three SaveSIFT formats plus loaders (the
port's own copy of hessgpu_tpu/formats.py; the files are byte-equal).

Reference: SiftPyramid::SaveSIFT (SiftPyramid.cpp:357-571).
  1. text:   "N 128" header, per keypoint "y x s o response type level" then
             128 ints (floor(0.5 + 512*d)), 20 per line.
  2. binary (-b): int N, int 128; per keypoint 4 floats (y x s o), response
             float, type u16, level u16, then 128 descriptor floats.
  3. vlfeat binary (-bvlf): magic "aff\\1", N, descLen, W, H; per keypoint
             x, y, scale*mrSize, 2x2 affine from theta, level<<2|type u32,
             response, u8 descriptor floor(0.5 + 255*d).
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from .config import SiftConfig


def save_sift(path: str, feats: dict, cfg: Optional[SiftConfig] = None,
              image_size=(0, 0)) -> None:
    cfg = cfg or SiftConfig()
    if cfg.binary_sift == 2:
        save_sift_vlfeat(path, feats, cfg, image_size)
    elif cfg.binary_sift == 1:
        save_sift_binary(path, feats, cfg)
    else:
        save_sift_text(path, feats, cfg)


def save_sift_text(path: str, feats: dict, cfg: Optional[SiftConfig] = None) -> None:
    cfg = cfg or SiftConfig()
    if cfg.compute_descriptors and feats["x"].shape[0] > 0:
        from .native import write_sift_text
        if write_sift_text(path, feats):
            return
    n = feats["x"].shape[0]
    dim = feats["desc"].shape[1] if cfg.compute_descriptors else 0
    lines = [f"{n} {dim}"]
    for i in range(n):
        head = (f"{feats['y'][i]:.2f} {feats['x'][i]:.2f} "
                f"{feats['sigma'][i]:.3f} {feats['theta'][i]:.3f} "
                f"{feats['response'][i]:.8f} "
                f"{int(feats['ftype'][i])} {int(feats['level'][i])}")
        lines.append(head)
        if dim:
            q = np.floor(0.5 + 512.0 * feats["desc"][i]).astype(np.int64)
            row = []
            for k in range(dim):
                row.append(str(int(q[k])))
                if (k + 1) % 20 == 0:
                    row.append("\n")
            # join with spaces, respecting the 20-per-line breaks
            text = ""
            for tok in row:
                text += tok if tok == "\n" else (tok + " ")
            lines.append(text.rstrip(" "))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def save_sift_binary(path: str, feats: dict, cfg: Optional[SiftConfig] = None) -> None:
    cfg = cfg or SiftConfig()
    n = feats["x"].shape[0]
    dim = feats["desc"].shape[1] if cfg.compute_descriptors else 0
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", n, dim))
        for i in range(n):
            f.write(struct.pack("<ffff", feats["y"][i], feats["x"][i],
                                feats["sigma"][i], feats["theta"][i]))
            f.write(struct.pack("<f", feats["response"][i]))
            f.write(struct.pack("<HH", int(feats["ftype"][i]) & 0xFFFF,
                                int(feats["level"][i]) & 0xFFFF))
            if dim:
                f.write(feats["desc"][i].astype("<f4").tobytes())


def save_sift_vlfeat(path: str, feats: dict, cfg: Optional[SiftConfig] = None,
                     image_size=(0, 0)) -> None:
    cfg = cfg or SiftConfig()
    n = feats["x"].shape[0]
    dim = feats["desc"].shape[1] if cfg.compute_descriptors else 0
    with open(path, "wb") as f:
        f.write(b"aff\x01")
        f.write(struct.pack("<iiii", n, dim, image_size[1], image_size[0]))
        for i in range(n):
            o = float(feats["theta"][i])
            f.write(struct.pack("<fff", feats["x"][i], feats["y"][i],
                                feats["sigma"][i] * cfg.mr_size))
            f.write(struct.pack("<ffff", np.cos(o), -np.sin(o),
                                np.sin(o), np.cos(o)))
            f.write(struct.pack("<I", (int(feats["level"][i]) << 2)
                                | int(feats["ftype"][i])))
            f.write(struct.pack("<f", feats["response"][i]))
            if dim:
                q = np.clip(np.floor(0.5 + 255.0 * feats["desc"][i]),
                            0, 255).astype(np.uint8)
                f.write(q.tobytes())


def load_sift_text(path: str) -> dict:
    """Load the text format (works for reference .sift outputs too).

    Handles both the Hessian 7-field header per keypoint and the original
    SiftGPU 4-field header (y x s o).
    """
    with open(path) as f:
        tokens = f.read().split()
    pos = 0
    n = int(tokens[pos]); pos += 1
    dim = int(tokens[pos]); pos += 1
    # detect per-keypoint field count by scanning the first record
    # hessian: 5 floats + 2 ints; original: 4 floats
    feats = {k: np.zeros(n, np.float32) for k in
             ("x", "y", "sigma", "theta", "response")}
    feats["ftype"] = np.zeros(n, np.int32)
    feats["level"] = np.zeros(n, np.int32)
    feats["desc"] = np.zeros((n, dim), np.float32)

    # figure out the number of header fields
    rec_len = 7 + dim
    if len(tokens) - 2 == n * (4 + dim):
        rec_len = 4 + dim
    for i in range(n):
        feats["y"][i] = float(tokens[pos]); pos += 1
        feats["x"][i] = float(tokens[pos]); pos += 1
        feats["sigma"][i] = float(tokens[pos]); pos += 1
        feats["theta"][i] = float(tokens[pos]); pos += 1
        if rec_len == 7 + dim:
            feats["response"][i] = float(tokens[pos]); pos += 1
            feats["ftype"][i] = int(tokens[pos]); pos += 1
            feats["level"][i] = int(tokens[pos]); pos += 1
        if dim:
            vals = [float(t) for t in tokens[pos:pos + dim]]
            pos += dim
            feats["desc"][i] = np.array(vals, np.float32) / 512.0
    return feats
