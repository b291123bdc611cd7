"""Image ingestion: decode, gray conversion, size limiting (the port's own
copy of hessgpu_tpu/io_image.py).

Replaces GLTexInput's DevIL decode + CPU preprocessing
(GLTexImage.cpp:738-1221). PGM/PPM/PNM files go through a standalone parser
and need no image library; other formats import PIL when one is loaded.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def load_pnm(path: str) -> np.ndarray:
    """Minimal PGM (P2/P5) / PPM (P3/P6) reader.

    Equivalent of the reference's fallback parser (GLTexImage.cpp:1160-1220).
    Returns (H, W) or (H, W, 3) uint8 (16-bit files are scaled down).
    """
    with open(path, "rb") as f:
        data = f.read()

    pos = 0

    def token():
        nonlocal pos
        while True:
            while pos < len(data) and data[pos:pos + 1].isspace():
                pos += 1
            if pos < len(data) and data[pos:pos + 1] == b"#":
                while pos < len(data) and data[pos:pos + 1] != b"\n":
                    pos += 1
            else:
                break
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        return data[start:pos]

    magic = token().decode()
    if magic not in ("P2", "P3", "P5", "P6"):
        raise ValueError(f"not a PGM/PPM file: {magic!r}")
    w = int(token())
    h = int(token())
    maxval = int(token())
    channels = 3 if magic in ("P3", "P6") else 1

    if magic in ("P5", "P6"):
        pos += 1  # single whitespace after maxval
        dtype = np.dtype(">u2") if maxval > 255 else np.uint8
        count = w * h * channels
        arr = np.frombuffer(data, dtype=dtype, count=count, offset=pos)
    else:
        vals = data[pos:].split()
        arr = np.array([int(v) for v in vals[: w * h * channels]],
                       dtype=np.uint32)

    if maxval > 255:
        arr = (arr.astype(np.uint32) * 255 // maxval)
    arr = arr.astype(np.uint8)
    return arr.reshape((h, w, 3)) if channels == 3 else arr.reshape((h, w))


def load_image(path: str) -> np.ndarray:
    """Load an image as uint8 (H, W) or (H, W, 3)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".pgm", ".ppm", ".pnm"):
        from .native import decode_pnm_gray
        native = decode_pnm_gray(path)
        if native is not None:
            return native
        return load_pnm(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"load_image({path!r}): reading {ext or 'this'} files needs "
            "Pillow, which is not installed; .pgm/.ppm/.pnm need no image "
            "library") from e
    with Image.open(path) as im:
        if im.mode not in ("L", "RGB"):
            im = im.convert("RGB")
        return np.asarray(im)


def limit_working_size(img: np.ndarray, max_dim: int) -> Tuple[np.ndarray, int]:
    """Downsample by powers of two until max(H, W) <= max_dim.

    Equivalent of the reference's octave-skip under -maxd
    (PyramidCU.cpp:153-191). Returns (image, downsample_factor_log2).
    """
    ds = 0
    while max(img.shape[0], img.shape[1]) > max_dim:
        img = img[::2, ::2]
        ds += 1
    return img, ds
