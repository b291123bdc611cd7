"""ctypes bindings for the native I/O library (csrc/build/libhessio.so; the
port's own copy of hessgpu_tpu/native.py).

Optional acceleration: callers fall back to the pure-Python paths when the
library isn't built. Build with `make -C csrc`.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

# the repository's own build of csrc/hessio.cpp (make -C csrc)
LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "build", "libhessio.so")
_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(LIB_PATH):
        return None
    lib = ctypes.CDLL(LIB_PATH)
    lib.hessio_decode_pnm_gray.restype = ctypes.c_int
    lib.hessio_decode_pnm_gray.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.hessio_free.argtypes = [ctypes.c_void_p]
    lib.hessio_write_sift_text.restype = ctypes.c_int
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.hessio_write_sift_text.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        f32p, f32p, f32p, f32p, f32p, i32p, i32p, f32p]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def decode_pnm_gray(path: str) -> Optional[np.ndarray]:
    """Native PGM/PPM decode to (H, W) uint8 grayscale; None if unavailable
    or on decode failure (caller falls back)."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_uint8)()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.hessio_decode_pnm_gray(path.encode(), ctypes.byref(out),
                                    ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    try:
        buf = np.ctypeslib.as_array(out, shape=(h.value, w.value)).copy()
    finally:
        lib.hessio_free(out)
    return buf


def write_sift_text(path: str, feats: dict) -> bool:
    """Native text .sift writer; returns False if unavailable."""
    lib = _load()
    if lib is None:
        return False
    n = int(feats["x"].shape[0])
    desc = np.ascontiguousarray(feats["desc"], np.float32)
    dim = int(desc.shape[1]) if n else 0
    rc = lib.hessio_write_sift_text(
        path.encode(), n, dim,
        np.ascontiguousarray(feats["x"], np.float32),
        np.ascontiguousarray(feats["y"], np.float32),
        np.ascontiguousarray(feats["sigma"], np.float32),
        np.ascontiguousarray(feats["theta"], np.float32),
        np.ascontiguousarray(feats["response"], np.float32),
        np.ascontiguousarray(feats["ftype"], np.int32),
        np.ascontiguousarray(feats["level"], np.int32),
        desc)
    return rc == 0
