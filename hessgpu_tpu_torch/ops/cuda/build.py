"""Builds csrc/*.cu with nvcc at first use and loads the result with ctypes.

One shared library with a plain C interface: no PyTorch headers, so a build
takes seconds. Each source is compiled to an object by its own nvcc process,
all started together, then linked. The library's name carries a hash of the
sources and flags, so an edited source is never served by a stale build.
The build goes to hessgpu_tpu_torch/build/ (listed in .gitignore).

Flags: sm_90a, -O3, and -fmad=false - the plain PyTorch versions round after
every multiply and add, and the detector's strict comparisons can flip on
one ulp, so the kernels must not contract a*b+c. Never -use_fast_math.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
]

_lib: Optional[ctypes.CDLL] = None
_functions: Dict[str, object] = {}
build_seconds: Optional[float] = None   # wall time of the build, if one ran

# launches per kernel; a wrapper adds one where it launches, nowhere else
_launches: Dict[str, int] = {
    "blur": 0, "octave_chain": 0, "downsample2": 0, "detect_octave": 0,
    "orientation": 0, "descriptor": 0, "null_vector": 0, "svd3": 0,
    "row_counts": 0, "level_scan": 0, "table_scatter": 0}


def count_launch(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of hessgpu_tpu_torch are built "
        "from source at first use and need the CUDA toolkit")


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile and link the library if it is not there; returns its path.
    verbose adds -Xptxas -v and prints the compiler's output."""
    global build_seconds
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    lib_path = BUILD_DIR / f"libhessgpu_{_digest(srcs)}.so"
    if lib_path.exists() and not verbose:
        return lib_path
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    extra = ["-Xptxas", "-v"] if verbose else []
    objs, procs = [], []
    for src in srcs:
        obj = BUILD_DIR / f"{src.stem}_{os.getpid()}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    for src, p, log in zip(srcs, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        if verbose:
            print(log)
    tmp = BUILD_DIR / f"{lib_path.stem}_{os.getpid()}.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)   # atomic: a concurrent process sees all or nothing
    for obj in objs:
        obj.unlink()
    build_seconds = time.perf_counter() - t0
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def function(name: str, argtypes):
    """The library's C function `name` with its argtypes set (every launch
    function returns the CUDA error code of its launch as an int). Without
    argtypes ctypes would pass each pointer as a 32-bit int."""
    f = _functions.get(name)
    if f is None:
        f = getattr(lib(), name)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _functions[name] = f
    return f


def check(err: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        msg = lib().hg_error_string
        msg.argtypes = [ctypes.c_int]
        msg.restype = ctypes.c_char_p
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error "
                           f"{err} ({msg(err).decode()})")


def stream_of(x) -> int:
    """The raw handle of PyTorch's current stream on x's device."""
    import torch
    return torch.cuda.current_stream(x.device).cuda_stream


def on_device_of(x):
    """Context that makes x's device current for a launch (nothing to do, and
    nothing spent, when it already is)."""
    import torch
    if x.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(x.device)
