"""Builds the port's feature server (csrc/hess_server.cpp) with g++ at first
use.

    python -m hessgpu_tpu_torch.server_build      # builds, prints the path

The server embeds this interpreter: the include and link flags come from
sysconfig (python3-config may be absent), and the interpreter's path is
compiled in, so the server's Python finds the same packages (a virtual
environment's too). Without a shared libpython the static one is linked
with -export-dynamic, so that extension modules (torch's) resolve against
it. The binary's name carries a hash of the source and the flags, as the
kernel library's does (ops/cuda/build.py); it goes to
hessgpu_tpu_torch/build/ (listed in .gitignore).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import time
from pathlib import Path
from typing import List, Optional

PKG_DIR = Path(__file__).resolve().parent
SOURCE = PKG_DIR / "csrc" / "hess_server.cpp"
BUILD_DIR = PKG_DIR / "build"

build_seconds: Optional[float] = None   # wall time of the last build here


def flags() -> List[str]:
    """g++ flags after the source: the interpreter's headers, its library
    and the path of its executable."""
    var = sysconfig.get_config_var
    out = ["-O2", "-std=c++17", "-pthread", f"-I{var('INCLUDEPY')}",
           f'-DHESS_PYTHON_EXECUTABLE="{sys.executable}"']
    libs = (var("LIBS") or "").split() + (var("SYSLIBS") or "").split()
    if var("Py_ENABLE_SHARED"):
        libdir = var("LIBDIR")
        out += [f"-L{libdir}", f"-Wl,-rpath,{libdir}",
                f"-lpython{var('LDVERSION')}"]
    else:
        out += ["-Xlinker", "-export-dynamic",
                os.path.join(var("LIBPL"), var("LIBRARY"))]
    return out + libs


def _digest() -> str:
    h = hashlib.sha256(" ".join(flags()).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def build(out_dir: Optional[os.PathLike] = None) -> Path:
    """Compile the server if it is not there; returns its path. out_dir
    defaults to hessgpu_tpu_torch/build/."""
    global build_seconds
    out = Path(out_dir) if out_dir is not None else BUILD_DIR
    path = out / f"hess_server_{_digest()}"
    if path.exists():
        return path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build the feature "
                           "server")
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / f"{path.name}_{os.getpid()}"
    t0 = time.perf_counter()
    res = subprocess.run([cxx, str(SOURCE), "-o", str(tmp), *flags()],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{res.stdout}")
    os.replace(tmp, path)   # atomic: a concurrent process sees all or nothing
    build_seconds = time.perf_counter() - t0
    return path


if __name__ == "__main__":
    print(build())
