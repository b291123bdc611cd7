"""The system under test: the PyTorch and CUDA port's public batch entry,
`hessgpu_tpu_torch.parallel.batch.detect_batch`, loaded from the checkout
this benchmark lies in (never from an installed copy), and the counters it
keeps. Nothing else of the program is read."""

from __future__ import annotations

import importlib
import sys
from pathlib import Path

PACKAGE = "hessgpu_tpu_torch"


class ProgramMissing(RuntimeError):
    pass


def load(root: Path):
    """The port's package from `root`; ProgramMissing if `root` holds none
    (a directory with only the benchmark) or another copy is loaded."""
    if not (root / PACKAGE / "__init__.py").is_file():
        raise ProgramMissing(f"no {PACKAGE} package under {root}")
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    pkg = importlib.import_module(PACKAGE)
    where = Path(pkg.__file__).resolve()
    if root.resolve() not in where.parents:
        raise ProgramMissing(f"{PACKAGE} loaded from {where}, not from {root}")
    return pkg


class Program:
    """detect_batch under one SiftConfig on one device."""

    def __init__(self, root: Path, sift_fields: dict, device):
        load(root)
        from hessgpu_tpu_torch.config import SiftConfig
        from hessgpu_tpu_torch.parallel.batch import detect_batch
        self.cfg = SiftConfig(**sift_fields)
        self.device = device
        self._detect_batch = detect_batch

    def __call__(self, frames):
        return self._detect_batch(frames, self.cfg, device=self.device)

    def counters(self) -> dict:
        """The compiled layer's counters of the captured pipelines
        (utils/graphs.GraphCache of pyramid.run_pipeline_jit) and the
        kernels' build seconds, where a build ran in this process."""
        from hessgpu_tpu_torch import pyramid
        from hessgpu_tpu_torch.ops.cuda import build
        cache = pyramid._PIPELINE_GRAPHS
        stats = cache.stats()
        return dict(capture_s=cache.capture_s, captures=cache.captures,
                    replays=cache.replays,
                    pool_reserved_bytes=sum(s.pool_reserved_bytes
                                            for s in stats),
                    build_s=build.build_seconds)

    def release(self) -> None:
        """Free the captured graphs and their pools."""
        from hessgpu_tpu_torch.pyramid import run_pipeline_jit
        run_pipeline_jit.clear_cache()
