"""hessgpu_tpu_torch: the PyTorch/CUDA port of hessgpu_tpu.

Plain tensor code is PyTorch; the dense kernels are hand-written CUDA for
Hopper under csrc/, built at first launch (never at import). The package
imports torch and numpy only.

Ported so far: the batched Gaussian pyramid and the fused detector
("detection only, upright": SiftConfig(compute_descriptors=False,
fixed_orientation=True)). Orientation histograms and descriptors are the
next slice; configurations that need them raise NotImplementedError.
"""

from .config import SiftConfig
from .features import FeatureTable, to_numpy_trimmed
from .parallel.batch import detect_batch
from .pyramid import (detect_and_describe, make_plan, run_pipeline,
                      run_pipeline_batched)

__all__ = [
    "SiftConfig", "FeatureTable", "to_numpy_trimmed", "detect_batch",
    "detect_and_describe", "make_plan", "run_pipeline",
    "run_pipeline_batched",
]
