"""hessgpu_tpu_torch: the PyTorch/CUDA port of hessgpu_tpu.

Plain tensor code is PyTorch; the dense kernels are hand-written CUDA for
Hopper under csrc/, built at first launch (never at import). The package
imports torch and numpy only.

Ported so far: batched detect + describe end to end for every SiftConfig,
the default included (Gaussian pyramid, fused detector, orientation
histograms with up to 4 orientations per keypoint, 128-d or half-SIFT
descriptors), both detector personalities, through six kernels; and the
keypoint re-entry service (describe_keypoints, describe_rectangles). What
still raises NotImplementedError: first_octave < 0 (DoG's upsampled octave)
and conv_mode="direct".
"""

from .config import SiftConfig
from .describe import describe_keypoints, describe_rectangles
from .features import FeatureTable, to_numpy_trimmed
from .parallel.batch import detect_batch
from .pyramid import (detect_and_describe, make_plan, run_pipeline,
                      run_pipeline_batched)

__all__ = [
    "SiftConfig", "FeatureTable", "to_numpy_trimmed", "detect_batch",
    "detect_and_describe", "make_plan", "run_pipeline",
    "run_pipeline_batched", "describe_keypoints", "describe_rectangles",
]
