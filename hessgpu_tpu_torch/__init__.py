"""hessgpu_tpu_torch: the PyTorch/CUDA port of hessgpu_tpu.

Plain tensor code is PyTorch; the dense kernels are hand-written CUDA for
Hopper under csrc/, built at first launch (never at import). The package
imports torch and numpy only (and Pillow, when an image that is not
PGM/PPM is read or a view is written).

Ported so far: batched detect + describe end to end for every SiftConfig
(Gaussian pyramid by the incremental chain or by direct blurs, the
upsampled first octave, fused detector, orientation histograms with up to 4
orientations per keypoint, 128-d or half-SIFT descriptors), both detector
personalities, through six kernels; the keypoint re-entry service
(describe_keypoints, describe_rectangles); the HessianSift and SiftMatcher
facades, the .sift formats, the hess CLI (python -m
hessgpu_tpu_torch.cli.hess), the repeatability evaluation, and the SfM
stack on one device (hessgpu_tpu_torch.sfm: two-view geometry, bundle
adjustment, pose graph, incremental reconstruction):

    from hessgpu_tpu_torch import HessianSift, SiftMatcher, SiftConfig
    sift = HessianSift(SiftConfig())       # device="cpu" to ask for the CPU
    feats = sift.run("image.pgm")          # dict of arrays + descriptors
    matches = SiftMatcher().match(feats, sift.run("other.pgm"))
"""

from .config import SiftConfig
from .describe import describe_keypoints, describe_rectangles
from .detector import HessianSift
from .features import FeatureTable, to_numpy_trimmed
from .matcher import SiftMatcher
from .parallel.batch import detect_batch
from .pyramid import (detect_and_describe, make_plan, run_pipeline,
                      run_pipeline_batched)

__all__ = [
    "SiftConfig", "FeatureTable", "to_numpy_trimmed", "detect_batch",
    "detect_and_describe", "make_plan", "run_pipeline",
    "run_pipeline_batched", "describe_keypoints", "describe_rectangles",
    "HessianSift", "SiftMatcher",
]
