"""Scale-space parameters for the Hessian/SIFT detector.

Re-derivation of the reference SiftParam math
(reference: src/SiftGPU/SiftGPU.cpp:466-563, SiftGPU.h:59-88). This is the
PyTorch package's own copy of hessgpu_tpu/params.py; the two must agree
(tests/test_torch_params_config.py holds them equal).

The reference has two "personalities":
  * Hessian (default): sigma0 = 1.6, level_min = 0, responses computed at
    every Gaussian level, keypoints detected at levels 1..s.
  * SIFT (DoG):        sigma0 = 1.6 * 2^(1/s), level_min = -1, DoG computed
    between adjacent levels, keypoints at interior DoG levels.

Everything here is plain Python: sigma schedules and tap vectors are host
constants handed to the kernels at launch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

# Filter width clamping (reference: ProgramCU.cu:42-43)
KERNEL_MAX_WIDTH = 33
KERNEL_MIN_WIDTH = 5


def gaussian_filter_width(sigma: float, filter_width_factor: float = 4.0) -> int:
    """Width of the 1-D Gaussian filter for a given sigma.

    Reference: ProgramCU::CreateFilterKernel (ProgramCU.cu:423-453):
    width = 2*ceil(factor*sigma - 0.5) + 1, clamped to [5, 33].
    """
    sz = int(math.ceil(filter_width_factor * sigma - 0.5))
    width = 2 * sz + 1
    if width > KERNEL_MAX_WIDTH:
        width = KERNEL_MAX_WIDTH
    elif width < KERNEL_MIN_WIDTH:
        width = KERNEL_MIN_WIDTH
    return width


def gaussian_taps(sigma: float, filter_width_factor: float = 4.0,
                  max_width: int = KERNEL_MAX_WIDTH) -> List[float]:
    """Normalized 1-D Gaussian taps, matching the reference construction.

    Reference: ProgramCU.cu:423-453. Computed in float64 here then normalized;
    the reference uses float32 accumulation but the difference is far below
    detection thresholds.
    """
    width = min(gaussian_filter_width(sigma, filter_width_factor), max_width)
    sz = width // 2
    rv = 1.0 / (sigma * sigma)
    taps = [math.exp(-0.5 * i * i * rv) for i in range(-sz, sz + 1)]
    ksum = sum(taps)
    return [t / ksum for t in taps]


@dataclasses.dataclass(frozen=True)
class ScaleSpaceParams:
    """Static scale-space schedule shared by every stage of the pipeline.

    Mirrors SiftParam (reference SiftGPU.h:59-88) with the bit-packing and
    GL-era bookkeeping dropped.
    """
    # Number of detection levels per octave ("s" / _dog_level_num).
    num_scales: int = 3
    # Base sigma of level 0 within an octave.
    sigma0: float = 1.6
    # Sigma assumed for the raw input image.
    sigma_n: float = 0.5
    # Detector personality: "hessian" (det-of-Hessian) or "dog".
    detector: str = "hessian"
    # Keypoint response threshold (reference: _dog_threshold, 0.02/s default).
    threshold: float = 0.02 / 3
    # Edge rejection threshold on the 2x2 response Hessian (reference: 10.0).
    edge_threshold: float = 10.0
    # Filter truncation factor (reference: _FilterWidthFactor = 4.0).
    filter_width_factor: float = 4.0

    # ---- derived level layout -------------------------------------------------
    @property
    def level_min(self) -> int:
        # Hessian: 0; DoG: -1 (reference SiftGPU.cpp:468-472)
        return 0 if self.detector == "hessian" else -1

    @property
    def level_max(self) -> int:
        return self.num_scales + 1  # reference SiftGPU.cpp:496-497

    @property
    def num_levels(self) -> int:
        """Number of Gaussian levels stored per octave."""
        return self.level_max - self.level_min + 1

    @property
    def level_ds(self) -> int:
        """Level used as the source for the next octave's downsample."""
        return min(self.level_min + self.num_scales, self.level_max)

    @property
    def sigmak(self) -> float:
        return 2.0 ** (1.0 / self.num_scales)

    @property
    def base_sigma(self) -> float:
        """sigma0 for this personality (reference SiftGPU.cpp:499-504)."""
        if self.detector == "hessian":
            return self.sigma0
        return self.sigma0 * self.sigmak

    def level_sigma(self, level: int) -> float:
        """Absolute sigma of a level within its octave.

        Reference: SiftParam::GetLevelSigma (SiftGPU.cpp:1422-1425).
        """
        return self.base_sigma * (2.0 ** (level / self.num_scales))

    # ---- blur schedule --------------------------------------------------------
    def initial_blur_sigma(self, octave_min: int) -> float:
        """Blur applied to the (possibly resampled) input to reach level_min.

        Reference: SiftParam::GetInitialSmoothSigma (SiftGPU.cpp:482-489).
        """
        sa = self.base_sigma * (2.0 ** (self.level_min / self.num_scales))
        sb = self.sigma_n / (2.0 ** octave_min)
        return math.sqrt(sa * sa - sb * sb) if sa > sb + 1e-3 else 0.0

    def incremental_sigmas(self) -> List[float]:
        """Per-level incremental blur: level i+1 = blur(level i, sigma[i]).

        Reference: SiftParam::ParseSiftParam (SiftGPU.cpp:515-556).
        Hessian variant: dsigma0 = sigma0*sqrt(sigmak^2-1),
        sigma[i] = dsigma0 * sigmak^i for i in 0..num_levels-2.
        """
        k = self.sigmak
        if self.detector == "hessian":
            dsigma0 = self.base_sigma * math.sqrt(k * k - 1.0)
            return [dsigma0 * (k ** i) for i in range(self.num_levels - 1)]
        dsigma0 = self.base_sigma * math.sqrt(1.0 - 1.0 / (k * k))
        lo = self.level_min + 1
        return [dsigma0 * (k ** (i + lo)) for i in range(self.num_levels - 1)]

    def octave_restart_sigma(self) -> float:
        """Extra blur after downsampling level_ds into the next octave's base.

        Reference: _sigma_skip1 (SiftGPU.cpp:526-529). Zero for the default
        Hessian layout (level_ds - num_scales == level_min).
        """
        k = self.sigmak
        sa = self.base_sigma * (k ** self.level_min)
        sb = self.base_sigma * (k ** (self.level_ds - self.num_scales))
        return math.sqrt(sa * sa - sb * sb) if sa > sb + 1e-3 else 0.0

    def direct_sigmas(self) -> List[float]:
        """Blur from the octave base straight to each level (parallel mode).

        Continuous-Gaussian equivalent of chaining incremental_sigmas();
        numerically close but not identical due to truncation. Level 0 maps
        to 0.0 (no blur).
        """
        s0 = self.level_sigma(self.level_min)
        out = [0.0]
        for lvl in range(self.level_min + 1, self.level_max + 1):
            sl = self.level_sigma(lvl)
            out.append(math.sqrt(max(sl * sl - s0 * s0, 0.0)))
        return out

    # ---- detection layout -----------------------------------------------------
    @property
    def key_levels(self) -> List[int]:
        """Gaussian/response level indices (0-based into the stored stack)
        where keypoints are detected.

        Hessian: responses exist for all levels; keys at stack indices
        1..num_scales (reference PyramidCU.cpp:1629-1652).
        """
        if self.detector == "hessian":
            return list(range(1, self.num_scales + 1))
        # DoG: stored DoG stack has num_levels-1 entries; keys at 1..s
        return list(range(1, self.num_scales + 1))

    def key_level_sigma(self, key_level: int) -> float:
        """Sigma assigned to keypoints detected at stack index key_level.

        Reference: PyramidCU::GetFeatureOrientations (PyramidCU.cpp:1829-1846):
        hessian: GetLevelSigma(level + level_min) with level in 1..s;
        DoG: GetLevelSigma(level + level_min + 1) with level in 0..s-1 —
        i.e. both personalities assign level_sigma(key_level + level_min)
        for our 1-based key_level. (DoG[l] = G(l) - G(l-1) carries Lowe
        index l-1, hence the seeming off-by-one.)
        """
        return self.level_sigma(key_level + self.level_min)

    def response_norm(self, key_level: int) -> float:
        """Normalization for the det-of-Hessian response at a key level.

        Reference: PyramidCU::DetectKeypointsEX (PyramidCU.cpp:1574-1590)
        passes levelSigma^2 (octave term deliberately commented out upstream);
        the kernel squares it again, so the response is det(H) * sigma^4.
        """
        s = self.level_sigma(key_level + self.level_min)
        return (s * s) ** 2


def required_octaves(min_dim: int, min_size: int = 16) -> int:
    """Number of octaves for an image whose smaller working dimension is
    min_dim.

    Reference: SiftPyramid::GetRequiredOctaveNum (SiftPyramid.cpp:305-311).
    """
    num = int(math.floor(math.log(min_dim * 2.0 / min_size) / math.log(2.0)))
    return max(num, 1)


def octave_shapes(height: int, width: int, num_octaves: int) -> List[Tuple[int, int]]:
    """Per-octave (H, W) shapes: floor-halved each octave."""
    shapes = []
    h, w = height, width
    for _ in range(num_octaves):
        shapes.append((h, w))
        h, w = h // 2, w // 2
    return shapes


def max_features_per_level(height: int, width: int,
                           max_percent: float = 0.005,
                           max_per_level: int = 4096) -> int:
    """Static per-level keypoint capacity.

    Reference policy: <= 0.5% of pixels and <= 4096 per level
    (GlobalUtil.cpp:67-68, PyramidCU.cpp:443-451). Rounded up to a multiple
    of 8, as the JAX package does, so both packages share one plan.
    """
    cap = int(height * width * max_percent)
    cap = max(32, min(cap, max_per_level))
    return (cap + 7) // 8 * 8
