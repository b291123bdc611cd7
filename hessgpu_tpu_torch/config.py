"""Runtime configuration for the PyTorch Hessian/SIFT pipeline.

Own copy of hessgpu_tpu/config.py without the two TPU-only switches
(canvas_bf16, use_pallas); convert.config_from_dict maps one onto the other.

One dataclass replaces the reference's two-tier flag system (compile-time
config.h personalities + ~60 GlobalParam statics set by the char-packed
ParseParam parser, reference SiftGPU.cpp:855-1380 / GlobalUtil.cpp:51-144).
`parse_args` keeps the reference CLI option names so existing hess/SiftGPU
invocations carry over.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from .params import ScaleSpaceParams

# Truncation methods (reference SiftPyramid.h:70-79 / -tc flags)
TRUNCATE_NONE = -1
TRUNCATE_KEEP_HIGHEST_LEVELS = 0   # -tc / -tc1: drop small-scale levels first
TRUNCATE_TOP_K = 1                 # -topk: global top-K by |response|
TRUNCATE_KEEP_LOWEST_LEVELS = 2    # -tc2: drop large-scale levels first
# -tc3 maps to method 0 in the reference parser as well.


@dataclasses.dataclass
class SiftConfig:
    """All runtime knobs. Defaults mirror GlobalUtil.cpp:51-144."""

    # ---- detector personality & scale space ----
    detector: str = "hessian"            # "hessian" | "dog"
    num_scales: int = 3                  # -d
    threshold: Optional[float] = None    # -t (default 0.02/num_scales)
    edge_threshold: float = 10.0         # -e
    first_octave: int = 0                # -fo (hessian restricts to >= 0)
    num_octaves: int = -1                # -no (-1 = auto)
    filter_width_factor: float = 4.0     # -f
    max_filter_width: int = -1           # -mfw (unused unless > 0)

    # ---- keypoint refinement / orientation / descriptor ----
    subpixel: bool = True                # -s (SubpixelLocalization)
    max_orientations: int = 2            # -m (1..4)
    fixed_orientation: bool = False      # -ofix
    orientation_window_factor: float = 2.0    # -w
    orientation_gaussian_factor: float = 1.5  # (fixed upstream)
    multi_orientation_threshold: float = 0.8
    descriptor_window_factor: float = 3.0     # -dw
    half_sift: bool = False              # -half
    compute_descriptors: bool = True     # -sd disables
    normalized_sift: bool = True         # -unn disables
    # -p WxH: size to prepare for at detector construction
    # (reference AllocatePyramid, SiftGPU.h:186)
    prealloc_size: Optional[tuple] = None
    # -tight: free per-size storage when the image size changes
    # (reference TightPyramid frees GPU pyramid storage, SiftGPU.h:188)
    tight_pyramid: bool = False
    mr_size: float = 3.0                 # vlfeat export measurement region

    # ---- capacity / truncation ----
    max_dim: int = 3200                  # -maxd working-dimension cap
    min_dim: int = 16                    # -mind
    max_feature_percent: float = 0.005
    max_level_features: int = 4096
    # Static capacity of the global (cross-level) feature table. The
    # expensive per-keypoint stages run over this compacted table, so work
    # scales with real feature counts, not per-level capacity. 2048 distinct
    # locations comfortably covers typical images (reference caps at 4096
    # per level but real images yield a few hundred); raise for dense
    # scenes or tiny thresholds.
    global_feature_cap: int = 2048
    # Expansion headroom for multi-orientation duplication (x global cap).
    expansion_factor: float = 1.5
    truncate_method: int = TRUNCATE_NONE
    feature_count_threshold: int = -1    # -tc*/-topk value

    # ---- coordinates / output ----
    lowe_origin: bool = False            # -loweo: (0,0) at top-left corner
    binary_sift: int = 0                 # 0 text, 1 -b, 2 -bvlf
    darkness_adaption: bool = False      # -da

    # ---- execution ----
    conv_mode: str = "chain"             # "chain" (reference parity) | "direct"
    dtype: str = "float32"
    verbose: int = 1                     # -v
    # Reference failure semantics (_siftgpu_failed): a failed run sets
    # HessianSift.failed/last_error and returns no features instead of
    # raising. (The server backend has its own equivalent per-command
    # catch, server_backend.py.)
    fail_soft: bool = False

    def scale_params(self) -> ScaleSpaceParams:
        thr = self.threshold if self.threshold is not None else 0.02 / self.num_scales
        return ScaleSpaceParams(
            num_scales=self.num_scales,
            detector=self.detector,
            threshold=thr,
            edge_threshold=self.edge_threshold,
            filter_width_factor=self.filter_width_factor,
        )

    @property
    def descriptor_dim(self) -> int:
        return 64 if self.half_sift else 128

    # ------------------------------------------------------------------
    @classmethod
    def parse_args(cls, argv: List[str]) -> "SiftConfig":
        """Parse reference-compatible CLI options (SiftGPU.cpp:789-1380).

        Unknown or GL/CUDA-only options (-cuda, -glsl, -pack, -lc, ...) are
        accepted and ignored so existing scripts keep working.
        """
        cfg = cls()
        i = 0
        n = len(argv)

        def val() -> str:
            nonlocal i
            i += 1
            if i >= n:
                raise ValueError(f"option {argv[i-1]} expects a value")
            return argv[i]

        while i < n:
            opt = argv[i]
            if opt == "-t":
                cfg.threshold = float(val())
            elif opt == "-e":
                cfg.edge_threshold = float(val())
            elif opt == "-d":
                cfg.num_scales = int(val())
            elif opt == "-fo":
                # hessian restricts to >= 0 (SiftGPU.cpp:1166-1170); clamp
                # happens at pipeline time since -d may switch personality
                cfg.first_octave = int(val())
            elif opt == "-no":
                cfg.num_octaves = int(val())
            elif opt == "-f":
                cfg.filter_width_factor = float(val())
            elif opt == "-w":
                cfg.orientation_window_factor = float(val())
            elif opt == "-dw":
                cfg.descriptor_window_factor = float(val())
            elif opt == "-m":
                # like -s, the numeric argument is optional: bare -m means
                # 2 orientations (SiftGPU.cpp:934-940 "-m <int=2>")
                if i + 1 < n and not argv[i + 1].startswith("-"):
                    cfg.max_orientations = max(1, min(4, int(val())))
                else:
                    cfg.max_orientations = 2
            elif opt == "-m2p":
                cfg.max_orientations = 2
            elif opt == "-s":
                # reference: -s takes an optional numeric argument
                if i + 1 < n and not argv[i + 1].startswith("-"):
                    cfg.subpixel = bool(int(val()))
                else:
                    cfg.subpixel = True
            elif opt == "-ofix":
                cfg.fixed_orientation = True
            elif opt == "-ofix-not":
                cfg.fixed_orientation = False
            elif opt == "-loweo":
                cfg.lowe_origin = True
            elif opt == "-maxd":
                cfg.max_dim = int(val())
            elif opt == "-mind":
                cfg.min_dim = max(8, int(val()))
            elif opt == "-b":
                cfg.binary_sift = 1
            elif opt == "-bvlf":
                cfg.binary_sift = 2
            elif opt == "-half":
                cfg.half_sift = True
            elif opt == "-sd":
                cfg.compute_descriptors = False
            elif opt == "-unn":
                cfg.normalized_sift = False
            elif opt in ("-tc", "-tc1", "-tc3"):
                cfg.truncate_method = TRUNCATE_KEEP_HIGHEST_LEVELS
                cfg.feature_count_threshold = int(val())
            elif opt == "-tc2":
                cfg.truncate_method = TRUNCATE_KEEP_LOWEST_LEVELS
                cfg.feature_count_threshold = int(val())
            elif opt == "-topk":
                cfg.truncate_method = TRUNCATE_TOP_K
                cfg.feature_count_threshold = int(val())
            elif opt == "-v":
                cfg.verbose = int(val())
            elif opt == "-da":
                cfg.darkness_adaption = True
            elif opt in ("-dog", "-sift"):
                # reference picks the personality at build time
                # (config.h GPU_HESSIAN); here it's a runtime switch
                cfg.detector = "dog"
            elif opt == "-hessian":
                cfg.detector = "hessian"
            elif opt == "-p":
                # "-p WxH" (SiftGPU.h:186 AllocatePyramid)
                try:
                    w_, h_ = str(val()).lower().split("x")
                    cfg.prealloc_size = (int(h_), int(w_))
                except (ValueError, AttributeError):
                    pass
            elif opt == "-tight":
                cfg.tight_pyramid = True
            elif opt in ("-cuda", "-winpos", "-display", "-device"):
                val()  # accepted, ignored (GL/CUDA-era)
            elif opt in ("-glsl", "-pack", "-unpack", "-lc", "-lcpu", "-lgpu",
                         "-noprep", "-exit", "-nomc", "-fmc",
                         "-ads", "-k0", "-kx", "-di", "-ofast", "-debug"):
                pass  # accepted, ignored
            else:
                pass  # unknown options ignored, like the reference parser
            i += 1
        return cfg
