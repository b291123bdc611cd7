"""HessianSift: the public detector facade (counterpart of
hessgpu_tpu/detector.py).

Equivalent of the SiftGPU class (reference SiftGPU.{h,cpp}): image/list
management, RunSIFT overloads, and result accessors - minus the GL context
machinery. It runs on the card unless it is asked for the CPU
(device="cpu"); device="cuda" without a card raises.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from .config import SiftConfig
from .features import FeatureTable, keypoint_buffer, to_numpy_trimmed
from .io_image import limit_working_size, load_image
from .pyramid import (detect_and_describe, prepare_input, resolve_device,
                      run_pipeline, run_pipeline_jit)
from .utils.graphs import graphs_enabled
from .utils.timing import (StageTimer, device_stage_breakdown,
                           replay_stage_breakdown)


class HessianSift:
    """Detect Hessian keypoints and compute SIFT descriptors.

    Usage (mirrors SiftGPU::RunSIFT, reference SiftGPU.cpp:317-415):
        sift = HessianSift(SiftConfig())          # device="cpu" to ask for it
        feats = sift.run("img.pgm")     # or sift.run(np_array)
        n = feats["x"].shape[0]
    """

    def __init__(self, config: Optional[SiftConfig] = None, device="cuda"):
        self.config = config or SiftConfig()
        self.device = resolve_device(device)
        self.timer = StageTimer()
        self._last_table: Optional[FeatureTable] = None
        self._last_feats: Optional[dict] = None
        self._image_list: List[str] = []
        self._image_index = 0
        self._pending_keys = None
        # reference per-run failure status (_siftgpu_failed,
        # SiftGPU.cpp RunSIFT returns 0 and the app keeps going)
        self.failed = False
        self.last_error: Optional[str] = None
        self._last_shape: Optional[tuple] = None
        if self.config.prealloc_size is not None:
            # -p WxH: build the kernels and run this size now
            # (AllocatePyramid analogue)
            self.allocate_pyramid(self.config.prealloc_size[1],
                                  self.config.prealloc_size[0])

    # -- image list management (reference SiftGPU.cpp:229-305) -------------
    def set_image_list(self, paths: List[str]) -> None:
        self._image_list = list(paths)
        self._image_index = 0

    def run_next(self) -> Optional[dict]:
        """RunSIFT() on the next image of the list; None when exhausted."""
        if self._image_index >= len(self._image_list):
            return None
        path = self._image_list[self._image_index]
        self._image_index += 1
        return self.run(path)

    # -- main entry --------------------------------------------------------
    def run(self, image: Union[str, np.ndarray]) -> dict:
        """Full detect + describe. Returns a dict with keys
        x, y, sigma, theta, response, level, ftype (arrays of shape (N,))
        and desc ((N, 128) float descriptors).

        Failure semantics follow the reference: RunSIFT sets a per-run
        failure flag and returns "no features" rather than tearing the
        process down (SiftGPU.cpp `_siftgpu_failed`). With
        cfg.fail_soft=True, errors set `self.failed` / `self.last_error`
        and an empty result is returned; otherwise they raise.
        """
        self.failed = False
        self.last_error = None
        if self.config.fail_soft:
            try:
                return self._run(image)
            except Exception as e:  # noqa: BLE001 - mirrors reference
                self.failed = True
                self.last_error = f"{type(e).__name__}: {e}"
                empty = {k: np.zeros((0,), np.float32)
                         for k in ("x", "y", "sigma", "theta", "response")}
                empty["level"] = np.zeros((0,), np.int32)
                empty["ftype"] = np.zeros((0,), np.int32)
                empty["desc"] = np.zeros((0, self.config.descriptor_dim),
                                         np.float32)
                self._last_feats = empty
                return empty
        return self._run(image)

    def _load(self, image) -> tuple:
        """(image, log2 of the -maxd downsampling) of a path or an array."""
        img = load_image(image) if isinstance(image, str) else image
        return limit_working_size(img, self.config.max_dim)

    def _run(self, image: Union[str, np.ndarray]) -> dict:
        with self.timer.stage("load"):
            img, ds = self._load(image)
            self._last_image = img  # kept for keypoint-list re-entry

        if self.config.tight_pyramid:
            # -tight (SiftGPU.h:188): free the storage of the old size when
            # the working size changes: the captured pipeline graphs with
            # their memory pools and the per-plan constants (as the JAX
            # package frees its compiled executables and their buffers), and
            # the caching allocator's free blocks.
            shp = img.shape[:2]
            if self._last_shape is not None and shp != self._last_shape:
                run_pipeline_jit.clear_cache()
            self._last_shape = shp

        with self.timer.stage("pipeline", fence=self.device):
            table, aux = detect_and_describe(img, self.config, self.device)

        with self.timer.stage("download"):
            feats = to_numpy_trimmed(table)
            if ds > 0:
                scale = float(1 << ds)
                off = 0.0 if self.config.lowe_origin else 0.5
                feats["x"] = scale * (feats["x"] - off) + off
                feats["y"] = scale * (feats["y"] - off) + off
                feats["sigma"] = scale * feats["sigma"]

        self._report_verbose(feats, aux)
        self._last_table = table
        self._last_feats = feats
        return feats

    def _report_verbose(self, feats: dict, aux: dict) -> None:
        """Reference-style observability: per-(octave, level) feature
        counts at -v >= 2 (PyramidCU.cpp:1327-1343) and the
        feature-reduction report when truncation dropped keypoints
        (SiftPyramid.cpp:219-247)."""
        v = self.config.verbose
        if v < 2:
            return
        counts = aux["level_counts"].cpu().numpy()
        s = len(self.config.scale_params().key_levels)
        for i, c in enumerate(counts.tolist()):
            o, kl = divmod(i, s)
            print(f"#  octave {o} level {kl + 1}: {c} features")
        pre = int(aux["pre_count"])
        post = int(feats["x"].shape[0])
        if post < pre:
            print(f"#Features Reduced: {pre} -> {post}")

    # -- accessors (reference GetFeatureNum/GetFeatureVector) --------------
    @property
    def feature_num(self) -> int:
        return 0 if self._last_feats is None else int(self._last_feats["x"].shape[0])

    def get_feature_vector(self):
        """Returns (keypoints (N,6) float32, descriptors (N,128) float32) in
        the reference SiftKeypoint ABI order."""
        if self._last_feats is None:
            return np.zeros((0, 6), np.float32), np.zeros((0, 128), np.float32)
        return keypoint_buffer(self._last_feats), self._last_feats["desc"]

    def save_sift(self, path: str) -> None:
        from .formats import save_sift
        if self._last_feats is not None:
            save_sift(path, self._last_feats, self.config)

    # -- keypoint-list re-entry (reference RunSIFT(num, keys, ...)) --------
    def run_with_keypoints(self, image, keys: np.ndarray,
                           has_orientation: bool = True) -> dict:
        """Describe externally supplied keypoints (SiftGPU::RunSIFT(num,
        keys, has_orientation), reference SiftGPU.cpp:307-315).

        keys: (N, >=3) columns x, y, sigma[, theta[, response, packed]].
        Caller-provided response and (u16-packed) level/type columns are
        carried through to the output buffer, like the reference, which
        keeps the host SiftKeypoint array the caller uploaded
        (SiftPyramid::SetKeypointList, SiftPyramid.cpp:313-355)."""
        from .describe import describe_keypoints
        img, _ = self._load(image)
        self._last_image = img
        keys = np.asarray(keys, np.float32)
        out = describe_keypoints(img, keys, self.config,
                                 has_orientation=has_orientation,
                                 device=self.device)
        n = len(out["x"])
        response = keys[:, 4].copy() if keys.shape[1] > 4 \
            else np.zeros(n, np.float32)
        if keys.shape[1] > 5:
            packed = np.ascontiguousarray(keys[:, 5]).view(np.uint32)
            level = (packed & 0xFFFF).astype(np.int32)
            ftype = (packed >> 16).astype(np.int32)
        else:
            level = np.zeros(n, np.int32)
            ftype = np.zeros(n, np.int32)
        feats = {
            "x": out["x"], "y": out["y"], "sigma": out["sigma"],
            "theta": out["theta"],
            "response": response,
            "level": level,
            "ftype": ftype,
            "desc": out["desc"],
        }
        self._last_feats = feats
        return feats

    def set_keypoint_list(self, keys: np.ndarray,
                          has_orientation: bool = True) -> None:
        """Stash a keypoint list; the next run_current() describes it
        (reference SetKeypointList + RunSIFT(), SiftPyramid.cpp:313-355)."""
        self._pending_keys = (np.asarray(keys, np.float32), has_orientation)

    def run_on_current(self) -> dict:
        """Describe the stashed keypoint list on the last-loaded image."""
        keys, has_o = self._pending_keys
        return self.run_with_keypoints(self._last_image, keys, has_o)

    def run_current(self) -> dict:
        """Re-run on the current image (reference SiftGPU::RunSIFT() with no
        arguments, ServerSiftGPU.cpp:334-346): consumes a pending keypoint
        list if one was set, else repeats full detection."""
        if self._pending_keys is not None:
            feats = self.run_on_current()
            self._pending_keys = None
            return feats
        return self.run(self._last_image)

    # -- reference API parity ----------------------------------------------
    def parse_param(self, args) -> None:
        """Reconfigure with reference-style CLI options (SiftGPU::ParseParam)."""
        if isinstance(args, str):
            args = args.split()
        self.config = type(self.config).parse_args(list(args))

    def allocate_pyramid(self, width: int, height: int) -> None:
        """Prepare for an image size: one run on zeros of that size, which
        builds the kernels (at the first launch of the process) and leaves
        the caching allocator holding that size's buffers (reference
        SiftGPU::AllocatePyramid)."""
        self.run(np.zeros((height, width), np.float32))
        self._last_feats = None
        self._last_table = None

    def set_max_dimension(self, maxd: int) -> None:
        self.config.max_dim = maxd

    def device_stage_report(self, image) -> "OrderedDict":
        """Per-stage milliseconds with the reference TIMINGS_* bucket names
        (config.h:17-31) of the pipeline run() runs. On the card, the device
        time of each stage of the replayed graph (run_pipeline_jit), read
        from the timed events that its graph captured with tracing on holds
        (utils.timing.replay_stage_breakdown); inside disable_graphs(), of
        the eager route, from a profiler trace. On the CPU each stage's CPU
        time under the profiler (utils.timing.device_stage_breakdown)."""
        img, _ = self._load(image)
        arr, plan, cfg = prepare_input(img, self.config, self.device)
        if arr.is_cuda and graphs_enabled():
            return replay_stage_breakdown(run_pipeline_jit, arr, plan, cfg)
        return device_stage_breakdown(run_pipeline, arr, plan, cfg,
                                      device=self.device)
