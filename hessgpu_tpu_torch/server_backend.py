"""Python backend of the port's feature server (counterpart of
hessgpu_tpu/server_backend.py; the server is hessgpu_tpu_torch/csrc/
hess_server.cpp).

The C++ server owns the process, the sockets and the reference-compatible
command protocol (ServerSiftGPU.cpp:239-530); it calls into this module for
the compute, which runs on the card unless the server was started with
-device cpu.

All buffers cross the boundary as bytes in the reference wire layout:
  * keypoints: N x SiftKeypoint = N x 6 float32 (x, y, s, o, response,
    level:u16|type:u16) - SiftGPU.h:108-122.
  * descriptors: N x 128 float32.

Every run method answers 0 when it fails, as the reference protocol does,
and prints the traceback to stderr: a kernel that fails to build or to
launch is reported there and never replaced by the CPU or the plain
versions.
"""

from __future__ import annotations

import sys
import traceback

import numpy as np
import torch

from .config import SiftConfig
from .describe import describe_keypoints
from .detector import HessianSift
from .features import keypoint_buffer
from .formats import save_sift
from .matcher import SiftMatcher

GL_RGB, GL_RGBA = 0x1907, 0x1908
GL_FLOAT = 0x1406


def _report(method: str) -> int:
    """Print the exception being handled and answer the protocol's 0."""
    print(f"hess_server: {method} failed:", file=sys.stderr)
    traceback.print_exc(file=sys.stderr)
    sys.stderr.flush()
    return 0


def prepare(device: str = "cuda") -> None:
    """Called once by the server on its main thread before it accepts a
    connection: on the card, initialise CUDA and load (building it if need
    be) the kernel library, so that no connection thread is the first to
    touch either. Without a card nothing is done: initialize() answers 0."""
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        from .ops.cuda import build
        torch.cuda.init()
        build.lib()


class ServerBackend:
    """One instance per client connection. device="cuda" (the default)
    without a card builds nothing: initialize() answers 0 and every run
    answers 0."""

    def __init__(self, params: str = "", device: str = "cuda"):
        self.device = torch.device(device)
        self.config = SiftConfig.parse_args(params.split())
        self._sift = None
        self._matcher = None
        self._feats = None
        self._pending_keys = None

    @property
    def sift(self) -> HessianSift:
        if self._sift is None:
            self._sift = HessianSift(self.config, device=self.device)
        return self._sift

    @property
    def matcher(self) -> SiftMatcher:
        if self._matcher is None:
            self._matcher = SiftMatcher(device=self.device)
        return self._matcher

    # ---- detector commands ------------------------------------------------
    def initialize(self) -> int:
        return int(self.device.type != "cuda" or torch.cuda.is_available())

    def parse_param(self, params: str) -> None:
        self.config = SiftConfig.parse_args(params.split())
        self._sift = None

    def run_sift_file(self, path: str) -> int:
        try:
            self._feats = self.sift.run(path)
            return 1
        except Exception:
            self._feats = None
            return _report("run_sift_file")

    def run_sift_data(self, width: int, height: int, data: bytes,
                      gl_format: int, gl_type: int) -> int:
        """COMMAND_RUNSIFT_DATA: raw pixel buffer. gl_format/gl_type follow
        the reference GL enums: luminance u8/f32 and RGB(A) u8."""
        try:
            arr = np.frombuffer(
                data, np.float32 if gl_type == GL_FLOAT else np.uint8)
            if gl_format == GL_RGB:
                arr = arr.reshape(height, width, 3)
            elif gl_format == GL_RGBA:
                arr = arr.reshape(height, width, 4)[..., :3]
            else:
                arr = arr.reshape(height, width)
            self._feats = self.sift.run(arr)
            return 1
        except Exception:
            self._feats = None
            return _report("run_sift_data")

    def _describe_key_buffer(self, buf: np.ndarray,
                             has_orientation: bool) -> int:
        """Describe a (N, 6) SiftKeypoint wire buffer on the last image."""
        try:
            img = getattr(self.sift, "_last_image", None)
            if img is None:
                raise RuntimeError("no image loaded for keypoint description")
            cols = buf[:, :4] if has_orientation else buf[:, :3]
            out = describe_keypoints(img, cols, self.config,
                                     has_orientation=has_orientation,
                                     device=self.device)
            packed = buf[:, 5].view(np.uint32)
            self._feats = {
                "x": out["x"], "y": out["y"], "sigma": out["sigma"],
                "theta": out["theta"],
                "response": buf[:, 4].copy(),
                "level": (packed & 0xFFFF).astype(np.int32),
                "ftype": (packed >> 16).astype(np.int32),
                "desc": out["desc"],
            }
            return 1
        except Exception:
            return _report("describe keypoints")

    def run_sift_keys(self, keys: bytes, num: int,
                      has_orientation: int) -> int:
        """COMMAND_RUNSIFT_KEY: describe externally supplied keypoints."""
        buf = np.frombuffer(keys, np.float32).reshape(num, 6).copy()
        return self._describe_key_buffer(buf, bool(has_orientation))

    def set_keypoint_list(self, keys: bytes, num: int,
                          has_orientation: int) -> None:
        """COMMAND_SET_KEYPOINT: stash a keypoint list for the next
        COMMAND_RUNSIFT (reference ServerSiftGPU.cpp:362-377)."""
        buf = np.frombuffer(keys, np.float32).reshape(num, 6).copy()
        self._pending_keys = (buf, bool(has_orientation))

    def run_sift_current(self) -> int:
        """COMMAND_RUNSIFT: re-run on the current image (reference
        ServerSiftGPU.cpp:334-346). Consumes a pending keypoint list from
        COMMAND_SET_KEYPOINT if present, else repeats full detection."""
        if self._pending_keys is not None:
            buf, has_o = self._pending_keys
            self._pending_keys = None
            return self._describe_key_buffer(buf, has_o)
        try:
            self._feats = self.sift.run(self.sift._last_image)
            return 1
        except Exception:
            self._feats = None
            return _report("run_sift_current")

    def feature_count(self) -> int:
        return 0 if self._feats is None else int(self._feats["x"].shape[0])

    def get_key_vector(self) -> bytes:
        if self._feats is None:
            return b""
        return keypoint_buffer(self._feats).tobytes()

    def get_des_vector(self) -> bytes:
        if self._feats is None:
            return b""
        return np.ascontiguousarray(self._feats["desc"],
                                    np.float32).tobytes()

    def save_sift(self, path: str) -> None:
        if self._feats is not None:
            save_sift(path, self._feats, self.config)

    def set_max_dimension(self, maxd: int) -> None:
        self.config.max_dim = maxd

    # ---- matcher commands -------------------------------------------------
    def match_set_descriptors_float(self, index: int, num: int,
                                    data: bytes) -> None:
        d = np.frombuffer(data, np.float32).reshape(num, 128)
        self.matcher.set_descriptors(index, d)

    def match_set_descriptors_byte(self, index: int, num: int,
                                   data: bytes) -> None:
        d = np.frombuffer(data, np.uint8).reshape(num, 128)
        self.matcher.set_descriptors(index, d)

    def match_get_match(self, max_match: int, distmax: float,
                        ratiomax: float, mbm: int) -> bytes:
        m = self.matcher.get_sift_match(distmax=distmax, ratiomax=ratiomax,
                                        mutual_best=bool(mbm))
        return np.ascontiguousarray(m[:max_match], np.int32).tobytes()

    def match_set_maxsift(self, n: int) -> None:
        self.matcher.max_sift = n
