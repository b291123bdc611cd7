"""RemoteSift: client for the port's feature server (own copy of
hessgpu_tpu/parallel/client.py; numpy and sockets only).

Python counterpart of the reference's ServerSiftGPU client class
(ServerSiftGPU.{h,cpp}): the same ComboSiftGPU-style API, every call
serialized over TCP with the reference's command IDs and framing. Can spawn
a local server process (like CreateRemoteSiftGPU with a NULL host,
ServerSiftGPU.cpp:156-194) or connect to a remote one. A spawned server is
the port's hess_server (hessgpu_tpu_torch/csrc/hess_server.cpp), built at
first use by hessgpu_tpu_torch.server_build; spawn_args=["-device", "cpu"]
runs it on the CPU (the default is the card).
"""

from __future__ import annotations

import os
import socket
import struct
import subprocess
import time
from typing import List, Optional, Tuple

import numpy as np

# command IDs (reference ServerSiftGPU.h:47-77)
COMMAND_EXIT = 1
COMMAND_DISCONNECT = 2
COMMAND_INITIALIZE = 3
COMMAND_ALLOCATE_PYRAMID = 4
COMMAND_RUNSIFT = 5
COMMAND_RUNSIFT_FILE = 6
COMMAND_RUNSIFT_KEY = 7
COMMAND_RUNSIFT_DATA = 8
COMMAND_SAVE_SIFT = 9
COMMAND_SET_MAX_DIMENSION = 10
COMMAND_SET_KEYPOINT = 11
COMMAND_GET_FEATURE_COUNT = 12
COMMAND_SET_TIGHTPYRAMID = 13
COMMAND_GET_KEY_VECTOR = 14
COMMAND_GET_DES_VECTOR = 15
COMMAND_PARSE_PARAM = 16
COMMAND_MATCH_INITIALIZE = 17
COMMAND_MATCH_SET_LANGUAGE = 18
COMMAND_MATCH_SET_DES_FLOAT = 19
COMMAND_MATCH_SET_DES_BYTE = 20
COMMAND_MATCH_SET_MAXSIFT = 21
COMMAND_MATCH_GET_MATCH = 22

GL_LUMINANCE = 0x1909
GL_RGB = 0x1907
GL_UNSIGNED_BYTE = 0x1401
GL_FLOAT = 0x1406


class RemoteSift:
    """Remote detector+matcher over the native server."""

    def __init__(self, host: Optional[str] = None, port: int = 7777,
                 spawn_args: Optional[List[str]] = None,
                 server_binary: Optional[str] = None,
                 env: Optional[dict] = None):
        self._proc = None
        if host is None:
            if server_binary is None:
                from ..server_build import build
                server_binary = str(build())
            cmd = [server_binary, "-server", str(port)] + (spawn_args or [])
            self._proc = subprocess.Popen(cmd, env=env)
            host = "127.0.0.1"
            self._wait_for_server(host, port)
        # sanitizer-instrumented servers can spend >10 min in one compile;
        # HESS_CLIENT_TIMEOUT (seconds) widens the per-recv deadline
        self.sock = socket.create_connection(
            (host, port),
            timeout=float(os.environ.get("HESS_CLIENT_TIMEOUT", 600)))
        self._feature_count = 0

    def _wait_for_server(self, host, port, timeout=60.0):
        t0 = time.time()
        while time.time() - t0 < timeout:
            try:
                s = socket.create_connection((host, port), timeout=1)
                s.close()
                return
            except OSError:
                if self._proc and self._proc.poll() is not None:
                    raise RuntimeError("server process exited early")
                time.sleep(0.2)
        raise TimeoutError("feature server did not come up")

    # ---- framing ----------------------------------------------------------
    def _wi(self, *values):
        self.sock.sendall(struct.pack(f"<{len(values)}i", *values))

    def _wf(self, *values):
        self.sock.sendall(struct.pack(f"<{len(values)}f", *values))

    def _wline(self, text: str):
        self.sock.sendall(text.encode() + b"\n")

    def _wdata(self, data: bytes):
        self.sock.sendall(data)

    def _ri(self) -> int:
        return struct.unpack("<i", self._rdata(4))[0]

    def _rdata(self, count: int) -> bytes:
        chunks = []
        got = 0
        while got < count:
            c = self.sock.recv(count - got)
            if not c:
                raise ConnectionError("server closed connection")
            chunks.append(c)
            got += len(c)
        return b"".join(chunks)

    # ---- detector API -----------------------------------------------------
    def initialize(self) -> bool:
        self._wi(COMMAND_INITIALIZE)
        return self._ri() == 1

    def parse_param(self, params: str) -> None:
        self._wi(COMMAND_PARSE_PARAM)
        self._wline(params)

    def run_sift(self, path: str) -> bool:
        self._wi(COMMAND_RUNSIFT_FILE)
        self._wline(path)
        ok = self._ri() == 1
        self._feature_count = self.get_feature_count()
        return ok

    def run_sift_data(self, image: np.ndarray) -> bool:
        img = np.asarray(image)
        if img.ndim == 3:
            gl_format = GL_RGB
            img = np.ascontiguousarray(img[..., :3], np.uint8)
            gl_type = GL_UNSIGNED_BYTE
        elif img.dtype == np.uint8:
            gl_format, gl_type = GL_LUMINANCE, GL_UNSIGNED_BYTE
        else:
            gl_format, gl_type = GL_LUMINANCE, GL_FLOAT
            img = np.ascontiguousarray(img, np.float32)
        data = img.tobytes()
        h, w = img.shape[:2]
        self._wi(COMMAND_RUNSIFT_DATA)
        self._wi(w, h, gl_format, gl_type)
        self._wi(len(data))
        self._wdata(data)
        ok = self._ri() == 1
        self._feature_count = self.get_feature_count()
        return ok

    def run_sift_keys(self, keys: np.ndarray,
                      has_orientation: bool = True) -> bool:
        """COMMAND_RUNSIFT_KEY: describe externally supplied keypoints on
        the last-loaded image. keys: (N, >=3) x, y, sigma[, theta]; padded
        to the SiftKeypoint 6-float wire layout."""
        keys = np.asarray(keys, np.float32)
        n = keys.shape[0]
        buf = np.zeros((n, 6), np.float32)
        buf[:, :min(4, keys.shape[1])] = keys[:, :4]
        self._wi(COMMAND_RUNSIFT_KEY)
        self._wi(n, 1 if has_orientation else 0)
        self._wdata(buf.tobytes())
        ok = self._ri() == 1
        self._feature_count = self.get_feature_count()
        return ok

    def run_sift_current(self) -> bool:
        """COMMAND_RUNSIFT: re-run on the server's current image, consuming
        any keypoint list set with set_keypoint_list (reference
        ServerSiftGPU::RunSIFT(), ServerSiftGPU.cpp:785-792)."""
        self._wi(COMMAND_RUNSIFT)
        ok = self._ri() == 1
        self._feature_count = self.get_feature_count()
        return ok

    def set_keypoint_list(self, keys: np.ndarray,
                          has_orientation: bool = True) -> None:
        """COMMAND_SET_KEYPOINT: upload a keypoint list for the next
        run_sift_current (reference ServerSiftGPU::SetKeypointList,
        ServerSiftGPU.cpp:675-683). No server reply."""
        keys = np.asarray(keys, np.float32)
        n = keys.shape[0]
        buf = np.zeros((n, 6), np.float32)
        buf[:, :min(6, keys.shape[1])] = keys[:, :6]
        self._wi(COMMAND_SET_KEYPOINT)
        self._wi(n, 1 if has_orientation else 0)
        self._wdata(buf.tobytes())

    def get_feature_count(self) -> int:
        self._wi(COMMAND_GET_FEATURE_COUNT)
        return self._ri()

    def get_feature_vector(self) -> Tuple[np.ndarray, np.ndarray]:
        n = self._feature_count
        if n == 0:
            return (np.zeros((0, 6), np.float32),
                    np.zeros((0, 128), np.float32))
        self._wi(COMMAND_GET_KEY_VECTOR)
        keys = np.frombuffer(self._rdata(n * 6 * 4), np.float32).reshape(n, 6)
        self._wi(COMMAND_GET_DES_VECTOR)
        des = np.frombuffer(self._rdata(n * 128 * 4),
                            np.float32).reshape(n, 128)
        return keys.copy(), des.copy()

    def save_sift(self, path: str) -> None:
        self._wi(COMMAND_SAVE_SIFT)
        self._wline(path)

    def set_max_dimension(self, maxd: int) -> None:
        """Reference ServerSiftGPU::SetMaxDimension (no reply)."""
        self._wi(COMMAND_SET_MAX_DIMENSION, int(maxd))

    def set_tight_pyramid(self, tight: int = 1) -> None:
        """Reference ServerSiftGPU::SetTightPyramid (accepted and ignored by
        the server, no reply)."""
        self._wi(COMMAND_SET_TIGHTPYRAMID, int(tight))

    # ---- matcher API ------------------------------------------------------
    def match_set_descriptors(self, index: int, desc: np.ndarray) -> None:
        if desc.dtype == np.uint8:
            self._wi(COMMAND_MATCH_SET_DES_BYTE)
            self._wi(index, desc.shape[0], -1)
            self._wdata(np.ascontiguousarray(desc).tobytes())
        else:
            self._wi(COMMAND_MATCH_SET_DES_FLOAT)
            self._wi(index, desc.shape[0], -1)
            self._wdata(np.ascontiguousarray(desc, np.float32).tobytes())

    def match(self, max_match: int = 4096, distmax: float = 0.7,
              ratiomax: float = 0.8, mutual_best: bool = True) -> np.ndarray:
        self._wi(COMMAND_MATCH_GET_MATCH)
        self._wi(max_match, 1 if mutual_best else 0)
        self._wf(distmax, ratiomax)
        n = self._ri()
        if n <= 0:
            return np.zeros((0, 2), np.int32)
        return np.frombuffer(self._rdata(n * 8), np.int32).reshape(n, 2).copy()

    # ---- lifecycle --------------------------------------------------------
    def close(self, shutdown_server: bool = False):
        try:
            self._wi(COMMAND_EXIT if shutdown_server else COMMAND_DISCONNECT)
        except OSError:
            pass
        self.sock.close()
        if self._proc is not None:
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(shutdown_server=self._proc is not None)
