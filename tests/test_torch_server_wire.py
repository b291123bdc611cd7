"""The port's feature server binary (hessgpu_tpu_torch/csrc/hess_server.cpp),
built here into a temporary directory, on the CPU over loopback: driven by
the port's RemoteSift and by the JAX package's (numpy and sockets only, so
the wire protocol is the JAX package's), its replies against an in-process
HessianSift(device="cpu") and SiftMatcher: the keypoint bytes equal, the
descriptors within WIRE_DESC_TOL, the matches equal. Its -test self-test
on seeded frames, and -device cuda without a card.
"""

import os
import shutil
import socket
import subprocess
import sys
import sysconfig

import numpy as np
import pytest
import torch

from hessgpu_tpu.parallel.client import RemoteSift as JaxRemoteSift
from hessgpu_tpu_torch import HessianSift, SiftConfig, SiftMatcher
from hessgpu_tpu_torch import server_build
from hessgpu_tpu_torch.features import keypoint_buffer
from hessgpu_tpu_torch.parallel.client import RemoteSift

from test_torch_server import SHAPE, frames  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Descriptors of one frame from two CPU processes: PyTorch's CPU products
# take their summation order from process-wide library state, so a server
# process and this one (which has imported jax) part by up to 8.2e-6 on an
# 8-core x86 host; keypoints stay bit-equal. In one process, and on the
# card (chip_smoke.py's server phase), they are bit-equal.
WIRE_DESC_TOL = 2e-5


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    # one torch thread in the server, as in this process (one_torch_thread)
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO
                + os.pathsep + os.environ.get("PYTHONPATH", ""))


@pytest.fixture(scope="module")
def server_bin(tmp_path_factory):
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler to build the feature server")
    if not os.path.exists(os.path.join(sysconfig.get_config_var("INCLUDEPY"),
                                       "Python.h")):
        pytest.skip("no Python.h to build the feature server")
    return str(server_build.build(tmp_path_factory.mktemp("hess_server")))


@pytest.fixture(scope="module")
def server(server_bin):
    """The port's server on the CPU, spawned by the port's client."""
    r = RemoteSift(port=_free_port(), server_binary=server_bin,
                   spawn_args=["-device", "cpu"], env=_env())
    yield r
    r.close(shutdown_server=True)


@pytest.fixture(scope="module")
def in_process(frames, tmp_path_factory):
    """HessianSift(device="cpu") on frame 0, as an array and as a PGM."""
    path = str(tmp_path_factory.mktemp("pgm") / "f0.pgm")
    with open(path, "wb") as f:
        f.write(f"P5\n{SHAPE[1]} {SHAPE[0]}\n255\n".encode())
        f.write(frames[0].tobytes())
    sift = HessianSift(SiftConfig(), device="cpu")
    feats = sift.run(frames[0])
    return path, sift, feats


def _same_bytes(client, feats):
    """The keypoint buffer bit for bit; descriptors within WIRE_DESC_TOL."""
    kp, desc = client.get_feature_vector()
    assert kp.tobytes() == keypoint_buffer(feats).tobytes()
    assert desc.shape == feats["desc"].shape
    assert np.abs(desc - feats["desc"]).max() <= WIRE_DESC_TOL
    return kp


@pytest.mark.parametrize("client", ["port", "jax"])
def test_loopback_equals_in_process(server, frames, in_process, client):
    """Both clients speak to the port's binary; every answer's bytes equal
    the in-process run."""
    r = server if client == "port" else \
        JaxRemoteSift(host="127.0.0.1", port=server.sock.getpeername()[1])
    try:
        path, sift, feats = in_process
        assert r.initialize()
        assert r.run_sift_data(frames[0]) and r.get_feature_count() > 30
        kp = _same_bytes(r, feats)
        assert r.run_sift(path)
        _same_bytes(r, sift.run(path))
        keys = kp[:24]
        assert r.run_sift_keys(keys)            # sends x, y, sigma, theta
        _same_bytes(r, sift.run_with_keypoints(frames[0], keys[:, :4]))
        r.set_keypoint_list(keys[:9])
        assert r.run_sift_current()
        _same_bytes(r, sift.run_with_keypoints(frames[0], keys[:9]))
        assert r.run_sift_current()                  # the list is consumed
        _same_bytes(r, feats)
        other = HessianSift(SiftConfig(), device="cpu").run(frames[1])
        r.match_set_descriptors(0, feats["desc"])
        r.match_set_descriptors(1, other["desc"])
        want = SiftMatcher(device="cpu").match(feats, other)
        np.testing.assert_array_equal(r.match(), want)
        assert len(want) > 0
    finally:
        if r is not server:
            r.close()


def test_self_test_on_seeded_frames(server_bin):
    """hess_server -test spawns its own binary on loopback and detects and
    matches two seeded 320x240 frames over the wire."""
    out = subprocess.run([server_bin, "-test", "-server", str(_free_port()),
                          "-device", "cpu"], env=_env(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "texture_frame(1): ok=True" in out.stdout
    assert "hess_server self-test passed" in out.stdout


def test_server_without_a_card_answers_0(server_bin, frames):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with RemoteSift(port=_free_port(), server_binary=server_bin,
                    env=_env()) as r:
        assert not r.initialize()                    # -device cuda, the default
        assert not r.run_sift_data(frames[0])
        assert r.get_feature_count() == 0


def test_server_build_flags():
    f = server_build.flags()
    assert f[:2] == ["-O2", "-std=c++17"]
    assert f'-DHESS_PYTHON_EXECUTABLE="{sys.executable}"' in f
    assert server_build.SOURCE.name == "hess_server.cpp"
