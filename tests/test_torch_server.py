"""The port's feature server backend (hessgpu_tpu_torch/server_backend.py)
on the CPU against the JAX package's, in process; the binary over loopback
is tests/test_torch_server_wire.py.

Tolerances: backend against backend are the pipeline's
(tests/test_torch_pipeline_default.py): count, level and ftype identical,
x, y, sigma 1e-3 px in level coordinates, theta identical up to one 2pi/255
quantum on at most 1% of the features, descriptors 5e-4; keypoints handed
in come back bit for bit, and their descriptors agree to 5e-4. The matcher
commands, fed the same descriptors, answer the same pairs.
"""

import numpy as np
import pytest
import torch

from hessgpu_tpu.server_backend import ServerBackend as JaxBackend
from hessgpu_tpu_torch.server_backend import ServerBackend
from hessgpu_tpu_torch.sfm.synthetic import texture_frame

from test_torch_pipeline_default import _assert_features_agree
from _torch_threads import one_torch_thread  # noqa: F401

SHAPE = (160, 208)
GL_LUMINANCE, GL_RGB = 0x1909, 0x1907
GL_UNSIGNED_BYTE, GL_FLOAT = 0x1401, 0x1406


@pytest.fixture(scope="module")
def frames():
    """Two overlapping crops of one seeded texture, as u8."""
    h, w = SHAPE
    big = (texture_frame(30, h + 8, w + 12) * 255 + 0.5).astype(np.uint8)
    return [big[:h, :w].copy(), big[8:, 12:].copy()]


def _pixels(frame, fmt):
    """(bytes, gl_format, gl_type) of a u8 frame sent as `fmt`."""
    if fmt == "u8":
        return frame.tobytes(), GL_LUMINANCE, GL_UNSIGNED_BYTE
    if fmt == "f32":
        return ((frame / np.float32(255)).astype(np.float32).tobytes(),
                GL_LUMINANCE, GL_FLOAT)
    rgb = np.stack([frame, frame, frame // 2 + 64], -1)
    return rgb.tobytes(), GL_RGB, GL_UNSIGNED_BYTE


def _feats(backend):
    """The backend's last features, read through its wire accessors."""
    kp = np.frombuffer(backend.get_key_vector(), np.float32).reshape(-1, 6)
    desc = np.frombuffer(backend.get_des_vector(), np.float32).reshape(-1, 128)
    packed = kp[:, 5].view(np.uint32)
    return dict(x=kp[:, 0], y=kp[:, 1], sigma=kp[:, 2], theta=kp[:, 3],
                response=kp[:, 4], level=(packed & 0xFFFF).astype(np.int32),
                ftype=(packed >> 16).astype(np.int32), desc=desc,
                valid=np.ones(len(kp), bool), kp=kp)


def _run_data(backend, frame, fmt="u8"):
    data, gl_format, gl_type = _pixels(frame, fmt)
    assert backend.run_sift_data(SHAPE[1], SHAPE[0], data, gl_format,
                                 gl_type) == 1
    return _feats(backend)


@pytest.fixture(scope="module")
def backends():
    return JaxBackend(), ServerBackend(device="cpu")


@pytest.mark.parametrize("fmt", ["u8", "f32", "rgb"])
def test_run_sift_data_matches_jax(backends, frames, fmt):
    jax_b, port_b = backends
    want = _run_data(jax_b, frames[0], fmt)
    got = _run_data(port_b, frames[0], fmt)
    assert port_b.feature_count() == jax_b.feature_count() == len(want["x"])
    _assert_features_agree(got, want, min_count=30)


@pytest.mark.parametrize("two_step", [False, True],
                         ids=["run_sift_keys", "set_keypoint_list"])
def test_keypoints_handed_in_match_jax(backends, frames, two_step):
    """COMMAND_RUNSIFT_KEY, and COMMAND_SET_KEYPOINT + COMMAND_RUNSIFT, on
    the octave-0 keypoints of frame 1 (the JAX re-entry clips windows at a
    small octave's border, ROADMAP Queue 3; octave 0 is clear of that)."""
    jax_b, port_b = backends
    kp = _run_data(jax_b, frames[1])["kp"]
    _run_data(port_b, frames[1])
    kp = np.ascontiguousarray(kp[_feats(jax_b)["level"] < 3])
    out = []
    for b in backends:
        if two_step:
            b.set_keypoint_list(kp.tobytes(), len(kp), 1)
            assert b.run_sift_current() == 1
        else:
            assert b.run_sift_keys(kp.tobytes(), len(kp), 1) == 1
        out.append(_feats(b))
    want, got = out
    assert len(got["x"]) == len(kp) >= 15
    np.testing.assert_array_equal(got["kp"], kp)
    np.testing.assert_array_equal(want["kp"], kp)
    assert np.abs(got["desc"] - want["desc"]).max() <= 5e-4
    # the list is consumed: the next COMMAND_RUNSIFT detects again
    assert port_b.run_sift_current() == jax_b.run_sift_current() == 1
    assert port_b.feature_count() == jax_b.feature_count()


@pytest.fixture(scope="module")
def jax_desc(backends, frames):
    return [_run_data(backends[0], f)["desc"] for f in frames]


@pytest.mark.parametrize("mutual", [1, 0])
@pytest.mark.parametrize("as_bytes", [False, True])
def test_match_commands_match_jax(backends, jax_desc, mutual, as_bytes):
    desc = jax_desc
    pairs = []
    for b in backends:
        b.match_set_maxsift(4096)
        for i, d in enumerate(desc):
            if as_bytes:
                q = np.clip(np.floor(512 * d + 0.5), 0, 255).astype(np.uint8)
                b.match_set_descriptors_byte(i, len(q), q.tobytes())
            else:
                b.match_set_descriptors_float(i, len(d), d.tobytes())
        pairs.append(b.match_get_match(4096, 0.7, 0.8, mutual))
    assert pairs[0] == pairs[1] and len(pairs[0]) > 0


def test_initialize_and_failures_without_a_card(frames, capsys):
    """The card asked for and absent: initialize answers 0 and a run answers
    0 with its traceback on stderr; nothing falls back to the CPU."""
    assert ServerBackend(device="cpu").initialize() == 1
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    b = ServerBackend()                               # device defaults to cuda
    assert b.initialize() == 0
    data, gl_format, gl_type = _pixels(frames[0], "u8")
    assert b.run_sift_data(SHAPE[1], SHAPE[0], data, gl_format, gl_type) == 0
    assert b.feature_count() == 0 and b.get_key_vector() == b""
    err = capsys.readouterr().err
    assert "run_sift_data failed" in err and "Traceback" in err \
        and "cuda" in err
