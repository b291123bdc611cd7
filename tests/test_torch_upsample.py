"""The upsampled first octave (first_octave < 0, DoG): the port's
ops/resize.upsample, prepare_input and the pipeline at -fo -1 on the CPU vs
the JAX package's CPU path (hessgpu_tpu/ops/resize.py upsample,
pyramid.prepare_input); and the u8 input's conversion (to_float).

Tolerances and their reasons:
  * to_float: bit for bit, the IEEE quotient v / 255 of every u8 value.
  * upsample and the prepared input: bit for bit. Both sides compute the
    same float32 expressions (a copy, a midpoint, a mean of four) in the
    same order.
  * the plan: equal (made from the upsampled size).
  * DoG -fo -1 end to end: the pipeline's tolerances
    (tests/test_torch_pipeline_default.py): count, level, ftype identical,
    x, y, sigma 1e-3 px in level coordinates, theta identical up to one
    2pi/255 quantum on at most 1% of the features, descriptors 5e-4.
  * describe_keypoints at -fo -1 is held to the port's own pipeline (the
    JAX package's re-entry raises for a negative first octave): fed the
    pipeline's own features with their theta, the keypoints that bin back
    to their detection level get the pipeline's descriptors to 1e-5, all
    but 1% of them; none further than 0.02 (a pixel on a bin edge can move
    one vote).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hessgpu_tpu import pyramid as jpyr
from hessgpu_tpu.config import SiftConfig as JConfig
from hessgpu_tpu.ops.resize import to_float as jax_to_float
from hessgpu_tpu.ops.resize import upsample as jax_upsample
from hessgpu_tpu_torch import (describe_keypoints, detect_and_describe,
                               detect_batch, to_numpy_trimmed)
from hessgpu_tpu_torch.convert import config_from_dict
from hessgpu_tpu_torch.describe import _bin_by_scale
from hessgpu_tpu_torch.ops.resize import to_float, upsample
from hessgpu_tpu_torch.pyramid import prepare_input
from hessgpu_tpu_torch.sfm.synthetic import texture_frame

from test_torch_pipeline import _np_table, _torch_table
from test_torch_pipeline_default import _assert_features_agree
from _torch_threads import one_torch_thread  # noqa: F401

SHAPE = (96, 128)


def _configs(**kw):
    jc = JConfig(detector="dog", first_octave=-1, **kw)
    return jc, config_from_dict(dataclasses.asdict(jc))


@pytest.fixture(scope="module")
def img():
    return texture_frame(4, *SHAPE)


@pytest.fixture(scope="module")
def jax_default(img):
    jc, tc = _configs()
    table, aux = jpyr.detect_and_describe(img, jc)
    return tc, table, aux


@pytest.mark.parametrize("shape", [(7, 9), (2, 5, 3), (1, 1), (48, 64)],
                         ids=str)
@pytest.mark.parametrize("log_scale", [1, 2])
def test_upsample_bit_equal_to_jax(shape, log_scale):
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    want = np.asarray(jax_upsample(jnp.asarray(x), log_scale))
    got = upsample(torch.from_numpy(x), log_scale).numpy()
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_to_float_bit_equal_to_jax():
    x = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = np.asarray(jax_to_float(jnp.asarray(x)))
    got = to_float(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    assert got.tobytes() == (x.astype(np.float32) / np.float32(255)).tobytes()


def test_upsample_is_corner_aligned():
    x = torch.from_numpy(np.random.RandomState(1).rand(5, 6)
                         .astype(np.float32))
    y = upsample(x)
    assert torch.equal(y[::2, ::2], x)
    assert torch.equal(y[1:-1:2, ::2], 0.5 * (x[:-1] + x[1:]))
    assert torch.equal(y[-1, ::2], x[-1])        # clamped at the edge


@pytest.mark.parametrize("kind", ["float", "uint8", "rgb"])
def test_prepare_input_at_minus_one(img, kind):
    arr = {"float": img,
           "uint8": (img * 255).astype(np.uint8),
           "rgb": np.stack([img, img[::-1], img[:, ::-1]], -1)}[kind]
    jc, tc = _configs()
    jarr, jplan, _ = jpyr.prepare_input(arr, jc)
    tarr, tplan, tcfg = prepare_input(arr, tc, device="cpu")
    assert tarr.shape == (2 * SHAPE[0], 2 * SHAPE[1])
    assert tarr.numpy().tobytes() == np.asarray(jarr).tobytes()
    assert tuple(tplan) == tuple(jplan)
    assert tcfg.first_octave == -1


def test_hessian_keeps_octave_zero(img):
    """The Hessian personality clamps -fo -1 to 0: no upsample."""
    tarr, tplan, tcfg = prepare_input(
        img, config_from_dict(dataclasses.asdict(JConfig(first_octave=-1))),
        device="cpu")
    assert tarr.shape == SHAPE and tcfg.first_octave == 0


def test_dog_minus_one_matches_jax(jax_default):
    tc, want, jaux = jax_default
    got, taux = detect_and_describe(texture_frame(4, *SHAPE), tc,
                                    device="cpu")
    g, w = _torch_table(got), _np_table(want)
    assert g["x"].shape == w["x"].shape
    _assert_features_agree(g, w, min_count=30)
    np.testing.assert_array_equal(taux["level_counts"].numpy(),
                                  np.asarray(jaux["level_counts"]))
    # octave 0 is the upsampled one: its features lie at half-pixel scale
    f = to_numpy_trimmed(got)
    assert f["sigma"][f["level"] < 3].max() < 2.0
    assert 0 <= f["x"].min() and f["x"].max() < SHAPE[1]
    assert 0 <= f["y"].min() and f["y"].max() < SHAPE[0]


def test_detect_batch_takes_the_octave_input_as_given(img, jax_default):
    """detect_batch neither upsamples nor subsamples (as the JAX package's
    parallel/batch.py): at -fo -1 it is fed the upsampled frames."""
    tc = jax_default[0]
    one, _ = detect_and_describe(img, tc, device="cpu")
    up = upsample(torch.from_numpy(img))[None]
    batch = detect_batch(up, tc, device="cpu")
    for a, b in zip(one, batch):
        assert torch.equal(a, b[0])


def test_bin_by_scale_at_minus_one():
    tc = _configs()[1]
    p = tc.scale_params()
    s0 = p.key_level_sigma(p.key_levels[0])
    assigned, osig = _bin_by_scale(np.array([0.5 * s0, s0, 2 * s0],
                                            np.float32), 4, tc)
    assert assigned.tolist() == [0, 3, 6]
    assert osig.tolist() == [0.5, 1.0, 2.0]


def test_describe_keypoints_at_minus_one_matches_the_pipeline(img,
                                                              jax_default):
    tc = jax_default[0]
    table, _ = detect_and_describe(img, tc, device="cpu")
    f = to_numpy_trimmed(table)
    keys = np.stack([f["x"], f["y"], f["sigma"], f["theta"]], axis=1)
    arr, plan, _ = prepare_input(img, tc, device="cpu")
    binned, _ = _bin_by_scale(f["sigma"], plan.num_octaves, tc)
    kept = binned == f["level"]
    assert kept.mean() >= 0.8 and (f["level"] < 3).any()
    out = describe_keypoints(img, keys, tc, device="cpu")
    np.testing.assert_array_equal(out["theta"], f["theta"])
    assert np.isfinite(out["desc"]).all()
    dd = np.abs(out["desc"] - f["desc"]).max(axis=1)[kept]
    assert (dd <= 1e-5).mean() >= 0.99 and dd.max() <= 0.02, dd.max()
    # without theta: the strongest orientation of each keypoint, computed
    no_theta = describe_keypoints(img, keys[:, :3], tc, has_orientation=False,
                                  device="cpu")
    assert np.isfinite(no_theta["desc"]).all()
    norms = np.linalg.norm(no_theta["desc"], axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)
