"""Keypoint re-entry: the port's describe_keypoints / describe_rectangles on
the CPU against the JAX package's, on a seeded crop.

Tolerances and their reasons:
  * descriptors: 2e-6 absolute on unit vectors when both sides are given
    theta. The two Gaussian pyramids differ by up to 2e-6 (convolution
    summation order) and so do the gradient maps; the keypoints are the
    same numbers on both sides, so nothing upstream is amplified.
  * computed theta (has_orientation=False): 5e-6 rad, the full-precision
    parabola through histograms that differ by ~1e-6; descriptors taken at
    those thetas: 1e-5.
  * DoG: compared with the JAX package's accelerator path
    (_force_pallas=True, its Pallas kernels in interpret mode). Its per-level
    CPU path reads the gradient of Gaussian level k+1 for key level k
    (describe.py:49-52 does not re-align the DoG maps as pyramid.py:212-216
    does), so it describes other pixels than its own pipeline; the port
    follows the pipeline. Tolerance there: 1e-4 rad / 1e-5 (the Pallas
    kernel's own agreement with jnp).
  * rectangles: 5e-6 absolute on unit vectors (Hessian personality, where
    the JAX maps are aligned).
"""

import numpy as np
import pytest
import torch

from hessgpu_tpu.config import SiftConfig as JConfig
from hessgpu_tpu.describe import describe_keypoints as jax_describe_keypoints
from hessgpu_tpu.describe import describe_rectangles as jax_describe_rects
import hessgpu_tpu_torch as ht
from hessgpu_tpu_torch.sfm.synthetic import make_texture


@pytest.fixture(scope="module")
def crop():
    tex = make_texture(np.random.RandomState(1), 640)
    return np.ascontiguousarray(tex[200:360, 280:480])


@pytest.fixture(scope="module")
def keys(crop):
    """The crop's own features (x, y, sigma, theta), shuffled so that the
    input order is not the level order."""
    table, _ = ht.detect_and_describe(crop, ht.SiftConfig(), device="cpu")
    f = ht.to_numpy_trimmed(table)
    k = np.stack([f["x"], f["y"], f["sigma"], f["theta"]], axis=1)
    assert len(k) >= 20
    return k[np.random.RandomState(0).permutation(len(k))]


@pytest.mark.parametrize("kw", [dict(), dict(half_sift=True),
                                dict(normalized_sift=False)],
                         ids=["default", "half", "unn"])
def test_describe_with_given_orientation_matches_jax(crop, keys, kw):
    want = jax_describe_keypoints(crop, keys, JConfig(**kw))
    got = ht.describe_keypoints(crop, keys, ht.SiftConfig(**kw), device="cpu")
    for f in ("x", "y", "sigma", "theta"):
        np.testing.assert_array_equal(got[f], want[f])
    np.testing.assert_array_equal(got["theta"], keys[:, 3])
    assert got["desc"].shape == want["desc"].shape == \
        (len(keys), 64 if kw.get("half_sift") else 128)
    scale = 1.0 if kw.get("normalized_sift", True) else \
        np.abs(want["desc"]).max()
    np.testing.assert_allclose(got["desc"], want["desc"], rtol=0,
                               atol=2e-6 * scale)


def test_describe_computing_orientation_matches_jax(crop, keys):
    want = jax_describe_keypoints(crop, keys[:, :3], JConfig(),
                                  has_orientation=False)
    got = ht.describe_keypoints(crop, keys[:, :3], has_orientation=False,
                                device="cpu")
    dth = np.abs(np.mod(got["theta"] - want["theta"] + np.pi, 2 * np.pi)
                 - np.pi)
    assert dth.max() <= 5e-6, dth.max()
    np.testing.assert_allclose(got["desc"], want["desc"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got["desc"], axis=1), 1.0,
                               atol=1e-5)
    # a theta column that the caller disowns is ignored
    again = ht.describe_keypoints(crop, keys, has_orientation=False,
                                  device="cpu")
    np.testing.assert_array_equal(again["theta"], got["theta"])
    np.testing.assert_array_equal(again["desc"], got["desc"])


def test_describe_keeps_the_input_order(crop, keys):
    a = ht.describe_keypoints(crop, keys, device="cpu")
    perm = np.random.RandomState(4).permutation(len(keys))
    b = ht.describe_keypoints(crop, keys[perm], device="cpu")
    np.testing.assert_array_equal(b["desc"], a["desc"][perm])
    np.testing.assert_array_equal(b["x"], keys[perm, 0])


def test_describe_equals_the_pipeline_on_its_own_keypoints(crop):
    """Given the pipeline's x, y, sigma, theta, re-entry reproduces the
    pipeline's descriptors for the keypoints that scale binning sends back
    to the level they were detected on (the subpixel step can move sigma
    across a bin edge; those land on a neighbouring level by design)."""
    from hessgpu_tpu_torch.describe import _bin_by_scale
    cfg = ht.SiftConfig()
    table, _ = ht.detect_and_describe(crop, cfg, device="cpu")
    f = ht.to_numpy_trimmed(table)
    k = np.stack([f["x"], f["y"], f["sigma"], f["theta"]], axis=1)
    got = ht.describe_keypoints(crop, k, cfg, device="cpu")
    noct = ht.make_plan(*crop.shape, cfg).num_octaves
    kept = _bin_by_scale(f["sigma"], noct, cfg)[0] == f["level"]
    assert kept.sum() >= 10 and kept.mean() >= 0.5
    np.testing.assert_allclose(got["desc"][kept], f["desc"][kept], rtol=0,
                               atol=1e-5)


def test_describe_dog_matches_the_jax_kernel_path(crop):
    cfg = ht.SiftConfig(detector="dog")
    table, _ = ht.detect_and_describe(crop, cfg, device="cpu")
    f = ht.to_numpy_trimmed(table)
    k = np.stack([f["x"], f["y"], f["sigma"], f["theta"]], axis=1)[::4][:16]
    jc = JConfig(detector="dog")
    want = jax_describe_keypoints(crop, k, jc, _force_pallas=True)
    got = ht.describe_keypoints(crop, k, cfg, device="cpu")
    np.testing.assert_allclose(got["desc"], want["desc"], rtol=0, atol=1e-5)
    want2 = jax_describe_keypoints(crop, k[:, :3], jc, has_orientation=False,
                                   _force_pallas=True)
    got2 = ht.describe_keypoints(crop, k[:, :3], cfg, has_orientation=False,
                                 device="cpu")
    dth = np.abs(np.mod(got2["theta"] - want2["theta"] + np.pi, 2 * np.pi)
                 - np.pi)
    assert dth.max() <= 1e-4, dth.max()


def test_describe_no_keypoints(crop):
    got = ht.describe_keypoints(crop, np.zeros((0, 4), np.float32),
                                device="cpu")
    assert got["desc"].shape == (0, 128) and got["theta"].shape == (0,)


@pytest.mark.parametrize("kw", [dict(), dict(half_sift=True)],
                         ids=["default", "half"])
def test_describe_rectangles_matches_jax(crop, kw):
    rects = np.array([[20, 30, 40, 32], [100, 50, 24, 24], [5, 5, 150, 120],
                      [60, 60, 12, 16], [150, 100, 60, 70], [0, 0, 30, 30]],
                     np.float32)
    want = jax_describe_rects(crop, rects, JConfig(**kw))
    got = ht.describe_rectangles(crop, rects, ht.SiftConfig(**kw),
                                 device="cpu")
    for f in ("x", "y", "w", "h"):
        np.testing.assert_array_equal(got[f], want[f])
    np.testing.assert_allclose(got["desc"], want["desc"], rtol=0, atol=5e-6)
    np.testing.assert_allclose(np.linalg.norm(got["desc"], axis=1), 1.0,
                               atol=1e-5)


def test_describe_rectangles_dog_runs(crop):
    rects = np.array([[20, 30, 40, 32], [100, 50, 24, 24]], np.float32)
    got = ht.describe_rectangles(crop, rects, ht.SiftConfig(detector="dog"),
                                 device="cpu")
    assert got["desc"].shape == (2, 128) and np.isfinite(got["desc"]).all()
    np.testing.assert_allclose(np.linalg.norm(got["desc"], axis=1), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("entry", ["describe_keypoints",
                                   "describe_rectangles"])
def test_describe_on_cuda_without_a_card_raises(crop, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    arg = np.array([[50.0, 50.0, 2.0, 0.0]], np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(ht, entry)(crop, arg)            # device defaults to cuda
