"""The port's utils/viz.dump_views and evaluation.py on the CPU vs the JAX
package's (hessgpu_tpu/utils/viz.py, hessgpu_tpu/evaluation.py).

Tolerances and their reasons:
  * dump_views: the same file names, and every pixel within one 8-bit step
    (1/255) of the JAX package's. The views are float maps scaled to 8 bits
    with truncation, and the Gaussian planes differ by up to 2e-6
    (convolution summation order), which can move a value across a step.
    The keypoint overlay is drawn at rounded positions, which the 1e-3 px
    the two pipelines differ by does not move here.
  * warp_image, rotation_homography, repeatability (numpy on both sides):
    bit for bit.
  * evaluate_repeatability: the same scores. Both detect through their own
    pipeline; the feature sets agree within 1e-3 px, far inside the 2.5 px
    match radius.
"""

import os

import numpy as np
import pytest

from hessgpu_tpu import evaluation as jeval
from hessgpu_tpu.config import SiftConfig as JConfig
from hessgpu_tpu.utils import viz as jviz
from hessgpu_tpu_torch import SiftConfig, evaluation
from hessgpu_tpu_torch.utils import viz
from hessgpu_tpu_torch.sfm.synthetic import texture_frame
from _torch_threads import one_torch_thread  # noqa: F401

SHAPE = (96, 128)


@pytest.fixture(scope="module")
def image():
    return (texture_frame(50, *SHAPE) * 255).astype(np.uint8)


def test_dump_views_match_jax(tmp_path, image):
    from PIL import Image
    port, jax = tmp_path / "port", tmp_path / "jax"
    viz.dump_views(image, SiftConfig(), out_dir=str(port), device="cpu")
    jviz.dump_views(image, JConfig(), out_dir=str(jax))
    names = sorted(os.listdir(jax))
    assert sorted(os.listdir(port)) == names
    assert len(names) >= 20 and "6_keypoints.png" in names
    keys = 0
    for n in names:
        a = np.asarray(Image.open(port / n)).astype(np.int16)
        b = np.asarray(Image.open(jax / n)).astype(np.int16)
        assert a.shape == b.shape, n
        assert np.abs(a - b).max() <= 1, (n, int(np.abs(a - b).max()))
        if n.startswith("5_key"):      # typed keypoint pixels, not gray
            keys += int((np.ptp(a, axis=-1) > 100).sum())
    assert keys > 0


def test_draw_and_colorize_equal_jax(image):
    feats = {"x": np.array([50.0, 100.0, 3.0]), "y": np.array([40.0, 80.0,
                                                               90.0]),
             "sigma": np.array([2.0, 4.0, 1.0]),
             "theta": np.array([0.5, 2.0, 4.0]), "ftype": np.array([0, 2, 1])}
    np.testing.assert_array_equal(viz.draw_keypoints(image, feats),
                                  jviz.draw_keypoints(image, feats))
    rng = np.random.RandomState(0)
    resp = rng.randn(20, 30).astype(np.float32) * 0.02
    valid = rng.rand(20, 30) > 0.9
    # a type is read only where a cell is valid: other cells hold garbage
    ftype = np.where(valid, rng.randint(0, 3, (20, 30)), 12345)
    np.testing.assert_array_equal(viz.colorize_keymap(resp, valid, ftype),
                                  jviz.colorize_keymap(resp, valid, ftype))
    np.testing.assert_array_equal(viz.colorize_response(resp),
                                  jviz.colorize_response(resp))
    np.testing.assert_array_equal(viz.colorize_gradient(np.abs(resp)),
                                  jviz.colorize_gradient(np.abs(resp)))


@pytest.mark.parametrize("angle,scale", [(10, 1.0), (30, 0.8)])
def test_warp_and_homography_equal_jax(image, angle, scale):
    img = image.astype(np.float32) / 255
    H = evaluation.rotation_homography(angle, *SHAPE, scale)
    np.testing.assert_array_equal(H, jeval.rotation_homography(angle, *SHAPE,
                                                               scale))
    np.testing.assert_array_equal(evaluation.warp_image(img, H),
                                  jeval.warp_image(img, H))


def test_repeatability_equals_jax():
    rng = np.random.RandomState(1)
    a = {"x": rng.rand(60) * 128, "y": rng.rand(60) * 96,
         "sigma": rng.rand(60) * 3 + 1}
    H = evaluation.rotation_homography(10, *SHAPE)
    pa = np.stack([a["x"], a["y"], np.ones(60)], 1) @ H.T
    b = {"x": pa[:, 0] / pa[:, 2] + rng.randn(60), "y": pa[:, 1] / pa[:, 2],
         "sigma": a["sigma"] * rng.uniform(0.8, 2.0, 60)}
    got = evaluation.repeatability(a, b, H, SHAPE)
    assert got == jeval.repeatability(a, b, H, SHAPE)
    assert 0.2 < got < 1.0


def test_evaluate_repeatability_equals_jax(image):
    img = image.astype(np.float32) / 255
    kw = dict(angles=(10,), scales=(1.0,))
    got = evaluation.evaluate_repeatability(img, SiftConfig(), device="cpu",
                                            **kw)
    want = jeval.evaluate_repeatability(img, JConfig(), **kw)
    assert got == want
    assert got["mean"] > 0.5
