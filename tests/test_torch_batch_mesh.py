"""The port's batch mesh (hessgpu_tpu_torch/parallel/batch.py detect_batch
with mesh=) on the CPU against the JAX package's detect_batch over its 2-
and 4-device virtual CPU meshes (tests/conftest.py), and bucket_images
against the JAX package's.

Tolerances: against the JAX package the port's end-to-end ones
(tests/test_torch_pipeline_default.py: the same features, x, y, sigma
within 1e-3 px per octave scale, response 2^-10 relative, theta equal,
descriptors 5e-4), frame by frame, with one keypoint (its two features) of
a frame allowed up to 20x off, an ill-conditioned subpixel solve as that
file allows (measured here: 1.4e-3 px on one keypoint, as on one device);
against the port's own mesh=None run
bit-equal, field for field (each frame's work does not depend on the
batch it rides in).
"""

import functools

import numpy as np
import pytest
import torch

from hessgpu_tpu.config import SiftConfig as JConfig
from hessgpu_tpu.parallel.batch import bucket_images as jax_bucket_images
from hessgpu_tpu.parallel.batch import data_parallel_mesh as jax_mesh
from hessgpu_tpu.parallel.batch import detect_batch as jax_detect_batch
from hessgpu_tpu_torch import SiftConfig
from hessgpu_tpu_torch.parallel import batch as tbatch
from hessgpu_tpu_torch.parallel.batch import (bucket_images, detect_batch,
                                              local_mesh)
from hessgpu_tpu_torch.sfm.synthetic import texture_frame

from test_torch_pipeline import _np_table, _torch_table
from test_torch_pipeline_default import _assert_features_agree
from _torch_graph_route import graph_route  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

B, H, W = 4, 120, 160


def _frames():
    return np.stack([texture_frame(i, H, W) for i in range(B)])


@functools.lru_cache(maxsize=None)
def _jax_table(n):
    """The JAX package's sharded batch program over n virtual devices, run
    once per process for the cases that hold the port to it."""
    return _np_table(jax_detect_batch(_frames(), JConfig(), mesh=jax_mesh(n)))


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture(scope="module")
def one_device(frames):
    return _torch_table(detect_batch(frames, SiftConfig(), device="cpu"))


def _assert_matches_jax_and_mesh_none(got, one_device, n):
    for f in one_device:
        np.testing.assert_array_equal(got[f], one_device[f], err_msg=f)
    want = _jax_table(n)
    for b in range(B):
        _assert_features_agree({f: v[b] for f, v in got.items()},
                               {f: v[b] for f, v in want.items()},
                               min_count=5, loose=2)


@pytest.mark.parametrize("n", [2, 4])
def test_batch_mesh_matches_jax_and_mesh_none(frames, one_device, n):
    got = _torch_table(detect_batch(frames, SiftConfig(), mesh=local_mesh(n),
                                    device="cpu"))
    _assert_matches_jax_and_mesh_none(got, one_device, n)


@pytest.mark.parametrize("n", [2, 4])
def test_the_captured_batch_program_matches_jax(frames, one_device, n,
                                                graph_route):
    """The function a card captures for detect_batch over an in-process
    mesh (one graph of every shard's pipeline and the gather,
    _sharded_batch_program), run here by the graph_route fixture."""
    got = _torch_table(detect_batch(frames, SiftConfig(), mesh=local_mesh(n),
                                    device="cpu"))
    assert [c.cache for c in graph_route] == [tbatch._MESH_BATCH_GRAPHS]
    _assert_matches_jax_and_mesh_none(got, one_device, n)


def test_a_batch_that_does_not_split_is_refused(frames):
    with pytest.raises(ValueError, match="divisible"):
        detect_batch(frames[:3], SiftConfig(), mesh=local_mesh(2),
                     device="cpu")


def test_bucket_images_matches_jax():
    rng = np.random.RandomState(3)
    images = [rng.rand(h, w).astype(np.float32)
              for h, w in ((100, 120), (64, 64), (130, 90), (300, 300),
                           (64, 60))]
    buckets = [(128, 128), (64, 64), (160, 160)]
    got, want = bucket_images(images, buckets), \
        jax_bucket_images(images, buckets)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key][0], want[key][0])
        assert got[key][1:] == want[key][1:]
