"""The port's row-sharded filters and detection (hessgpu_tpu_torch/parallel/
spatial.py) on the CPU against the JAX package's (hessgpu_tpu/parallel/
spatial.py) on its 2- and 8-device virtual CPU meshes (tests/conftest.py),
at tests/test_spatial.py's shapes and seeds; the port's mesh is the
in-process one (local_mesh). sharded_detect_and_describe is held in
test_torch_spatial_describe.py.

Tolerances:
  * sharded_blur and the Gaussian stack of sharded_hessian_response: 1e-6
    absolute against the JAX package (the two packages' separable blurs
    round alike; measured 0 here), and bit-equal to the port's one-device
    blur; responses 1e-4 absolute, as tests/test_spatial.py holds the JAX
    package's sharded response to its own.
  * keypoints (sharded_detect_keypoints): the same count and the same set;
    x, y, sigma within 1e-3 px per octave scale, response within 2^-10
    relative, ftype equal - the port's end-to-end tolerances against the JAX
    package (tests/test_torch_pipeline_default.py), since the sharded path
    of each package equals its one-device path. One keypoint of the 256x320
    image has an ill-conditioned subpixel solve and lands 1.2e-3 px from the
    JAX package's (on one device too): one keypoint may exceed the position
    tolerance by at most 20x, as that file allows on its DoG frame.
  * band + halo level maps read through their row origin: the plain
    orientation and descriptor versions give the full maps' results bit for
    bit.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hessgpu_tpu.config import SiftConfig as JConfig
from hessgpu_tpu.ops.gaussian import blur as jax_blur
from hessgpu_tpu.parallel import spatial as jsp
from hessgpu_tpu.parallel.batch import data_parallel_mesh
from hessgpu_tpu_torch.config import SiftConfig
from hessgpu_tpu_torch.ops.cuda import patch as kpatch
from hessgpu_tpu_torch.ops.gather import LevelMaps
from hessgpu_tpu_torch.ops.gaussian import blur as torch_blur
from hessgpu_tpu_torch.parallel import spatial as tsp
from hessgpu_tpu_torch.parallel.distributed import local_mesh
from hessgpu_tpu_torch.pyramid import key_level_gradients
from hessgpu_tpu_torch.sfm.synthetic import texture_frame

from _torch_graph_route import graph_route  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401


def _smooth_image(h, w, seed=42):
    """tests/test_spatial.py's input: seeded noise blurred at sigma 2."""
    img = np.random.RandomState(seed).rand(h, w).astype(np.float32)
    return np.asarray(jax_blur(jnp.asarray(img), 2.0))


def _jax_mesh(n):
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return data_parallel_mesh(n)


def _kp_rows(res):
    """Valid keypoints as a row-sorted (N, 5) array [x, y, sigma, response,
    ftype] (tests/test_spatial.py's helper)."""
    v = np.asarray(res["valid"]).ravel()
    cols = [np.asarray(res[k]).ravel()[v].astype(np.float64)
            for k in ("x", "y", "sigma", "response", "ftype")]
    arr = np.stack(cols, 1)
    return arr[np.lexsort((arr[:, 2], arr[:, 1], arr[:, 0]))]


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("h, w, sigma", [(128, 96, 1.6), (256, 64, 4.5)],
                         ids=["17taps", "33taps"])
def test_sharded_blur_matches_jax(n, h, w, sigma):
    img = np.random.RandomState(h + w).rand(h, w).astype(np.float32)
    want = np.asarray(jsp.sharded_blur(jnp.asarray(img), sigma, _jax_mesh(n)))
    got = tsp.sharded_blur(img, sigma, local_mesh(n), device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    one = torch_blur(torch.from_numpy(img)[None], sigma)[0]
    assert torch.equal(got, one)


@pytest.mark.parametrize("case", ["halo", "height", "first_octave"])
def test_what_the_sharded_path_refuses(case):
    """A blur radius past a band's rows (the exchange reaches the ring
    neighbours only), a height the mesh does not divide, and an octave 0
    that is not the image itself."""
    if case == "halo":
        img = np.zeros((64, 16), np.float32)      # 8 rows a shard, radius 16
        with pytest.raises(ValueError, match="halo"):
            tsp.sharded_blur(img, 4.5, local_mesh(8), device="cpu")
    elif case == "height":
        with pytest.raises(ValueError, match="divisible"):
            tsp.sharded_detect_keypoints(np.zeros((100, 64), np.float32),
                                         SiftConfig(), local_mesh(8),
                                         device="cpu")
    else:
        with pytest.raises(ValueError, match="first_octave"):
            tsp.sharded_detect_and_describe(
                np.zeros((128, 64), np.float32),
                SiftConfig(detector="dog", first_octave=-1), local_mesh(2),
                device="cpu")


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_hessian_response_matches_jax(n):
    img = np.random.RandomState(0).rand(128, 96).astype(np.float32)
    sigmas, norms = [1.2, 1.5], [1.0, 2.0, 3.0]
    jg, jr = jsp.sharded_hessian_response(jnp.asarray(img), sigmas, norms,
                                          _jax_mesh(n))
    tg, tr = tsp.sharded_hessian_response(img, sigmas, norms, local_mesh(n),
                                          device="cpu")
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-4)


def _assert_rows_agree(got, want, loose=1):
    """loose: how many keypoints may exceed 1e-3 px, by at most 20x (an
    ill-conditioned subpixel solve, as in test_torch_pipeline_default.py)."""
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.exp2(np.floor(np.log2(np.maximum(got[:, 2], 1e-9) / 1.6)))
    tol = 1e-3 * np.maximum(scale, 1.0)
    for col in range(3):                     # x, y, sigma: 1e-3 px / octave
        diff = np.abs(got[:, col] - want[:, col])
        assert (diff > tol).sum() <= loose and (diff <= 20 * tol).all()
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=2.0 ** -10)
    np.testing.assert_array_equal(got[:, 4], want[:, 4])


@functools.lru_cache(maxsize=None)
def _jax_keypoints(n, num_octaves):
    """The JAX package's sharded detection over n virtual devices, run once
    per process for the cases that hold the port to it."""
    jc = JConfig(threshold=0.001)
    jc.num_octaves = num_octaves
    return _kp_rows(jsp.sharded_detect_keypoints(
        jnp.asarray(_smooth_image(256, 320)), jc, _jax_mesh(n)))


def _check_keypoints(n, num_octaves):
    tc = SiftConfig(threshold=0.001)
    tc.num_octaves = num_octaves
    want = _jax_keypoints(n, num_octaves)
    got = _kp_rows({k: v.numpy() for k, v in tsp.sharded_detect_keypoints(
        _smooth_image(256, 320), tc, local_mesh(n), device="cpu").items()})
    assert len(want) > 20
    _assert_rows_agree(got, want)


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("num_octaves", [1, 0], ids=["octave0", "all"])
def test_sharded_detect_keypoints_matches_jax(n, num_octaves):
    _check_keypoints(n, num_octaves)


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("num_octaves", [1, 0], ids=["octave0", "all"])
def test_the_captured_keypoint_program_matches_jax(n, num_octaves,
                                                   graph_route):
    """The function a card captures for sharded_detect_keypoints on an
    in-process mesh (_sharded_program without describing), run here by the
    graph_route fixture."""
    _check_keypoints(n, num_octaves)
    assert [c.cache for c in graph_route] == [tsp._SPATIAL_GRAPHS]
    assert graph_route[0].key[3:] == (n, False)


def test_band_level_maps_read_through_their_row_origin():
    """Keypoints near every band border of a 256-row level, read from
    (band + halo) buffers that start at global rows -halo, 64 - halo, ...:
    the plain orientation and descriptor give the whole level's results."""
    cfg = SiftConfig()
    img = torch.from_numpy(texture_frame(5, 256, 96))
    stack = torch.stack([torch_blur(img[None], s)[0]
                         for s in (1.0, 1.6, 2.0, 2.5, 3.2)])[None]
    grad, rot = key_level_gradients(stack, cfg)          # (1, 3, 256, 96)
    n, halo = 4, 40
    hl = grad.shape[-2] // n
    pad = lambda a: torch.cat([a[..., :1, :].expand(1, 3, halo, 96), a,
                               a[..., -1:, :].expand(1, 3, halo, 96)], -2)
    gp, rp = pad(grad), pad(rot)
    bands = lambda a: torch.stack([a[0, :, s * hl:s * hl + hl + 2 * halo]
                                   for s in range(n)])
    whole = LevelMaps((grad.expand(n, 3, 256, 96).contiguous(),),
                      (rot.expand(n, 3, 256, 96).contiguous(),))
    banded = LevelMaps((bands(gp),), (bands(rp),), (-halo,), (hl,), (256,))

    rng = np.random.RandomState(0)
    G = 24
    # row b of the table holds keypoints of band b: its first and last rows,
    # its middle, and the global borders
    rows = np.stack([s * hl + np.concatenate([
        rng.uniform(0, 3, 8), rng.uniform(hl - 3, hl, 8),
        rng.uniform(0, hl, 8)]) for s in range(n)]).astype(np.float32)
    x = torch.from_numpy(rng.uniform(1, 95, (n, G)).astype(np.float32))
    y = torch.from_numpy(rows)
    sigma = torch.from_numpy(rng.uniform(1.5, 4.0, (n, G)).astype(np.float32))
    valid = torch.ones((n, G), dtype=torch.bool)
    lid = torch.from_numpy(rng.randint(0, 3, (n, G)).astype(np.int32))
    owin, dwin = 31, 61
    a = kpatch.orientation_plain(x, y, sigma, valid, lid, whole, owin)
    b = kpatch.orientation_plain(x, y, sigma, valid, lid, banded, owin)
    assert torch.equal(a.thetas, b.thetas) and torch.equal(a.valid, b.valid)
    assert torch.equal(a.votes, b.votes) and torch.equal(a.support,
                                                          b.support)
    theta = a.thetas[..., 0].contiguous()
    da = kpatch.descriptor_plain(x, y, sigma, theta, valid, lid, whole, dwin)
    db = kpatch.descriptor_plain(x, y, sigma, theta, valid, lid, banded, dwin)
    assert torch.equal(da, db) and bool(da.abs().sum() > 0)
