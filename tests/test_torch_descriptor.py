"""The descriptor stage: the port's plain version (ops/descriptor.py, what
ops.cuda.patch.descriptor computes on a CPU tensor) and the tensor code
around it against the JAX package's jnp functions and its Pallas kernel
descriptor_pallas in interpret mode, on the same seeded tables and maps.

Tolerances and their reasons:
  * raw 16 x 8 descriptors vs jnp: 2e-6 of the keypoint's largest entry -
    both sum the window's pixels in float32, in another order (a matmul on
    both sides).
  * raw vs the Pallas kernel: 1e-5 of the largest entry for the kernel's MXU
    form and 2e-3 absolute for its VPU form (the JAX package's own tests
    hold its kernel to these).
  * normalized descriptors: 1e-6 absolute (unit vectors); finalize and
    normalize on the same raw input: 2e-7 (rsqrt and the order of 128 adds).
  * rect descriptors: 5e-6 of the largest raw entry.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hessgpu_tpu.ops import descriptor as jdesc
from hessgpu_tpu.ops.pallas.patch import build_padded_stack, descriptor_pallas
from hessgpu_tpu_torch.convert import level_maps_from_numpy
from hessgpu_tpu_torch.ops import descriptor as tdesc
from hessgpu_tpu_torch.ops.cuda import patch

from test_torch_orientation import _jax_flat, _scene


@pytest.fixture(scope="module", params=[7, 11], ids=["seed7", "seed11"])
def scene(request):
    s = _scene(request.param, 24 if request.param == 7 else 40)
    kt = (np.random.RandomState(request.param + 1).rand(len(s[2]))
          * 2 * np.pi).astype(np.float32)
    kt[:3] = [0.0, np.pi, 5.9]
    return s + (kt,)


def _port_raw(scene):
    grads, rots, kx, ky, ks, lid, valid, kt = scene
    maps = level_maps_from_numpy(grads, rots)
    row = lambda a: torch.from_numpy(a)[None]
    wsize = jdesc.descriptor_window_size(float(ks.max()))
    return patch.descriptor(row(kx), row(ky), row(ks), row(kt), row(valid),
                            row(lid), maps, wsize)[0]


def _jax_flat_desc(scene, **kw):
    grads, rots, kx, ky, ks, lid, valid, kt = scene
    fg, fr, lb, lh, lw = _jax_flat(grads, rots)
    return np.asarray(jdesc.compute_descriptors_flat(
        jnp.asarray(kx), jnp.asarray(ky), jnp.asarray(ks), jnp.asarray(kt),
        jnp.asarray(valid), jnp.asarray(lid), fg, fr, lb, lh, lw,
        wsize=jdesc.descriptor_window_size(float(ks.max())), **kw))


def test_raw_descriptors_match_jnp(scene):
    valid = scene[6]
    want = _jax_flat_desc(scene, normalize=False)
    got = _port_raw(scene)
    assert got.shape == (len(valid), 16, 8)
    got = got.reshape(-1, 128).numpy()
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert scale[valid].min() > 0
    assert (np.abs(got - want)[valid] / scale[valid]).max() <= 2e-6
    assert not got[~valid].any()


@pytest.mark.parametrize("half_sift", [False, True], ids=["full", "half"])
@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "unn"])
def test_finalized_descriptors_match_jnp(scene, half_sift, normalize):
    valid = scene[6]
    want = _jax_flat_desc(scene, half_sift=half_sift, normalize=normalize)
    raw = _port_raw(scene)
    got = tdesc.finalize_descriptors(raw, torch.from_numpy(valid), half_sift,
                                     normalize).numpy()
    assert got.shape == want.shape == (len(valid), 64 if half_sift else 128)
    if normalize:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(np.linalg.norm(got[valid], axis=1), 1.0,
                                   atol=1e-5)
    else:
        scale = np.abs(want).max(axis=1, keepdims=True).clip(1e-30)
        assert (np.abs(got - want) / scale).max() <= 2e-6
    assert not got[~valid].any()
    # the same raw table through both packages' finalize: rounding only
    jfin = np.asarray(jdesc.finalize_descriptors(
        jnp.asarray(raw.numpy()), jnp.asarray(valid), half_sift, normalize))
    np.testing.assert_allclose(got, jfin, rtol=0,
                               atol=2e-7 if normalize else 0)


@pytest.mark.parametrize("mxu", [True, False], ids=["mxu", "vpu"])
def test_raw_descriptors_match_the_pallas_kernel(mxu):
    """descriptor_pallas as the JAX package's own tests run it on the CPU:
    build_padded_stack + interpret=True; mxu=True is the main path's form."""
    s = _scene(7, 8)
    grads, rots, kx, ky, ks, lid, valid = s
    kt = np.array([0.3, 1.2, 5.9, 2.2, 0.0, 4.0, 3.3, 6.1], np.float32)
    wsize = jdesc.descriptor_window_size(float(ks.max()))
    pad = (wsize - 1) // 2 + 1
    ps = build_padded_stack([jnp.asarray(g) for g in grads],
                            [jnp.asarray(r) for r in rots], pad)
    want = np.asarray(descriptor_pallas(
        jnp.asarray(kx), jnp.asarray(ky), jnp.asarray(ks), jnp.asarray(kt),
        jnp.asarray(valid), jnp.asarray(lid), ps, wsize=wsize, pad=pad,
        mxu=mxu, interpret=True)).reshape(len(kx), 128)
    got = _port_raw(s + (kt,)).reshape(-1, 128).numpy()
    if mxu:
        scale = np.abs(want).max(axis=1, keepdims=True)
        assert (np.abs(got - want)[valid] / scale[valid]).max() <= 1e-5
    else:
        np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=2e-3)
    assert not got[~valid].any()      # the port writes zeros there


def test_normalize_descriptors_matches_jnp():
    rng = np.random.RandomState(2)
    d = (rng.rand(20, 128) ** 4).astype(np.float32)
    d[3] = 0.0
    valid = np.ones(20, bool)
    valid[5] = False
    want = np.asarray(jdesc.normalize_descriptors(jnp.asarray(d),
                                                  jnp.asarray(valid)))
    got = tdesc.normalize_descriptors(torch.from_numpy(d),
                                      torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
    assert got.max() <= 0.2 * 1.8 and not got[5].any() and not got[3].any()
    no_mask = tdesc.normalize_descriptors(torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(
        no_mask, np.asarray(jdesc.normalize_descriptors(jnp.asarray(d))),
        rtol=0, atol=2e-7)


@pytest.mark.parametrize("sigma", [0.5, 1.6, 2.0159, 3.2, 7.77, 25.0])
def test_descriptor_window_size_matches(sigma):
    assert tdesc.descriptor_window_size(sigma) == \
        jdesc.descriptor_window_size(sigma)
    assert tdesc.descriptor_window_size(sigma, 2.0) == \
        jdesc.descriptor_window_size(sigma, 2.0)


@pytest.mark.parametrize("half_sift,normalize", [
    (False, True), (True, True), (False, False)],
    ids=["norm", "half", "unn"])
def test_rect_descriptors_match_jnp(half_sift, normalize):
    rng = np.random.RandomState(9)
    h, w = 96, 80
    grad = rng.rand(h, w).astype(np.float32)
    rot = ((rng.rand(h, w) * 2 - 1) * np.pi).astype(np.float32)
    # top-left x, y, width, height: inside, large (window cut by the image),
    # hanging over the border, small
    rects = np.array([[20.0, 25.0, 24.0, 16.0], [50.5, 40.25, 12.0, 12.0],
                      [2.0, 3.0, 70.0, 88.0], [60.0, 70.0, 30.0, 40.0],
                      [10.0, 10.0, 5.0, 7.0]], np.float32)
    valid = np.array([1, 1, 1, 1, 0], bool)
    wsize = int(np.ceil(rects[:, 2:].max())) + 4
    want = np.asarray(jdesc.compute_descriptors_rect(
        *(jnp.asarray(rects[:, i]) for i in range(4)), jnp.asarray(valid),
        jnp.asarray(grad), jnp.asarray(rot), wsize=wsize,
        half_sift=half_sift, normalize=normalize))
    got = tdesc.compute_descriptors_rect(
        *(torch.from_numpy(rects[:, i].copy()) for i in range(4)),
        torch.from_numpy(valid), torch.from_numpy(grad),
        torch.from_numpy(rot), wsize=wsize, half_sift=half_sift,
        normalize=normalize).numpy()
    assert got.shape == want.shape
    scale = np.abs(want).max(axis=1, keepdims=True).clip(1e-30)
    assert (np.abs(got - want) / scale).max() <= 5e-6
    assert not got[~valid].any() and np.abs(got[valid]).max() > 0
