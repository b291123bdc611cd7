"""The orientation stage: the port's plain version (ops/orientation.py, what
ops.cuda.patch.orientation computes on a CPU tensor) against the JAX
package's jnp function compute_orientations_flat and against its Pallas
kernel orientation_pallas in interpret mode, on the same seeded tables and
maps, handed over through convert.level_maps_from_numpy.

Tolerances and their reasons:
  * smoothed histograms: 2e-6 of the keypoint's largest bin. Both sides sum
    a keypoint's ~10^2 pixel votes in float32; only the order differs.
  * thetas and valid: identical. Orientations are discrete (peaks above
    0.8 * max, floor(frac * 255)), so a histogram inside its tolerance could
    still flip one; such a keypoint is accepted only if the port's peak
    picking applied to the JAX histogram reproduces the JAX orientations,
    which shows that the deciding comparison lay within the histograms'
    tolerance. No seed here has one.
  * `single` mode (full-precision parabola): 2e-6 rad against jnp; 1e-4 rad
    against the Pallas kernel, the tolerance of the JAX package's own test
    of that kernel.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hessgpu_tpu.ops import orientation as jori
from hessgpu_tpu.ops.gather import window_gather as jax_window_gather
from hessgpu_tpu.ops.pallas.patch import (build_padded_stack,
                                          orientation_pallas)
from hessgpu_tpu_torch.convert import level_maps_from_numpy
from hessgpu_tpu_torch.ops import orientation as tori
from hessgpu_tpu_torch.ops.cuda import patch
from hessgpu_tpu_torch.ops.gather import window_gather

VOTE_TOL = 2e-6
MODES = [dict(single=True), dict(max_peaks=1), dict(max_peaks=2),
         dict(max_peaks=3), dict(max_peaks=4),
         dict(max_peaks=2, half_sift=True),
         dict(single=True, half_sift=True)]
MODE_IDS = ["single", "m1", "m2", "m3", "m4", "m2-half", "single-half"]


def _scene(seed, n):
    """Three levels of random gradient maps and n keypoints spread over them,
    some near the borders, the last one not valid."""
    rng = np.random.RandomState(seed)
    levels = [(64, 96), (64, 96), (32, 48)]
    grads = [rng.rand(*s).astype(np.float32) for s in levels]
    rots = [((rng.rand(*s) * 2 - 1) * np.pi).astype(np.float32)
            for s in levels]
    lid = rng.randint(0, 3, n).astype(np.int32)
    h = np.array([levels[l][0] for l in lid])
    w = np.array([levels[l][1] for l in lid])
    kx = (rng.rand(n) * (w - 2) + 1).astype(np.float32)
    ky = (rng.rand(n) * (h - 2) + 1).astype(np.float32)
    ks = (1.6 + 1.6 * rng.rand(n)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-1] = False
    return grads, rots, kx, ky, ks, lid, valid


@pytest.fixture(scope="module", params=[7, 11], ids=["seed7", "seed11"])
def scene(request):
    return _scene(request.param, 24 if request.param == 7 else 40)


def _wsize(ks):
    return 2 * int(np.ceil(ks.max() * 1.5 * 2.0 + 1)) + 1


def _jax_flat(grads, rots):
    sizes = [g.shape for g in grads]
    bases = np.cumsum([0] + [h * w for h, w in sizes[:-1]])
    return (jnp.concatenate([jnp.asarray(g).reshape(-1) for g in grads]),
            jnp.concatenate([jnp.asarray(r).reshape(-1) for r in rots]),
            jnp.asarray(bases, jnp.int32),
            jnp.asarray([h for h, _ in sizes], jnp.int32),
            jnp.asarray([w for _, w in sizes], jnp.int32))


def _jax_votes(scene, half_sift):
    """The JAX package's smoothed histograms, through its own functions."""
    grads, rots, kx, ky, ks, lid, valid = scene
    fg, fr, lb, lh, lw = _jax_flat(grads, rots)
    wsize = _wsize(ks)

    def per_kp(x, y, s, l):
        gwin, y0, x0 = jax_window_gather(fg, lb[l], lh[l], lw[l], y, x, wsize)
        rwin, _, _ = jax_window_gather(fr, lb[l], lh[l], lw[l], y, x, wsize)
        v = jori._histogram36(x, y, s, gwin, rwin, x0.astype(jnp.float32),
                              y0.astype(jnp.float32), wsize,
                              lw[l].astype(jnp.float32),
                              lh[l].astype(jnp.float32), 1.5, 2.0)
        v = jori._smooth6(v)
        if half_sift:
            v = v.at[:18].add(v[18:]).at[18:].set(0.0)
        return v

    return np.asarray(jax.vmap(per_kp)(
        jnp.asarray(kx), jnp.asarray(ky), jnp.asarray(ks), jnp.asarray(lid)))


def _port(scene, **mode):
    grads, rots, kx, ky, ks, lid, valid = scene
    maps = level_maps_from_numpy(grads, rots)
    row = lambda a: torch.from_numpy(a)[None]
    return patch.orientation(row(kx), row(ky), row(ks), row(valid), row(lid),
                             maps, _wsize(ks), **mode)


def _assert_same_or_explained(res, want_th, want_ov, jax_votes, valid, mode):
    th, ov = res.thetas[0].numpy(), res.valid[0].numpy()
    single = mode.get("single", False) or mode.get("max_peaks", 4) <= 1
    if single:
        np.testing.assert_array_equal(ov[valid], want_ov[valid])
        np.testing.assert_allclose(th[valid, 0], want_th[valid, 0], rtol=0,
                                   atol=2e-6)
        return
    differing = ((th != want_th) | (ov != want_ov)).any(-1) & valid
    if differing.any():   # only where the histogram alone decides it
        pth, pov = tori.peaks_from_votes(
            torch.from_numpy(jax_votes[differing]),
            max_peaks=mode.get("max_peaks", 4))
        np.testing.assert_array_equal(pov.numpy(), want_ov[differing])
        np.testing.assert_array_equal(pth.numpy(), want_th[differing])
    assert differing.sum() == 0, f"{differing.sum()} keypoints on an edge"


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_plain_version_matches_jnp(scene, mode):
    grads, rots, kx, ky, ks, lid, valid = scene
    fg, fr, lb, lh, lw = _jax_flat(grads, rots)
    want = jori.compute_orientations_flat(
        jnp.asarray(kx), jnp.asarray(ky), jnp.asarray(ks), jnp.asarray(valid),
        jnp.asarray(lid), fg, fr, lb, lh, lw, wsize=_wsize(ks),
        num_orientations=mode.get("max_peaks", 4),
        half_sift=mode.get("half_sift", False),
        single=mode.get("single", False))
    res = _port(scene, **mode)
    jv = _jax_votes(scene, mode.get("half_sift", False))
    votes = res.votes[0].numpy()
    scale = jv.max(axis=1, keepdims=True)
    assert (np.abs(votes - jv)[valid] / scale[valid]).max() <= VOTE_TOL
    assert not votes[~valid].any()
    assert not res.valid[0].numpy()[~valid].any()
    assert not res.thetas[0].numpy()[~valid].any()
    _assert_same_or_explained(res, np.asarray(want.thetas),
                              np.asarray(want.valid), jv, valid, mode)
    assert res.valid[0].numpy()[valid].sum(axis=1).max() \
        <= (1 if mode.get("single") else mode.get("max_peaks", 4))


@pytest.mark.parametrize("mode", [MODES[0], MODES[2], MODES[4], MODES[5]],
                         ids=["single", "m2", "m4", "m2-half"])
def test_plain_version_matches_the_pallas_kernel(mode):
    """orientation_pallas as the JAX package's own tests run it on the CPU:
    build_padded_stack + interpret=True."""
    scene = _scene(7, 8)
    grads, rots, kx, ky, ks, lid, valid = scene
    wsize = _wsize(ks)
    pad = (wsize - 1) // 2 + 1
    ps = build_padded_stack([jnp.asarray(g) for g in grads],
                            [jnp.asarray(r) for r in rots], pad)
    th, ov = orientation_pallas(
        jnp.asarray(kx), jnp.asarray(ky), jnp.asarray(ks), jnp.asarray(valid),
        jnp.asarray(lid), ps, wsize=wsize, pad=pad,
        half_sift=mode.get("half_sift", False),
        single=mode.get("single", False), max_peaks=mode.get("max_peaks", 4),
        interpret=True)
    th, ov = np.asarray(th), np.asarray(ov)
    res = _port(scene, **mode)
    got_th, got_ov = res.thetas[0].numpy(), res.valid[0].numpy()
    np.testing.assert_array_equal(got_ov[valid], ov[valid])
    assert not got_ov[~valid].any() and not ov[~valid].any()
    if mode.get("single"):
        np.testing.assert_allclose(got_th[valid, 0], th[valid, 0], rtol=0,
                                   atol=1e-4)
    else:
        # thetas of the kernel's invalid peaks are unspecified: compare set ones
        np.testing.assert_array_equal(got_th[valid][ov[valid]],
                                      th[valid][ov[valid]])


def test_peak_picking_on_hand_made_histograms():
    """Ties go to the lowest bin; a flat histogram has no strict local
    maximum and gives no orientation; the cap keeps the strongest peaks."""
    v = np.zeros((4, 36), np.float32)
    v[0, [3, 20]] = 1.0                       # two equal peaks
    v[1, :] = 0.5                             # flat: no strict maximum
    v[2, [5, 12, 19, 26, 33]] = [1.0, 0.95, 0.9, 0.85, 0.81]   # five peaks
    v[3, 10], v[3, 30] = 1.0, 0.79            # second peak under 0.8 * max
    votes = torch.from_numpy(v)
    th, ov = tori.peaks_from_votes(votes, max_peaks=4)
    jth, jov = jax.vmap(lambda h: jori._multi_peaks(h, 0.8, 4))(jnp.asarray(v))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(jov))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jth))
    assert ov.sum(dim=1).tolist() == [2, 0, 4, 1]
    q = 2 * np.pi / 255
    assert th[0, 0] == np.float32(np.floor(3.5 / 36 * 255) * q)
    assert th[0, 1] == np.float32(np.floor(20.5 / 36 * 255) * q)
    th2, ov2 = tori.peaks_from_votes(votes, max_peaks=2)
    assert ov2.sum(dim=1).tolist() == [2, 0, 2, 1]
    np.testing.assert_array_equal(th2[2, :2].numpy(), th[2, :2].numpy())
    ths, ovs = tori.peaks_from_votes(votes, single=True)
    jts = jax.vmap(jori._single_peak)(jnp.asarray(v[[0, 2, 3]]))
    np.testing.assert_allclose(ths[[0, 2, 3], 0].numpy(), np.asarray(jts),
                               rtol=0, atol=1e-6)
    assert ovs[:, 0].all() and not ovs[:, 1:].any()


def test_smooth6_matches_jnp_bit_for_bit():
    v = np.random.RandomState(3).rand(50, 36).astype(np.float32)
    want = np.asarray(jax.vmap(jori._smooth6)(jnp.asarray(v)))
    np.testing.assert_array_equal(tori._smooth6(torch.from_numpy(v)).numpy(),
                                  want)


@pytest.mark.parametrize("wsize", [5, 21, 40])
def test_window_gather_matches_jnp(wsize):
    rng = np.random.RandomState(5)
    flat = rng.rand(2 * 30 * 44 + 17 * 20).astype(np.float32)
    cases = [(0, 30, 44, 2.3, 1.1), (30 * 44, 30, 44, 29.9, 43.2),
             (2 * 30 * 44, 17, 20, 8.5, 10.0), (0, 30, 44, 15.0, 22.7)]
    base, h, w, ky, kx = (np.array(c) for c in zip(*cases))
    win, y0, x0 = window_gather(
        torch.from_numpy(flat), torch.from_numpy(base.astype(np.int64)),
        torch.from_numpy(h.astype(np.int64)),
        torch.from_numpy(w.astype(np.int64)),
        torch.from_numpy(ky.astype(np.float32)),
        torch.from_numpy(kx.astype(np.float32)), wsize)
    for i, (b, hh, ww, y, x) in enumerate(cases):
        jw, jy0, jx0 = jax_window_gather(jnp.asarray(flat), b, hh, ww,
                                         jnp.float32(y), jnp.float32(x), wsize)
        np.testing.assert_array_equal(win[i].numpy(), np.asarray(jw))
        assert (int(y0[i]), int(x0[i])) == (int(jy0), int(jx0))


def test_wrapper_refuses_mismatched_tables():
    grads, rots, kx, ky, ks, lid, valid = _scene(7, 6)
    maps = level_maps_from_numpy(grads, rots)
    row = lambda a: torch.from_numpy(a)[None]
    with pytest.raises(ValueError, match="B, G"):
        patch.orientation(row(kx)[0], row(ky)[0], row(ks)[0], row(valid)[0],
                          row(lid)[0], maps, 15)
    with pytest.raises(ValueError):
        patch.orientation(row(kx), row(ky)[:, :3], row(ks), row(valid),
                          row(lid), maps, 15)
