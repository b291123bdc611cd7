"""The default SiftConfig end to end (orientations, multi-orientation
expansion, descriptors): the port's detect_and_describe / detect_batch on the
CPU vs the JAX package's CPU path, both personalities and every option of
the per-keypoint stages.

Tolerances and their reasons:
  * count, valid, level, ftype: identical; x, y, sigma, response as in
    test_torch_pipeline.py (1e-3 px end to end: the pyramids differ by 2e-6
    and the subpixel solve amplifies it to 5e-4 px).
  * theta: identical. It is quantized to 2pi/255, so the 5e-4 px that the
    keypoints differ by upstream would have to carry floor(frac * 255)
    across an integer; that moves a theta by one quantum on 0 of the 210
    (Hessian) + 630 (DoG) features of the pinned 640x480 frame and on 0 of
    the crop's. The test allows ONE_QUANTUM on at most 1% of the features so
    that another seed's edge case reads as what it is, and nothing larger.
  * theta with max_orientations=1 (-m 1) is the full-precision parabola,
    not quantized: 5e-4 rad (measured 4.3e-5: the upstream 5e-4 px move the
    pixels' Gaussian weights).
  * desc: 5e-4 absolute on unit vectors end to end (measured 1.5e-5 Hessian,
    9.4e-5 DoG on the crop: the 5e-4 px shift moves every pixel's bilinear
    weights a little); with theta a quantum away the descriptor is another
    one and is not compared. On the full 640x480 DoG frame one keypoint of 489
    has an ill-conditioned subpixel solve and lands 5.9e-3 px away (its
    descriptor 6.9e-3): the test allows two such features there, within 20x
    the position tolerance (2e-3 px on that frame, whose next largest
    difference is 1.3e-3) and 1e-2 on the descriptor, and none elsewhere.
  * the port fed the JAX package's own table and maps (convert.py): thetas
    and valid identical, raw descriptors 2e-6 of the keypoint's largest entry
    (float32 summation order), normalized 1e-6.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hessgpu_tpu import pyramid as jpyr
from hessgpu_tpu.config import SiftConfig as JConfig
from hessgpu_tpu.ops.compaction import \
    compact_octave_keypoints as jax_compact_octave
from hessgpu_tpu.ops.descriptor import \
    compute_descriptors_flat as jax_descriptors_flat
from hessgpu_tpu.ops.orientation import \
    compute_orientations_flat as jax_orientations_flat
from hessgpu_tpu.parallel.batch import detect_batch as jax_detect_batch
from hessgpu_tpu_torch import (detect_and_describe, detect_batch, make_plan,
                               run_pipeline)
from hessgpu_tpu_torch import pyramid as tpyr
from hessgpu_tpu_torch.config import (TRUNCATE_KEEP_HIGHEST_LEVELS,
                                      TRUNCATE_KEEP_LOWEST_LEVELS,
                                      TRUNCATE_TOP_K)
from hessgpu_tpu_torch.convert import (config_from_dict,
                                       global_table_from_numpy,
                                       level_maps_from_numpy)
from hessgpu_tpu_torch.sfm.synthetic import make_texture, texture_frame

from test_torch_orientation import _jax_flat
from test_torch_pipeline import _chip_smoke, _np_table, _torch_table

ONE_QUANTUM = 2 * np.pi / 255 + 1e-6


@pytest.fixture(scope="module")
def crop():
    """A 160x200 crop of a seeded 640 texture."""
    tex = make_texture(np.random.RandomState(1), 640)
    return np.ascontiguousarray(tex[200:360, 280:480])


def _configs(**kw):
    jc = JConfig(**kw)
    return jc, config_from_dict(dataclasses.asdict(jc))


def _assert_features_agree(got, want, num_scales=3, min_count=1, px=1e-3,
                           quantized=True, loose=0):
    """loose: how many features may exceed the position and descriptor
    tolerances, by at most 20x (an ill-conditioned subpixel solve)."""
    valid = want["valid"]
    assert valid.sum() >= min_count, f"only {valid.sum()} features"
    for f in ("valid", "level", "ftype"):
        np.testing.assert_array_equal(got[f], want[f])
    rdiff = np.abs(got["response"] - want["response"])
    assert (rdiff <= 2.0 ** -10 * np.abs(want["response"])).all()
    tol = px * np.exp2(want["level"] // num_scales)
    for f in ("x", "y", "sigma"):
        diff = np.abs(got[f] - want[f])
        assert (diff > tol).sum() <= loose and (diff <= 20 * tol).all(), \
            (f, float((diff / tol).max()))
    dth = np.abs(np.mod(got["theta"] - want["theta"] + np.pi, 2 * np.pi)
                 - np.pi)
    if quantized:
        moved = dth > 1e-6
        assert dth.max() <= ONE_QUANTUM \
            and moved.sum() <= valid.sum() // 100, \
            (float(dth.max()), int(moved.sum()))
    else:
        moved = np.zeros_like(valid)
        assert dth.max() <= 5e-4, float(dth.max())
    assert got["desc"].shape == want["desc"].shape
    ddiff = np.abs(got["desc"][~moved] - want["desc"][~moved]).max(axis=1)
    assert (ddiff > 5e-4).sum() <= loose and ddiff.max() <= 1e-2, \
        float(ddiff.max())
    assert not got["desc"][~valid].any() and not got["theta"][~valid].any()
    return int(moved.sum())


@pytest.mark.parametrize("detector", ["hessian", "dog"])
def test_default_config_matches_jax(crop, detector):
    jc, tc = _configs(detector=detector)
    want, jaux = jpyr.detect_and_describe(crop, jc)
    got, taux = detect_and_describe(crop, tc, device="cpu")
    g, w = _torch_table(got), _np_table(want)
    assert g["x"].shape == w["x"].shape
    _assert_features_agree(g, w, min_count=20)
    np.testing.assert_array_equal(taux["level_counts"].numpy(),
                                  np.asarray(jaux["level_counts"]))
    assert int(taux["pre_count"]) == int(jaux["pre_count"])
    # more features than keypoints: some got a second orientation
    assert int(got.count()) > int(taux["pre_count"])
    norms = np.linalg.norm(g["desc"][g["valid"]], axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)


OPTIONS = {
    "ofix-desc": dict(fixed_orientation=True),
    "orient-nodesc": dict(compute_descriptors=False),
    "m1": dict(max_orientations=1),
    "m3": dict(max_orientations=3),
    "m4": dict(max_orientations=4),
    "half": dict(half_sift=True),
    "unn": dict(normalized_sift=False),
    "dog-half-m4": dict(detector="dog", half_sift=True, max_orientations=4),
    "topk": dict(truncate_method=TRUNCATE_TOP_K, feature_count_threshold=25,
                 threshold=0.002),
    "tc2": dict(truncate_method=TRUNCATE_KEEP_LOWEST_LEVELS,
                feature_count_threshold=30, threshold=0.002),
    "tc": dict(truncate_method=TRUNCATE_KEEP_HIGHEST_LEVELS,
               feature_count_threshold=30, threshold=0.002),
    "window-factors": dict(orientation_window_factor=1.5,
                           descriptor_window_factor=2.0),
}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_every_option_runs_and_matches_jax(crop, name):
    kw = OPTIONS[name]
    jc, tc = _configs(**kw)
    want, _ = jpyr.detect_and_describe(crop, jc)
    got, _ = detect_and_describe(crop, tc, device="cpu")
    g, w = _torch_table(got), _np_table(want)
    assert g["desc"].shape == w["desc"].shape
    quantized = kw.get("max_orientations", 2) > 1
    if kw.get("normalized_sift", True):
        _assert_features_agree(g, w, min_count=5, quantized=quantized)
    else:   # raw descriptors: scale the tolerance by their size
        scale = np.abs(w["desc"]).max()
        _assert_features_agree(
            dict(g, desc=g["desc"] / scale), dict(w, desc=w["desc"] / scale),
            min_count=5)
    valid = g["valid"]
    if kw.get("fixed_orientation"):
        assert not g["theta"].any()
    else:
        assert g["theta"][valid].any()
    if kw.get("compute_descriptors", True):
        assert np.abs(g["desc"][valid]).max(axis=1).min() > 0
    else:
        assert not g["desc"].any()
    single = kw.get("fixed_orientation") or kw.get("max_orientations", 2) <= 1
    cap = min(tc.global_feature_cap,
              sum(make_plan(*crop.shape, tc).level_caps))
    assert g["x"].shape[0] == (
        cap if single else int(cap * tc.expansion_factor + 7) // 8 * 8)


def _jax_table_and_maps(img, jc):
    """The JAX package's own global table (level coordinates) and per-level
    gradient maps, by the steps of its CPU pipeline."""
    p = jc.scale_params()
    plan = jpyr.make_plan(*img.shape, jc)
    lists, grads, rots = [], [], []
    nkey = len(p.key_levels)
    for o, g in enumerate(jpyr._build_pyramid(jnp.asarray(img), plan, jc)):
        maps, grad, rot = jpyr._detect_octave(g, plan, jc)
        lists.append(jax_compact_octave(
            maps, [p.key_level_sigma(k) for k in p.key_levels], p.sigmak,
            plan.level_caps[o * nkey]))
        grads += [grad[i] for i in range(nkey)]
        rots += [rot[i] for i in range(nkey)]
    G = min(jc.global_feature_cap, sum(plan.level_caps))
    return jpyr._globalize(lists, G), grads, rots


@pytest.mark.parametrize("detector", ["hessian", "dog"])
def test_hand_over_of_the_jax_table_and_maps(crop, detector):
    """The port's orientation and descriptor stages on the JAX package's own
    table and maps, carried across by convert.py."""
    jc, tc = _configs(detector=detector, global_feature_cap=128)
    jt, grads, rots = _jax_table_and_maps(crop, jc)
    assert int(jt.valid.sum()) >= 15
    table = global_table_from_numpy(
        {f: np.asarray(getattr(jt, f)) for f in jt._fields})
    maps = level_maps_from_numpy([np.asarray(g) for g in grads],
                                 [np.asarray(r) for r in rots])
    assert table.x.shape == (1, jt.x.shape[0])
    assert table.level_id.dtype == torch.int32
    p = tc.scale_params()
    owin, dwin = tpyr.window_sizes(
        tc, p.key_level_sigma(p.key_levels[-1]) * p.sigmak)
    flat = _jax_flat(grads, rots)
    valid = np.asarray(jt.valid)

    want = jax_orientations_flat(jt.x, jt.y, jt.sigma, jt.valid, jt.level_id,
                                 *flat, wsize=owin, num_orientations=2)
    ores = tpyr.orient_table(table, maps, tc, owin, single=False)
    np.testing.assert_array_equal(ores.valid[0].numpy(),
                                  np.asarray(want.valid))
    np.testing.assert_array_equal(ores.thetas[0].numpy(),
                                  np.asarray(want.thetas))
    assert ores.valid[0].numpy()[valid].sum() > valid.sum()

    theta = want.thetas[:, 0]
    wraw = np.asarray(jax_descriptors_flat(
        jt.x, jt.y, jt.sigma, theta, jt.valid, jt.level_id, *flat,
        wsize=dwin, normalize=False))
    wnorm = np.asarray(jax_descriptors_flat(
        jt.x, jt.y, jt.sigma, theta, jt.valid, jt.level_id, *flat,
        wsize=dwin, normalize=True))
    t2 = table._replace(theta=ores.thetas[..., 0].contiguous())
    raw = tpyr.kpatch.descriptor(t2.x, t2.y, t2.sigma, t2.theta, t2.valid,
                                 t2.level_id, maps, dwin)[0]
    scale = np.abs(wraw).max(axis=1, keepdims=True).clip(1e-30)
    assert (np.abs(raw.reshape(-1, 128).numpy() - wraw) / scale).max() <= 2e-6
    got = tpyr.describe_table(t2, maps, tc, dwin)[0].numpy()
    np.testing.assert_allclose(got, wnorm, rtol=0, atol=1e-6)


def test_detect_batch_default_matches_jax(crop):
    imgs = np.stack([crop, crop[::-1].copy()])
    jc, tc = _configs()
    want = _np_table(jax_detect_batch(imgs, jc))
    got = detect_batch(imgs, tc, device="cpu")
    g = _torch_table(got)
    assert g["desc"].shape == want["desc"].shape
    for b in range(2):
        _assert_features_agree({f: g[f][b] for f in g},
                               {f: want[f][b] for f in want}, min_count=20)
    # batched == per image, field for field
    plan = make_plan(*crop.shape, tc)
    for b in range(2):
        one, _ = run_pipeline(torch.from_numpy(imgs[b]), plan, tc)
        for f in one._fields:
            assert torch.equal(getattr(got, f)[b], getattr(one, f)), f


def test_plain_flag_equals_the_cpu_wrappers(crop):
    """On CPU tensors the wrappers ARE the plain versions: plain=True gives
    the same table bit for bit."""
    _, tc = _configs()
    a = detect_batch(crop[None], tc, device="cpu")
    b = detect_batch(crop[None], tc, device="cpu", plain=True)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("detector", ["hessian", "dog"])
def test_frame_640x480_default_pinned_counts(detector):
    """One full-size frame end to end (seed-0 texture) under the default
    configuration: the feature count and per-level counts that chip_smoke.py
    pins for the GPU run, equal to the JAX run here."""
    smoke = _chip_smoke()
    img = texture_frame(0, 480, 640)
    jc, tc = _configs(detector=detector)
    want, jaux = jpyr.detect_and_describe(img, jc)
    got, taux = detect_and_describe(img, tc, device="cpu")
    g, w = _torch_table(got), _np_table(want)
    levels = np.bincount(g["level"][g["valid"]], minlength=15).tolist()
    jlevels = np.bincount(w["level"][w["valid"]], minlength=15).tolist()
    assert levels == jlevels and int(got.count()) == int(w["valid"].sum())
    if detector == "hessian":
        assert int(got.count()) == smoke.FRAME0_FEATURES == 210
        assert levels == smoke.FRAME0_FEATURE_LEVELS
        assert taux["level_counts"].tolist() == smoke.FRAME0_LEVEL_COUNTS
    else:
        assert int(got.count()) == 630
    np.testing.assert_array_equal(np.asarray(jaux["level_counts"]),
                                  taux["level_counts"].numpy())
    assert g["x"].shape == (3072,) and g["desc"].shape == (3072, 128)
    # DoG: one of the 630 features (489 keypoints) has an ill-conditioned
    # subpixel solve - x 5.9e-3 px, sigma 1.7e-3, descriptor 6.9e-3 apart;
    # the next largest are 1.3e-3 px (y) and 5.6e-4: 2e-3 px for DoG here
    hessian = detector == "hessian"
    moved = _assert_features_agree(g, w, min_count=200,
                                   px=1e-3 if hessian else 2e-3,
                                   loose=0 if hessian else 2)
    assert moved == 0
