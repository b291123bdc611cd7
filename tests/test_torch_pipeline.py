"""The slice as a whole: the port's detect_and_describe / detect_batch on the
CPU vs the JAX package's CPU path, config -sd -ofix (detection only,
upright), both personalities and the three truncation modes.

Both tables come out level-major, raster order within a level, so they are
compared slot by slot; the set of (level, row, col) cells is also compared
directly from the two sides' dense maps.

Tolerances and their reasons:
  * count, level, ftype, valid: identical.
  * x, y, sigma, end to end: 1e-3 px in level coordinates (times 2^octave
    in image coordinates). The two Gaussian pyramids differ by up to 2e-6
    (XLA's CPU convolution sums in another order than the port's taps); the
    subpixel solve inverts a matrix of second differences of a determinant of
    second differences, which amplifies that to 5.3e-4 px at worst on these
    frames (90% of keypoints are within 1.9e-4).
  * x, y, sigma, with the port fed the JAX package's own pyramid
    (test_hand_over_of_the_jax_pyramid): 1e-4 px. What is left there is the
    1/16384 fixed-point payload the JAX list carries dx/dy/ds through (half
    a quantum = 3.1e-5; the port keeps f32) and a*b+c contraction in XLA's
    compiled solve.
  * response: equal up to ONE fp16 unit in the last place (2^-10 relative),
    and bit-equal for at least 90% of the keypoints. Both sides round the
    response through fp16. Their Gaussian planes differ by up to 2e-6 (XLA's
    CPU convolution sums in another order than the port's taps), the
    determinant of second differences amplifies that, and now and then the
    f32 value lands on the other side of an fp16 rounding boundary. Fed the
    same Gaussian stack the two are bit-equal (test_torch_detect.py).
  * theta = 0 and desc = 0 on both sides.
"""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hessgpu_tpu import pyramid as jpyr
from hessgpu_tpu.config import SiftConfig as JConfig
from hessgpu_tpu.ops import compaction as jcomp
from hessgpu_tpu.parallel.batch import detect_batch as jax_detect_batch
from hessgpu_tpu_torch import (SiftConfig, detect_and_describe, detect_batch,
                               make_plan, run_pipeline)
from hessgpu_tpu_torch import pyramid as tpyr
from hessgpu_tpu_torch.config import (TRUNCATE_KEEP_HIGHEST_LEVELS,
                                      TRUNCATE_KEEP_LOWEST_LEVELS,
                                      TRUNCATE_TOP_K)
from hessgpu_tpu_torch.convert import (config_from_dict,
                                       feature_table_from_numpy,
                                       octave_from_numpy)
from hessgpu_tpu_torch.features import to_numpy_trimmed
from hessgpu_tpu_torch.sfm.synthetic import make_texture, texture_frame

SLICE = dict(compute_descriptors=False, fixed_orientation=True)


def _chip_smoke():
    """chip_smoke.py at the repo root holds the pinned counts of the seed-0
    frame; the GPU run and this test assert the same constants."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def crop():
    """A 160x200 crop of a seeded 640 texture."""
    tex = make_texture(np.random.RandomState(1), 640)
    return np.ascontiguousarray(tex[200:360, 280:480])


def _np_table(table):
    return {f: np.asarray(getattr(table, f)) for f in table._fields}


def _torch_table(table):
    return {f: getattr(table, f).numpy() for f in table._fields}


def _configs(**kw):
    jc = JConfig(**SLICE, **kw)
    return jc, config_from_dict(dataclasses.asdict(jc))


def _assert_tables_agree(got, want, num_scales=3, min_count=1, px=1e-3):
    valid = want["valid"]
    assert valid.sum() >= min_count, f"only {valid.sum()} keypoints"
    np.testing.assert_array_equal(got["valid"], valid)
    np.testing.assert_array_equal(got["level"], want["level"])
    np.testing.assert_array_equal(got["ftype"], want["ftype"])
    rdiff = np.abs(got["response"] - want["response"])
    assert (rdiff <= 2.0 ** -10 * np.abs(want["response"])).all(), \
        float(rdiff.max())
    assert (rdiff[valid] == 0).mean() >= 0.9, (rdiff[valid] == 0).mean()
    tol = px * np.exp2(want["level"] // num_scales)
    for f in ("x", "y", "sigma"):
        diff = np.abs(got[f] - want[f])
        assert (diff <= tol).all(), (f, float(diff.max()))
    for f in ("theta", "desc"):
        assert not got[f].any() and not want[f].any(), f
        assert got[f].shape == want[f].shape, f


def _port_cells(img, tc):
    """The port's keypoint cells [(level, row, col)] from its dense maps, in
    table order (level-major, raster within a level)."""
    plan = make_plan(*img.shape, tc)
    octs = tpyr._build_pyramid(torch.from_numpy(img)[None], plan, tc)
    out = []
    for o, g in enumerate(octs):
        v = tpyr._detect_octave(g, tc)[0].valid[0].numpy()
        out += [(o * v.shape[0] + int(k), int(r), int(c))
                for k, r, c in np.argwhere(v)]
    return out


@pytest.mark.parametrize("detector", ["hessian", "dog"])
def test_single_image_matches_jax(crop, detector):
    jc, tc = _configs(detector=detector)
    want, jaux = jpyr.detect_and_describe(crop, jc)
    got, taux = detect_and_describe(crop, tc, device="cpu")
    _assert_tables_agree(_torch_table(got), _np_table(want), min_count=10)
    np.testing.assert_array_equal(taux["level_counts"].numpy(),
                                  np.asarray(jaux["level_counts"]))
    assert int(taux["pre_count"]) == int(jaux["pre_count"])

    # the same set of (level, row, col) cells: slot i of the JAX table lies
    # in the i-th cell of the port's dense maps (its offset from the cell
    # centre is a subpixel offset, under 1 px in level coordinates). A cell
    # found by one side only would be tolerated solely where its margin to
    # the threshold / NMS neighbour is under 1e-6 relative (convolution
    # summation order); no seed here has one, so the lists must pair up.
    cells = _port_cells(crop, tc)
    w = _np_table(want)
    assert len(cells) == int(w["valid"].sum()) == int(got.count())
    for i, (level, row, col) in enumerate(cells):
        oss = 2.0 ** (level // 3)
        off = ((w["x"][i] - 0.5) / oss - col, (w["y"][i] - 0.5) / oss - row)
        assert w["level"][i] == level and max(map(abs, off)) < 1.0, \
            f"slot {i}: JAX ({w['level'][i]}, {w['x'][i]}, {w['y'][i]}) " \
            f"vs port cell {(level, row, col)}"


@pytest.mark.parametrize("detector", ["hessian", "dog"])
def test_hand_over_of_the_jax_pyramid(crop, detector):
    """The port's detection + compaction + table on the JAX package's own
    Gaussian stacks: with the pyramids equal, coordinates agree to 1e-4 px."""
    jc, tc = _configs(detector=detector)
    want, _ = jpyr.detect_and_describe(crop, jc)
    jplan = jpyr.make_plan(*crop.shape, jc)
    joct = jpyr._build_pyramid(jnp.asarray(crop), jplan, jc)
    toct = [octave_from_numpy(np.asarray(g)) for g in joct]
    got, _ = tpyr.pipeline_from_octaves(toct, make_plan(*crop.shape, tc), tc)
    _assert_tables_agree({f: v[0] for f, v in _torch_table(got).items()},
                         _np_table(want), min_count=10, px=1e-4)


@pytest.mark.parametrize("method,k", [
    (TRUNCATE_TOP_K, 25), (TRUNCATE_KEEP_LOWEST_LEVELS, 30),
    (TRUNCATE_KEEP_HIGHEST_LEVELS, 30),
], ids=["topk", "tc2", "tc"])
def test_truncation_modes_match_jax(crop, method, k):
    # a lower threshold than the default so that there is enough to cut
    jc, tc = _configs(truncate_method=method, feature_count_threshold=k,
                      threshold=0.002)
    want, jaux = jpyr.detect_and_describe(crop, jc)
    got, taux = detect_and_describe(crop, tc, device="cpu")
    g, w = _torch_table(got), _np_table(want)
    _assert_tables_agree(g, w, min_count=5)
    # the mode really cut something, and pre_count still has the full count
    assert int(taux["pre_count"]) == int(jaux["pre_count"])
    assert g["valid"].sum() < int(taux["pre_count"])
    if method == TRUNCATE_TOP_K:
        assert g["valid"].sum() == k


def test_truncation_above_the_count_keeps_everything(crop):
    _, tc = _configs()
    full, _ = detect_and_describe(crop, tc, device="cpu")
    n = int(full.count())
    for method in (TRUNCATE_TOP_K, TRUNCATE_KEEP_LOWEST_LEVELS,
                   TRUNCATE_KEEP_HIGHEST_LEVELS):
        _, tck = _configs(truncate_method=method,
                          feature_count_threshold=n + 10)
        got, _ = detect_and_describe(crop, tck, device="cpu")
        for a, b in zip(got, full):
            assert torch.equal(a, b)


def test_detect_batch_matches_jax(crop):
    imgs = np.stack([crop, crop[::-1].copy()])
    jc, tc = _configs()
    want = _np_table(jax_detect_batch(imgs, jc))
    got = detect_batch(imgs, tc, device="cpu")
    g = _torch_table(got)
    assert g["x"].shape == (2, want["x"].shape[1])
    for b in range(2):
        _assert_tables_agree({f: g[f][b] for f in g},
                             {f: want[f][b] for f in want}, min_count=10)
    # batched == per image, field for field
    plan = make_plan(*crop.shape, tc)
    for b in range(2):
        one, _ = run_pipeline(torch.from_numpy(imgs[b]), plan, tc)
        for f in one._fields:
            assert torch.equal(getattr(got, f)[b], getattr(one, f)), f


def test_uint8_and_rgb_input(crop):
    """prepare_input's conversions (u8 -> f32 / 255, BT.601 gray) against
    the JAX package's, through the whole pipeline."""
    rgb = np.stack([crop, crop * 0.9, crop * 0.8], axis=-1)
    u8 = (rgb * 255).astype(np.uint8)
    jc, tc = _configs()
    want, _ = jpyr.detect_and_describe(u8, jc)
    got, _ = detect_and_describe(u8, tc, device="cpu")
    _assert_tables_agree(_torch_table(got), _np_table(want), min_count=10)


def test_first_octave_positive_matches_jax(crop):
    """-fo 1: the input is decimated before octave 0 and coordinates are
    scaled back by 2 (tolerances in image px scale with it)."""
    jc, tc = _configs(first_octave=1, threshold=0.002)
    want, _ = jpyr.detect_and_describe(crop, jc)
    got, _ = detect_and_describe(crop, tc, device="cpu")
    _assert_tables_agree(_torch_table(got), _np_table(want), min_count=5,
                         px=2e-3)


def _dot_rows(seed=0, h=96, w=640, step=8, rows=(24, 48, 72)):
    """Rows of dark Gaussian dots (sigma 2 px, `step` px apart, centres
    jittered by 0.3 px, depths 0.5-0.6) on a faintly noisy grey: at octave 0
    each row of dots gives far more keypoints in one row than the per-row
    cap keeps."""
    rng = np.random.RandomState(seed)
    img = 0.6 + 0.02 * rng.rand(h, w)
    yy, xx = np.mgrid[0:h, 0:w]
    for r in rows:
        for c in range(step // 2 + 3, w - 3, step):
            cy, cx = r + rng.uniform(-0.3, 0.3), c + rng.uniform(-0.3, 0.3)
            img -= (0.5 + 0.1 * rng.rand()) \
                * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0)
    return img.astype(np.float32)


def test_row_cap_flood_matches_jax():
    """A scene whose rows hold more keypoints than the per-row candidate cap
    (32 at width 640): the JAX run is shown to hit the cap, and the port
    keeps the same keypoints."""
    img = _dot_rows()
    jc, tc = _configs()
    want, jaux = jpyr.detect_and_describe(img, jc)
    got, taux = detect_and_describe(img, tc, device="cpu")
    # the JAX run hit the cap: a (level, row) of its dense maps holds more
    # than kpr cells, and its level counts are the capped row sums
    jplan = jpyr.make_plan(*img.shape, jc)
    kpr = min(img.shape[1], jcomp._row_cap(img.shape[1]))
    octs = jpyr._build_pyramid(jnp.asarray(img), jplan, jc)
    per_row = np.asarray(jpyr._detect_octave(octs[0], jplan, jc)[0].valid) \
        .sum(-1)                                     # (key level, row)
    assert per_row.max() > kpr
    np.testing.assert_array_equal(
        np.asarray(jaux["level_counts"])[:3], np.minimum(per_row, kpr).sum(-1))
    assert int(jaux["pre_count"]) < per_row.sum()
    # the port: the same counts and the same keypoints
    np.testing.assert_array_equal(taux["level_counts"].numpy(),
                                  np.asarray(jaux["level_counts"]))
    assert int(taux["pre_count"]) == int(jaux["pre_count"])
    _assert_tables_agree(_torch_table(got), _np_table(want), min_count=64)


def test_frame_640x480_pinned_counts():
    """One full-size frame end to end (seed-0 texture): the keypoint count
    and per-level counts that chip_smoke.py pins for the GPU run, equal to
    the JAX run here."""
    smoke = _chip_smoke()
    img = texture_frame(0, 480, 640)
    np.testing.assert_array_equal(
        img, make_texture(np.random.RandomState(0), 640)[:480, :640])
    jc, tc = _configs()
    want, jaux = jpyr.detect_and_describe(img, jc)
    got, taux = detect_and_describe(img, tc, device="cpu")
    assert int(got.count()) == smoke.FRAME0_KEYPOINTS == 139
    assert taux["level_counts"].tolist() == smoke.FRAME0_LEVEL_COUNTS \
        == [22, 18, 19, 19, 22, 22, 13, 3, 1, 0, 0, 0, 0, 0, 0]
    np.testing.assert_array_equal(np.asarray(jaux["level_counts"]),
                                  taux["level_counts"].numpy())
    _assert_tables_agree(_torch_table(got), _np_table(want), min_count=139)
    # the JAX table carried across as tensors, and both trimmed to the host
    carried = feature_table_from_numpy(_np_table(want))
    assert carried.level.dtype == torch.int32 and carried.valid.dtype == torch.bool
    a, b = to_numpy_trimmed(got), to_numpy_trimmed(carried)
    assert a["x"].shape == b["x"].shape == (139,)
    assert a["desc"].shape == b["desc"].shape == (139, 128)
    np.testing.assert_array_equal(a["level"], b["level"])
