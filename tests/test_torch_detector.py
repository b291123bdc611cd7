"""The HessianSift facade (hessgpu_tpu_torch/detector.py) on the CPU vs the
JAX package's HessianSift on the same PGM files.

Tolerances (the pipeline's, tests/test_torch_pipeline_default.py): count,
level and ftype identical; x, y, sigma 1e-3 px in level coordinates (times
2^octave, and times 2^ds under -maxd); theta identical up to one 2pi/255
quantum on at most 1% of the features; descriptors 5e-4. The keypoint
buffer, the caller's response and packed level/type columns carried through
re-entry: bit for bit. Re-entry descriptors (the same keypoints and thetas
on both sides): 5e-4, against the JAX re-entry or, where that departs from
the JAX pipeline, against the pipeline (test_keypoint_reentry_matches_jax).
"""

import numpy as np
import pytest
import torch

from hessgpu_tpu.detector import HessianSift as JSift
from hessgpu_tpu.config import SiftConfig as JConfig
from hessgpu_tpu.utils.timing import REFERENCE_BUCKETS as JAX_BUCKETS
from hessgpu_tpu_torch import HessianSift, SiftConfig, make_plan
from hessgpu_tpu_torch.describe import _bin_by_scale
from hessgpu_tpu_torch.features import keypoint_buffer
from hessgpu_tpu_torch.formats import load_sift_text
from hessgpu_tpu_torch.sfm.synthetic import texture_frame

from test_torch_pipeline_default import _assert_features_agree
from _torch_threads import one_torch_thread  # noqa: F401

SHAPE = (128, 160)


def write_pgm(path, img):
    """A float [0, 1] image as an 8-bit binary PGM."""
    a = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(f"P5\n{a.shape[1]} {a.shape[0]}\n255\n".encode())
        f.write(a.tobytes())
    return str(path)


def _as_table(feats):
    """A trimmed feature dict in the layout _assert_features_agree reads."""
    return dict(feats, valid=np.ones(len(feats["x"]), bool))


@pytest.fixture(scope="module")
def pgms(tmp_path_factory):
    d = tmp_path_factory.mktemp("pgm")
    return [write_pgm(d / f"f{i}.pgm", texture_frame(20 + i, *SHAPE))
            for i in range(2)]


@pytest.fixture(scope="module")
def jax_feats(pgms):
    sift = JSift(JConfig())
    return [sift.run(p) for p in pgms]


def test_run_matches_jax(pgms, jax_feats):
    sift = HessianSift(SiftConfig(), device="cpu")
    got = sift.run(pgms[0])
    assert sift.feature_num == len(got["x"]) == len(jax_feats[0]["x"])
    _assert_features_agree(_as_table(got), _as_table(jax_feats[0]),
                           min_count=30)
    assert list(sift.timer.last) == ["load", "pipeline", "download"]
    kp, desc = sift.get_feature_vector()
    assert kp.tobytes() == keypoint_buffer(got).tobytes()
    assert desc is got["desc"]


def test_image_list_and_run_next(pgms, jax_feats):
    sift = HessianSift(SiftConfig(), device="cpu")
    sift.set_image_list(pgms)
    for want in jax_feats:
        got = sift.run_next()
        _assert_features_agree(_as_table(got), _as_table(want), min_count=30)
    assert sift.run_next() is None


def test_maxd_rescales_to_the_input(pgms):
    cfg = dict(max_dim=100)
    got = HessianSift(SiftConfig(**cfg), device="cpu").run(pgms[0])
    want = JSift(JConfig(**cfg)).run(pgms[0])
    # the working image is half size: level tolerances scale by 2
    assert len(got["x"]) == len(want["x"]) >= 5
    _assert_features_agree(_as_table(got), _as_table(want), min_count=5,
                           px=2e-3)
    assert got["x"].max() > 80          # in input coordinates


def test_fail_soft(tmp_path):
    bad = str(tmp_path / "absent.pgm")
    sift = HessianSift(SiftConfig(fail_soft=True), device="cpu")
    out = sift.run(bad)
    assert sift.failed and "absent.pgm" in sift.last_error
    assert out["desc"].shape == (0, 128) and out["level"].dtype == np.int32
    assert sift.feature_num == 0
    with pytest.raises(FileNotFoundError):
        HessianSift(SiftConfig(), device="cpu").run(bad)


def test_save_sift_roundtrip(tmp_path, pgms):
    sift = HessianSift(SiftConfig(), device="cpu")
    feats = sift.run(pgms[0])
    p = str(tmp_path / "f0.sift")
    sift.save_sift(p)
    back = load_sift_text(p)
    assert len(back["x"]) == len(feats["x"])
    np.testing.assert_allclose(back["x"], feats["x"], atol=0.005)
    np.testing.assert_allclose(back["desc"], feats["desc"],
                               atol=0.5 / 512 + 1e-7)
    np.testing.assert_array_equal(back["level"], feats["level"])


def test_keypoint_reentry_matches_jax(pgms, jax_feats):
    """The image's own features described again. The JAX package's CPU
    re-entry sizes each level's window from that level's keypoints and
    shifts a window that crosses the border of a small octave inside it, so
    a large keypoint there loses part of its support and its descriptor
    departs from the JAX pipeline's (a reference-side fault); the port's
    re-entry equals its pipeline. Those keypoints are held to the JAX
    pipeline, the others to the JAX re-entry."""
    sift = HessianSift(SiftConfig(), device="cpu")
    sift.run(pgms[0])
    kp, _ = sift.get_feature_vector()
    got = sift.run_with_keypoints(pgms[0], kp)
    want = JSift(JConfig()).run_with_keypoints(pgms[0], kp)
    for k in ("x", "y", "sigma", "theta", "response", "level", "ftype"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["response"], kp[:, 4])
    # a keypoint is binned to a level by its scale, which the subpixel step
    # may have moved off its detection level: the pipeline is the yardstick
    # only of those that bin back to their own level
    noct = make_plan(*SHAPE, sift.config).num_octaves
    kept = _bin_by_scale(kp[:, 2], noct, sift.config)[0] \
        == jax_feats[0]["level"]
    pipe = jax_feats[0]["desc"]
    faulty = kept & (np.abs(want["desc"] - pipe).max(axis=1) > 5e-4)
    assert kept.mean() >= 0.8 and faulty.mean() <= 0.15
    assert np.abs(got["desc"][~faulty] - want["desc"][~faulty]).max() <= 5e-4
    assert np.abs(got["desc"][kept] - pipe[kept]).max() <= 5e-4
    # without theta: one orientation computed per keypoint
    got3 = sift.run_with_keypoints(pgms[1], kp[:, :3], has_orientation=False)
    want3 = JSift(JConfig()).run_with_keypoints(pgms[1], kp[:, :3],
                                               has_orientation=False)
    assert np.abs(got3["theta"] - want3["theta"]).max() <= 5e-4
    assert not got3["response"].any() and not got3["level"].any()


def test_set_keypoint_list_and_run_current(pgms):
    sift = HessianSift(SiftConfig(), device="cpu")
    first = sift.run(pgms[0])
    again = sift.run_current()                   # no list: detection again
    for k in first:
        np.testing.assert_array_equal(again[k], first[k])
    kp, _ = sift.get_feature_vector()
    sift.set_keypoint_list(kp[:7])
    listed = sift.run_current()                  # consumes the list
    direct = sift.run_with_keypoints(pgms[0], kp[:7])
    assert len(listed["x"]) == 7
    np.testing.assert_array_equal(listed["desc"], direct["desc"])
    assert len(sift.run_current()["x"]) == len(first["x"])


def test_config_calls(pgms):
    sift = HessianSift(SiftConfig(prealloc_size=(48, 64)), device="cpu")
    assert sift.feature_num == 0                 # -p ran on zeros, kept none
    sift.parse_param("-dog -t 0.01 -tight")
    assert sift.config.detector == "dog" and sift.config.tight_pyramid
    sift.set_max_dimension(64)
    small = sift.run(pgms[0])                     # 64x80 working size
    sift.set_max_dimension(3200)
    full = sift.run(pgms[0])                      # size changed under -tight
    assert len(small["x"]) > 0 and len(full["x"]) > len(small["x"])


def test_verbose_report(pgms, capsys):
    HessianSift(SiftConfig(verbose=2, feature_count_threshold=10,
                           truncate_method=1), device="cpu").run(pgms[0])
    out = capsys.readouterr().out
    assert "#  octave 0 level 1:" in out
    # ten keypoints kept, more features after the second orientations
    assert "#Features Reduced: 30 -> 17" in out


def test_device_stage_report_buckets(pgms):
    rep = HessianSift(SiftConfig(), device="cpu").device_stage_report(pgms[0])
    assert tuple(rep) == JAX_BUCKETS
    vals = np.array(list(rep.values()))
    assert np.isfinite(vals).all() and (vals >= 0).all()
    assert rep["TOTAL"] >= sum(v for k, v in rep.items() if k != "TOTAL") \
        - 1e-9
    for stage in ("BUILD_PYRAMID", "DETECT_KEYPOINTS", "COMPUTE_DESCRIPTORS"):
        assert rep[stage] > 0


def test_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        HessianSift(SiftConfig())
