"""The port's own copies of params/config/plan equal the JAX package's."""

import dataclasses

import numpy as np
import pytest

from hessgpu_tpu import config as jcfg
from hessgpu_tpu import params as jparams
from hessgpu_tpu import pyramid as jpyr
from hessgpu_tpu_torch import config as tcfg
from hessgpu_tpu_torch import params as tparams
from hessgpu_tpu_torch import pyramid as tpyr
from hessgpu_tpu.sfm.synthetic import make_texture as jax_make_texture
from hessgpu_tpu_torch.convert import config_from_dict
from hessgpu_tpu_torch.sfm.synthetic import make_texture, texture_frame

_DROPPED = ("canvas_bf16", "use_pallas")


def _jax_cfg_dict(cfg):
    d = dataclasses.asdict(cfg)
    for k in _DROPPED:
        d.pop(k)
    return d


@pytest.mark.parametrize("sigma", [0.3, 0.8, 1.2262, 1.5199, 1.6, 2.0159,
                                   3.2, 5.0, 9.7])
@pytest.mark.parametrize("factor", [3.0, 4.0])
def test_gaussian_taps_equal(sigma, factor):
    assert tparams.gaussian_taps(sigma, factor) == \
        jparams.gaussian_taps(sigma, factor)
    assert tparams.gaussian_filter_width(sigma, factor) == \
        jparams.gaussian_filter_width(sigma, factor)
    assert tparams.gaussian_taps(sigma, factor, max_width=9) == \
        jparams.gaussian_taps(sigma, factor, max_width=9)


@pytest.mark.parametrize("detector", ["hessian", "dog"])
@pytest.mark.parametrize("num_scales", [2, 3, 4])
def test_scale_space_schedule_equal(detector, num_scales):
    a = tparams.ScaleSpaceParams(num_scales=num_scales, detector=detector)
    b = jparams.ScaleSpaceParams(num_scales=num_scales, detector=detector)
    assert a.incremental_sigmas() == b.incremental_sigmas()
    assert a.direct_sigmas() == b.direct_sigmas()
    assert a.key_levels == b.key_levels
    for name in ("level_min", "level_max", "num_levels", "level_ds",
                 "sigmak", "base_sigma"):
        assert getattr(a, name) == getattr(b, name), name
    assert a.octave_restart_sigma() == b.octave_restart_sigma()
    for fo in (-1, 0, 1):
        assert a.initial_blur_sigma(fo) == b.initial_blur_sigma(fo)
    for kl in a.key_levels:
        assert a.key_level_sigma(kl) == b.key_level_sigma(kl)
        assert a.response_norm(kl) == b.response_norm(kl)


@pytest.mark.parametrize("hw", [(480, 640), (160, 200), (101, 75), (30, 40),
                                (1080, 1920), (3200, 3200), (17, 500)])
@pytest.mark.parametrize("detector", ["hessian", "dog"])
@pytest.mark.parametrize("num_octaves", [-1, 2])
def test_make_plan_equal(hw, detector, num_octaves):
    jc = jcfg.SiftConfig(detector=detector, num_octaves=num_octaves)
    tc = tcfg.SiftConfig(detector=detector, num_octaves=num_octaves)
    assert tuple(tpyr.make_plan(*hw, tc)) == tuple(jpyr.make_plan(*hw, jc))


def test_plan_of_the_main_path():
    plan = tpyr.make_plan(480, 640, tcfg.SiftConfig())
    assert plan.octave_shapes == ((480, 640), (240, 320), (120, 160),
                                  (60, 80), (30, 40))
    assert plan.level_caps == (1536,) * 3 + (384,) * 3 + (96,) * 3 + (32,) * 6


_ARGVS = [
    [],
    ["-sd", "-ofix"],
    ["-t", "0.01", "-e", "8", "-d", "4", "-fo", "-1", "-no", "3"],
    ["-f", "3.5", "-w", "2.5", "-dw", "2", "-m", "3"],
    ["-m", "-s", "0", "-loweo"],
    ["-m2p", "-s", "-ofix", "-ofix-not"],
    ["-maxd", "1024", "-mind", "4", "-b", "-half", "-unn"],
    ["-bvlf", "-tc", "50"],
    ["-tc2", "70", "-v", "0", "-da"],
    ["-topk", "33", "-dog"],
    ["-sift", "-hessian", "-p", "640x480", "-tight"],
    ["-cuda", "0", "-glsl", "-pack", "-nonsense", "-tc3", "5"],
    ["-p", "garbage"],
]


@pytest.mark.parametrize("argv", _ARGVS, ids=[" ".join(a) or "default"
                                              for a in _ARGVS])
def test_parse_args_equal(argv):
    j = jcfg.SiftConfig.parse_args(list(argv))
    t = tcfg.SiftConfig.parse_args(list(argv))
    assert dataclasses.asdict(t) == _jax_cfg_dict(j)
    assert dataclasses.asdict(t.scale_params()) == \
        dataclasses.asdict(j.scale_params())
    # and the hand-over the tests use gives the same object
    assert config_from_dict(dataclasses.asdict(j)) == t


def test_parse_args_missing_value_raises():
    with pytest.raises(ValueError):
        tcfg.SiftConfig.parse_args(["-t"])


def test_truncate_constants_equal():
    for name in ("TRUNCATE_NONE", "TRUNCATE_KEEP_HIGHEST_LEVELS",
                 "TRUNCATE_TOP_K", "TRUNCATE_KEEP_LOWEST_LEVELS"):
        assert getattr(tcfg, name) == getattr(jcfg, name)


def test_config_from_dict_refuses_unknown_keys():
    d = dataclasses.asdict(jcfg.SiftConfig())
    d["no_such_knob"] = 1
    with pytest.raises(ValueError, match="no_such_knob"):
        config_from_dict(d)


@pytest.mark.parametrize("seed,size,n_blobs", [(3, 200, 900), (5, 97, 300),
                                               (7, 64, 50)])
def test_make_texture_equal(seed, size, n_blobs):
    """The port's frame source composites each blob inside its bounding box
    only; the pixels are the JAX package's, bit for bit."""
    want = jax_make_texture(np.random.RandomState(seed), size, n_blobs)
    got = make_texture(np.random.RandomState(seed), size, n_blobs)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_texture_frame_is_the_top_left_crop():
    f = texture_frame(3, 120, 200)
    assert f.shape == (120, 200)
    np.testing.assert_array_equal(
        f, make_texture(np.random.RandomState(3), 200)[:120, :200])
