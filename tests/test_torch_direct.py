"""conv_mode="direct": every level of an octave blurred straight from its
base (the port's ops/gaussian.octave_direct_taps over direct_taps and the direct route of
pyramid._build_pyramid) on the CPU vs the JAX package's CPU path
(hessgpu_tpu/ops/gaussian.py build_octave_direct; its Pallas route ignores
conv_mode, so the JAX CPU run is the reference).

Tolerances and their reasons:
  * the planes, against the JAX package: 2e-6 absolute. XLA's grouped
    convolution sums in another order, and its taps are zero-padded to one
    common width, which adds terms that are 0 but change that order
    (tests/test_torch_pyramid_inplace.py holds the chain to the same).
  * end to end, Hessian and DoG: the pipeline's tolerances
    (tests/test_torch_pipeline_default.py).
  * the JAX package's direct mode takes one image at a time (it unpacks
    h, w = base.shape); the port's batched run is held frame by frame to
    single-image JAX runs, at the same tolerances.
  * the route against the port's plain route (plain=True): bit for bit,
    and the wrappers it calls are counted: one blur a level past level 0,
    the initial blur, one standalone decimation a later octave, no chain.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hessgpu_tpu import pyramid as jpyr
from hessgpu_tpu.config import SiftConfig as JConfig
from hessgpu_tpu.ops.gaussian import build_octave_direct as jax_direct
from hessgpu_tpu.params import ScaleSpaceParams as JParams
from hessgpu_tpu_torch import detect_and_describe, detect_batch, make_plan
from hessgpu_tpu_torch import pyramid as tpyr
from hessgpu_tpu_torch.convert import config_from_dict
from hessgpu_tpu_torch.ops import gaussian
from hessgpu_tpu_torch.ops.cuda import conv as kconv
from hessgpu_tpu_torch.params import ScaleSpaceParams
from hessgpu_tpu_torch.sfm.synthetic import texture_frame

from test_torch_pipeline import _np_table, _torch_table
from test_torch_pipeline_default import _assert_features_agree
from _torch_threads import one_torch_thread  # noqa: F401

ATOL = 2e-6
SHAPE = (96, 128)
FRAMES = 3


def _configs(detector, **kw):
    jc = JConfig(detector=detector, conv_mode="direct", **kw)
    return jc, config_from_dict(dataclasses.asdict(jc))


def _frames(shape=SHAPE, n=FRAMES):
    return np.stack([texture_frame(10 + i, *shape) for i in range(n)])


@pytest.fixture(scope="module", params=["hessian", "dog"])
def jax_runs(request):
    """The JAX package's single-image direct runs of each frame."""
    jc, tc = _configs(request.param)
    frames = _frames()
    return tc, frames, [_np_table(jpyr.detect_and_describe(f, jc)[0])
                        for f in frames]


@pytest.mark.parametrize("detector", ["hessian", "dog"])
@pytest.mark.parametrize("shape", [(96, 128), (101, 75)], ids=str)
def test_build_octave_direct_matches_jax(detector, shape):
    base = np.random.RandomState(5).rand(*shape).astype(np.float32)
    want = np.asarray(jax_direct(jnp.asarray(base), JParams(detector=detector)))
    got = gaussian.octave_direct_taps(
        torch.from_numpy(base),
        gaussian.direct_taps(ScaleSpaceParams(detector=detector)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert torch.equal(got[0], torch.from_numpy(base))   # level 0: the base


@pytest.mark.parametrize("detector", ["hessian", "dog"])
def test_direct_taps_fit_the_kernel(detector):
    """The widest direct level stays within the blur kernel's 33 taps (the
    DoG's 4.82 sigma is clamped there by gaussian_taps)."""
    widths = [len(t) for t in gaussian.direct_taps(
        ScaleSpaceParams(detector=detector))]
    assert widths[0] == 0 and max(widths) <= kconv.MAX_TAPS
    assert widths == ([0, 11, 17, 23, 31] if detector == "hessian"
                      else [0, 11, 17, 23, 31, 33])


@pytest.mark.parametrize("detector", ["hessian", "dog"])
def test_direct_pyramid_matches_jax(detector):
    img = texture_frame(3, *SHAPE)
    jc, tc = _configs(detector)
    plan = make_plan(*SHAPE, tc)
    want = jpyr._build_pyramid(jnp.asarray(img), jpyr.make_plan(*SHAPE, jc),
                               jc)
    got = tpyr._build_pyramid(torch.from_numpy(img)[None], plan, tc)
    assert len(got) == len(want) == plan.num_octaves
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


def test_direct_end_to_end_matches_jax(jax_runs):
    tc, frames, want = jax_runs
    got, _ = detect_and_describe(frames[0], tc, device="cpu")
    g = _torch_table(got)
    assert g["x"].shape == want[0]["x"].shape
    _assert_features_agree(g, want[0], min_count=15)


def test_batched_direct_matches_single_image_jax_runs(jax_runs):
    tc, frames, want = jax_runs
    batch = detect_batch(frames, tc, device="cpu")
    for b in range(FRAMES):
        g = {f: getattr(batch, f)[b].numpy() for f in batch._fields}
        _assert_features_agree(g, want[b], min_count=10)


def _counting(monkeypatch):
    """Count the calls of the conv wrappers that the pyramid makes."""
    calls = {"blur": 0, "downsample2": 0, "octave_chain_into": 0}
    for name in calls:
        fn = getattr(kconv, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(kconv, name, counted)
    return calls


@pytest.mark.parametrize("detector", ["hessian", "dog"])
@pytest.mark.parametrize("shape", [(3, 96, 128), (2, 101, 75), (1, 480, 640)],
                         ids=str)
def test_direct_route_equals_plain_and_counts_its_launches(monkeypatch,
                                                           detector, shape):
    tc = _configs(detector)[1]
    p = tc.scale_params()
    imgs = torch.from_numpy(_frames(shape[1:], shape[0]))
    plan = make_plan(*shape[1:], tc)
    want = tpyr._build_pyramid(imgs, plan, tc, plain=True)
    calls = _counting(monkeypatch)
    got = tpyr._build_pyramid(imgs, plan, tc)
    blurred_levels = sum(1 for t in gaussian.direct_taps(p) if len(t))
    assert calls == {"blur": 1 + blurred_levels * plan.num_octaves,
                     "downsample2": plan.num_octaves - 1,
                     "octave_chain_into": 0}
    if shape == (1, 480, 640):        # the counts chip_smoke.py pins
        assert calls["blur"] == (21 if detector == "hessian" else 26)
        assert calls["downsample2"] == 4
    assert len(got) == len(want)
    for g, w, hw in zip(got, want, plan.octave_shapes):
        assert g.shape == (shape[0], p.num_levels) + hw
        assert torch.equal(g, w)
