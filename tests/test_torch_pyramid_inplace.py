"""The port's in-place pyramid on the CPU: each octave's base written once,
into level 0 of its stack, by the initial blur (octave 0) or by the previous
chain's decimation (hessgpu_tpu_torch/pyramid.py _build_pyramid,
ops/cuda/conv.py octave_chain_into and blur(out=)).

On a CPU tensor the wrappers run their plain versions, so this checks the
route's bookkeeping (which level is decimated, the crop to the plan's
floor-halved shape, the stacks written in place, the restart blur that the
route leaves out) against the JAX package's _build_pyramid and against the
port's own chain of plain calls (plain=True).

Tolerances: against the port's plain route, none (bit for bit). Against the
JAX package, every level of every octave to atol=2e-6: its CPU path blurs
with XLA's convolution, which sums the taps in another order
(tests/test_torch_conv.py). The decimation itself does no arithmetic, so
level 0 of octave o+1 equals the cropped decimation of level level_ds of
octave o exactly, on both sides.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hessgpu_tpu import pyramid as jpyr
from hessgpu_tpu.config import SiftConfig as JConfig
from hessgpu_tpu.params import ScaleSpaceParams as JParams
from hessgpu_tpu_torch import make_plan
from hessgpu_tpu_torch import pyramid as tpyr
from hessgpu_tpu_torch.convert import config_from_dict
from hessgpu_tpu_torch.ops import gaussian
from hessgpu_tpu_torch.ops.cuda import conv as kconv
from hessgpu_tpu_torch.params import ScaleSpaceParams, gaussian_taps
from hessgpu_tpu_torch.sfm.synthetic import texture_frame

ATOL = 2e-6


def _configs(detector):
    jc = JConfig(detector=detector, compute_descriptors=False,
                 fixed_orientation=True)
    return jc, config_from_dict(dataclasses.asdict(jc))


def _planes(shape, seed):
    return torch.from_numpy(
        np.random.RandomState(seed).rand(*shape).astype(np.float32))


@pytest.mark.parametrize("detector", ["hessian", "dog"])
@pytest.mark.parametrize("shape", [(96, 128), (101, 75)], ids=str)
def test_inplace_pyramid_matches_jax(detector, shape):
    img = texture_frame(3, *shape)
    jc, tc = _configs(detector)
    p = tc.scale_params()
    lds = p.level_ds - p.level_min
    plan = make_plan(*shape, tc)
    assert plan.num_octaves >= 3
    want = [np.asarray(g) for g in jpyr._build_pyramid(
        jnp.asarray(img), jpyr.make_plan(*shape, jc), jc)]
    got = tpyr._build_pyramid(torch.from_numpy(img)[None], plan, tc)
    plain = tpyr._build_pyramid(torch.from_numpy(img)[None], plan, tc,
                                plain=True)
    assert len(got) == len(want) == len(plain) == plan.num_octaves
    for o, (g, w, q) in enumerate(zip(got, want, plain)):
        h, wd = plan.octave_shapes[o]
        assert g.shape == (1, p.num_levels, h, wd) == (1,) + w.shape
        assert torch.equal(g, q), f"octave {o}: in place != plain route"
        np.testing.assert_allclose(g[0].numpy(), w, atol=ATOL, rtol=0)
        if o > 0:   # the base is the previous octave's decimated level
            np.testing.assert_array_equal(
                g[0, 0].numpy(), got[o - 1][0, lds, ::2, ::2][:h, :wd])
            np.testing.assert_array_equal(
                w[0], want[o - 1][lds, ::2, ::2][:h, :wd])


@pytest.mark.parametrize("detector", ["hessian", "dog"])
@pytest.mark.parametrize("num_scales", range(1, 9))
def test_no_restart_blur_under_any_scale_schedule(detector, num_scales):
    """level_ds - num_scales == level_min, so the blur between a decimation
    and the next octave's chain has sigma 0 (both packages), and the
    in-place route, which has no place for it, loses nothing."""
    p = ScaleSpaceParams(detector=detector, num_scales=num_scales)
    assert p.level_ds - p.num_scales == p.level_min
    assert p.octave_restart_sigma() == 0.0
    assert JParams(detector=detector,
                   num_scales=num_scales).octave_restart_sigma() == 0.0


def test_the_inplace_route_refuses_a_restart_blur(monkeypatch):
    _, tc = _configs("dog")
    plan = make_plan(64, 80, tc)
    x = _planes((1, 64, 80), 1)
    monkeypatch.setattr(ScaleSpaceParams, "octave_restart_sigma",
                        lambda self: 0.5)
    with pytest.raises(NotImplementedError, match="restart"):
        tpyr._build_pyramid(x, plan, tc)
    assert len(tpyr._build_pyramid(x, plan, tc, plain=True)) \
        == plan.num_octaves


@pytest.mark.parametrize("shape", [(2, 40, 52), (1, 37, 51)], ids=str)
@pytest.mark.parametrize("level", [0, 3, 4])
@pytest.mark.parametrize("in_place", [True, False],
                         ids=["in-place", "from-base"])
def test_chain_into_fills_next_base_with_the_plain_decimation(shape, level,
                                                              in_place):
    B, H, W = shape
    taps = gaussian.chain_taps(ScaleSpaceParams())
    x = _planes(shape, 2)
    stack = torch.full((B, 1 + len(taps), H, W), float("nan"))
    nxt = torch.full((B, 5, H // 2, W // 2), float("nan"))
    if in_place:
        stack[:, 0] = x
    out = kconv.octave_chain_into(stack, taps, base=None if in_place else x,
                                  decimate_level=level, next_base=nxt[:, 0])
    assert out is stack
    want = kconv.octave_chain_plain(x, taps)
    assert torch.equal(stack, want)
    assert torch.equal(nxt[:, 0], kconv.downsample2_plain(want[:, level])
                       [..., :H // 2, :W // 2])
    assert bool(nxt[:, 1:].isnan().all())        # nothing else written
    # without a decimation the same stack, and next_base untouched
    again = torch.zeros_like(stack)
    kconv.octave_chain_into(again, taps, base=x)
    assert torch.equal(again, want)


def test_blur_writes_into_a_plane_of_a_stack():
    x = _planes((2, 30, 44), 3)
    taps = gaussian_taps(1.2)
    stack = torch.full((2, 4, 30, 44), float("nan"))
    out = kconv.blur(x, taps, out=stack[:, 0])
    assert out.data_ptr() == stack.data_ptr()
    assert torch.equal(stack[:, 0], kconv.blur_plain(x, taps))
    assert bool(stack[:, 1:].isnan().all())


@pytest.mark.parametrize("call", [
    lambda s, n: kconv.octave_chain_into(s[0], [[1.0]] * 4),         # 3-D
    lambda s, n: kconv.octave_chain_into(s, [[1.0]] * 3),       # L != 1 + n
    lambda s, n: kconv.octave_chain_into(s, [[1.0]] * 4,
                                         decimate_level=3),    # no next_base
    lambda s, n: kconv.octave_chain_into(s, [[1.0]] * 4,
                                         next_base=n[:, 0]),   # no level
    lambda s, n: kconv.octave_chain_into(s, [[1.0]] * 4, decimate_level=5,
                                         next_base=n[:, 0]),
    lambda s, n: kconv.octave_chain_into(s, [[1.0]] * 4, decimate_level=3,
                                         next_base=n[:, 0, :-1]),   # shape
    lambda s, n: kconv.octave_chain_into(
        s, [[1.0]] * 4, decimate_level=3,
        next_base=torch.zeros((2, 10, 26))[..., :13]),   # rows not W/2 apart
    lambda s, n: kconv.octave_chain_into(
        s, [[1.0]] * 4, decimate_level=3,
        next_base=n[:, 0].double()),                                # type
    lambda s, n: kconv.blur(s[:, 0].contiguous(), [1.0], out=n[:, 0]),
], ids=["3d", "levels", "no-next", "no-level", "level-5", "next-shape",
        "next-rows", "next-f64", "blur-out-shape"])
def test_inplace_wrappers_refuse_what_the_kernels_do_not_take(call):
    stack = torch.zeros((2, 5, 20, 26))
    nxt = torch.zeros((2, 5, 10, 13))
    with pytest.raises((TypeError, ValueError)):
        call(stack, nxt)
