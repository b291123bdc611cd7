"""blur / octave chain / decimation of the port vs the JAX package.

Inputs are made with numpy from a seed and handed to both sides. On the CPU
the port's wrappers run their plain PyTorch versions; the JAX side runs its
jnp functions and, where they take it, the Pallas kernels in interpret mode.

Tolerance: Gaussian planes agree to atol=2e-6 - the summation order of XLA's
CPU convolution is not the tap order the port (and the TPU kernel) use.
Against the Pallas chain kernel, which does use that order, and for
decimation, which does no arithmetic, the comparison is exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hessgpu_tpu.ops import gaussian as jgauss
from hessgpu_tpu.ops.pallas.conv import (downsample2_pallas,
                                         octave_chain_pallas)
from hessgpu_tpu.params import ScaleSpaceParams as JParams
from hessgpu_tpu.params import gaussian_taps
from hessgpu_tpu_torch.ops import gaussian as tgauss
from hessgpu_tpu_torch.ops.cuda import conv as kconv
from hessgpu_tpu_torch.params import ScaleSpaceParams as TParams

SHAPES = [(2, 96, 128), (1, 200, 264), (1, 101, 75)]
ATOL = 2e-6


def _planes(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("sigma", [1.5199, 3.1])
def test_blur_matches_jax(shape, sigma):
    x = _planes(shape, 1)
    taps = gaussian_taps(sigma)
    got = kconv.blur(torch.from_numpy(x), taps).numpy()
    want = np.asarray(jgauss.blur(jnp.asarray(x), sigma))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # the sigma-taking form is the same function
    np.testing.assert_array_equal(
        tgauss.blur(torch.from_numpy(x), sigma).numpy(), got)


def test_blur_clamps_to_edge():
    """A constant image stays constant and a one-row image blurs along the
    row only: the borders replicate, they do not pad with zeros."""
    taps = gaussian_taps(2.0)
    c = torch.full((1, 20, 24), 0.75)
    np.testing.assert_allclose(kconv.blur(c, taps).numpy(), 0.75, atol=1e-6)
    ramp = torch.arange(24, dtype=torch.float32).repeat(1, 20, 1)
    out = kconv.blur(ramp, taps).numpy()
    np.testing.assert_allclose(out[0, 0], out[0, 19], atol=0)
    assert out[0, 0, 0] > 0.0 and out[0, 0, -1] < 23.0


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("detector", ["hessian", "dog"])
def test_octave_chain_matches_jax(shape, detector):
    x = _planes(shape, 2)
    jp, tp = JParams(detector=detector), TParams(detector=detector)
    want = np.asarray(jgauss.build_octave_chain(jnp.asarray(x), jp))
    got = tgauss.build_octave_chain(torch.from_numpy(x), tp).numpy()
    assert got.shape == want.shape == (shape[0], jp.num_levels) + shape[1:]
    np.testing.assert_array_equal(got[:, 0], x)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # the kernel wrapper (plain version on a CPU tensor) is the same chain
    via = kconv.octave_chain(torch.from_numpy(x), tgauss.chain_taps(tp))
    np.testing.assert_array_equal(via.numpy(), got)


@pytest.mark.parametrize("shape", [(2, 96, 128), (1, 200, 264)], ids=str)
def test_octave_chain_matches_pallas_interpret(shape):
    """The TPU chain kernel in interpret mode accumulates its taps in the
    port's order, so the two agree tighter than with XLA's convolution.
    What remains: XLA's CPU compiler contracts a*b+c into one rounding inside
    the kernel body, the port rounds twice; a last-bit difference per pass
    (6e-8 at these magnitudes) carried through 4 chained levels: atol 5e-7."""
    x = _planes(shape, 3)
    p = JParams()
    taps_list = [gaussian_taps(s) for s in p.incremental_sigmas()]
    want = np.asarray(octave_chain_pallas(jnp.asarray(x), taps_list,
                                          interpret=True))
    got = kconv.octave_chain(torch.from_numpy(x), taps_list).numpy()
    np.testing.assert_allclose(got, want, atol=5e-7, rtol=0)


def test_octave_chain_equals_chained_blur():
    x = torch.from_numpy(_planes((2, 70, 90), 4))
    taps_list = [gaussian_taps(s) for s in TParams().incremental_sigmas()]
    chain = kconv.octave_chain(x, taps_list)
    level = x
    for l, tp in enumerate(taps_list):
        level = kconv.blur(level, tp)
        assert torch.equal(chain[:, l + 1], level)
    # an empty tap vector is the identity transition
    ident = kconv.octave_chain(x, [(), taps_list[0]])
    assert torch.equal(ident[:, 1], x)
    assert torch.equal(ident[:, 2], chain[:, 1])


@pytest.mark.parametrize("shape", SHAPES + [(3, 31, 33)], ids=str)
def test_downsample2_matches_jax(shape):
    x = _planes(shape, 5)
    want = np.asarray(downsample2_pallas(jnp.asarray(x), interpret=True))
    got = kconv.downsample2(torch.from_numpy(x)).numpy()
    assert got.shape == (shape[0], (shape[1] + 1) // 2, (shape[2] + 1) // 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x[:, ::2, ::2])


@pytest.mark.parametrize("log_scale", [1, 2])
def test_resize_downsample_matches_jax(log_scale):
    from hessgpu_tpu.ops import resize as jresize
    from hessgpu_tpu_torch.ops import resize as tresize
    x = _planes((2, 37, 50), 8)
    want = np.asarray(jresize.downsample(jnp.asarray(x), log_scale))
    got = tresize.downsample(torch.from_numpy(x), log_scale).numpy()
    np.testing.assert_array_equal(got, want)


def test_downsample2_reads_a_plane_of_the_stack_in_place():
    stack = torch.from_numpy(_planes((2, 5, 40, 52), 6))
    view = stack[:, 3]
    assert not view.is_contiguous()
    got = kconv.downsample2(view)
    assert got.is_contiguous()
    assert torch.equal(got, stack[:, 3, ::2, ::2])


@pytest.mark.parametrize("call", [
    lambda: kconv.blur(torch.zeros(4, 4), [1.0]),                  # not 3-D
    lambda: kconv.blur(torch.zeros(1, 4, 4, dtype=torch.float64), [1.0]),
    lambda: kconv.blur(torch.zeros(1, 4, 4), [0.5, 0.5]),          # even taps
    lambda: kconv.blur(torch.zeros(1, 4, 4), [1.0 / 35] * 35),     # too wide
    lambda: kconv.octave_chain(torch.zeros(4, 4), [[1.0]]),
    lambda: kconv.downsample2(torch.zeros(4, 4)),
], ids=["blur-2d", "blur-f64", "blur-even", "blur-wide", "chain-2d",
        "down-2d"])
def test_wrappers_refuse_what_the_kernels_do_not_take(call):
    with pytest.raises((TypeError, ValueError)):
        call()
