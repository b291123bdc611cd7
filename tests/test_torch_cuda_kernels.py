"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no interpret mode, so these tests need one NVIDIA GPU and
nvcc; everywhere else they skip. They import nothing of JAX:

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest

(--noconftest because tests/conftest.py sets up JAX, which this file does
not use.) Whether there is a card is decided inside the `card` fixture, never
at import, so every pytest worker collects the same tests.

Tolerances: blur, chain, decimation, valid, ftype, response, dx, dy, ds are
bit-equal (same tap order, -fmad=false); grad 1e-6 relative (sqrtf is IEEE
on both sides, one last bit allowed), rot 2e-6 rad (atan2f vs torch.atan2 may
differ in the last bit).
"""

import numpy as np
import pytest
import torch

from hessgpu_tpu_torch import SiftConfig, detect_batch, make_plan
from hessgpu_tpu_torch import pyramid as tpyr
from hessgpu_tpu_torch.ops import gaussian
from hessgpu_tpu_torch.ops.cuda import (conv, detect, launch_counts,
                                        reset_launch_counts)
from hessgpu_tpu_torch.params import gaussian_taps
from hessgpu_tpu_torch.sfm.synthetic import texture_frame

pytestmark = pytest.mark.gpu

SLICE = dict(compute_descriptors=False, fixed_orientation=True)
SHAPES = [(2, 96, 128), (1, 101, 75), (3, 30, 40)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the CUDA kernels have no "
                    "interpret mode")
    return torch.device("cuda", 0)


def _planes(shape, seed, device):
    x = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    return torch.from_numpy(x).to(device)


def _texture_batch(shape, device):
    b, h, w = shape
    frames = np.stack([texture_frame(seed, h, w) for seed in range(b)])
    return torch.from_numpy(frames).to(device)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("sigma", [0.8, 1.5199, 5.0])
def test_blur_kernel_equals_plain(card, shape, sigma):
    x = _planes(shape, 1, card)
    taps = gaussian_taps(sigma)
    assert torch.equal(conv.blur(x, taps), conv.blur_plain(x, taps))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("detector", ["hessian", "dog"])
def test_octave_chain_kernel_equals_plain(card, shape, detector):
    x = _planes(shape, 2, card)
    taps_list = gaussian.chain_taps(SiftConfig(detector=detector).scale_params())
    got = conv.octave_chain(x, taps_list)
    assert got.shape == (shape[0], 1 + len(taps_list)) + shape[1:]
    assert torch.equal(got, conv.octave_chain_plain(x, taps_list))


@pytest.mark.parametrize("shape", SHAPES + [(2, 31, 33)], ids=str)
def test_downsample2_kernel_equals_plain(card, shape):
    x = _planes(shape, 3, card)
    assert torch.equal(conv.downsample2(x), x[:, ::2, ::2])
    stack = _planes((shape[0], 5) + shape[1:], 4, card)
    view = stack[:, 3]                       # read in place, not contiguous
    assert torch.equal(conv.downsample2(view), stack[:, 3, ::2, ::2])


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("detector", ["hessian", "dog"])
@pytest.mark.parametrize("subpixel", [True, False], ids=["sub", "nosub"])
@pytest.mark.parametrize("darkness", [False, True], ids=["noda", "da"])
def test_detect_kernel_equals_plain(card, shape, detector, subpixel, darkness):
    cfg = SiftConfig(detector=detector, subpixel=subpixel,
                     darkness_adaption=darkness, **SLICE)
    p = cfg.scale_params()
    stack = conv.octave_chain_plain(_texture_batch(shape, card),
                                    gaussian.chain_taps(p))
    args = (stack, tpyr._detect_norms(p, cfg), p.key_levels)
    kw = dict(threshold=p.threshold, edge_threshold=p.edge_threshold,
              subpixel=subpixel, darkness_adaption=darkness,
              detector=detector)
    gm, ggrad, grot = detect.detect_octave(*args, **kw)
    wm, wgrad, wrot = detect.detect_octave_plain(*args, **kw)
    for f in gm._fields:
        assert torch.equal(getattr(gm, f), getattr(wm, f)), f
    torch.testing.assert_close(ggrad, wgrad, rtol=1e-6, atol=0)
    torch.testing.assert_close(grot, wrot, rtol=0, atol=2e-6)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = _planes((2, 40, 48), 5, card)
    with pytest.raises(ValueError, match="contiguous"):
        conv.blur(x.transpose(1, 2), gaussian_taps(1.0))
    with pytest.raises(ValueError, match="contiguous"):
        conv.octave_chain(x[:, ::2], [gaussian_taps(1.0)])
    with pytest.raises(ValueError, match="contiguous"):
        conv.downsample2(x.transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        detect.detect_octave(
            _planes((1, 5, 40, 96), 6, card)[..., ::2], [1.0] * 5, [1, 2, 3],
            threshold=0.01, edge_threshold=10.0)


@pytest.mark.parametrize("detector", ["hessian", "dog"])
def test_main_path_goes_through_the_kernels(card, detector):
    """detect_batch on the card launches every kernel, and its table equals
    the plain versions' on the card field for field."""
    imgs = _texture_batch((2, 160, 200), card)
    cfg = SiftConfig(detector=detector, **SLICE)
    n_oct = make_plan(160, 200, cfg).num_octaves
    reset_launch_counts()
    got = detect_batch(imgs, cfg)
    assert launch_counts() == {"blur": 1, "octave_chain": n_oct,
                               "downsample2": n_oct - 1,
                               "detect_octave": n_oct}
    want = detect_batch(imgs, cfg, plain=True)
    assert launch_counts()["detect_octave"] == n_oct     # plain launched none
    assert int(got.count().min()) >= 10
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
