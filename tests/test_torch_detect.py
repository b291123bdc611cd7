"""The port's detect_octave (plain PyTorch version, on the CPU) vs the JAX
package: the Pallas detect kernel in interpret mode on a 192x256 octave, and
the jnp _detect_octave on a small one. Both sides are fed the SAME Gaussian
stack (built once with the JAX chain, handed over as numpy).

Tolerances and their reasons:
  * valid, ftype: identical.
  * response: exact - both round through fp16, and an f32 last-bit
    difference survives that rounding only on a tie (none in these seeds).
  * dx, dy, ds: atol 1e-5 at the keypoints - XLA's CPU compiler contracts
    a*b+c in the 3x3 adjugate solve, the port rounds every product.
  * grad: rtol 1e-6; rot: atol 2e-6 - sqrt is exact on both sides, atan2
    differs in the last bit between the two libraries.
dx/dy/ds are compared at the keypoints only: off them the solve may be
near-singular (huge offsets, rejected by the |offset| < 1 gate), and on the
one-pixel border the Pallas kernel computes its responses from an
edge-padded Gaussian, the jnp path and the port from clamped responses;
border cells are never keypoints.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hessgpu_tpu.config import SiftConfig as JConfig
from hessgpu_tpu.ops.gaussian import build_octave_chain
from hessgpu_tpu.ops.pallas.detect import detect_octave_pallas
from hessgpu_tpu.params import ScaleSpaceParams
from hessgpu_tpu import pyramid as jpyr
from hessgpu_tpu_torch.convert import octave_from_numpy
from hessgpu_tpu_torch.ops.cuda.detect import (detect_octave,
                                               detect_octave_plain)
from hessgpu_tpu_torch.ops.keypoint import TYPE_NONE


def _noise(h, w, seed):
    return np.random.RandomState(seed).rand(h, w).astype(np.float32)


def _blobs(h, w, seed, n=80):
    """Random-scale blobs: the structure DoG responds to (blurred noise
    almost never yields 3-D DoG extrema)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    for _ in range(n):
        cy, cx = rng.uniform(8, h - 8), rng.uniform(8, w - 8)
        s = rng.uniform(1.5, 6.0)
        a = rng.choice([-1.0, 1.0]) * rng.uniform(0.4, 1.0)
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return (img * 0.5 + 0.5).astype(np.float32)


def _stack(detector, h, w, seed):
    p = ScaleSpaceParams(detector=detector)
    base = _noise(h, w, seed) if detector == "hessian" else _blobs(h, w, seed)
    return np.asarray(build_octave_chain(jnp.asarray(base), p)), p


def _norms(p):
    if p.detector == "hessian":
        return [p.level_sigma(l) ** 4
                for l in range(p.level_min, p.level_max + 1)]
    return [1.0] * p.num_levels


def _compare(got, want, min_keys):
    """got: port (maps, grad, rot) with a leading batch dim of 1; want: the
    JAX triple without it."""
    gm, ggrad, grot = got
    wm, wgrad, wrot = want
    valid = np.asarray(wm.valid)
    assert valid.sum() >= min_keys, f"only {valid.sum()} keypoints exercised"
    np.testing.assert_array_equal(gm.valid[0].numpy(), valid)
    np.testing.assert_array_equal(gm.ftype[0].numpy(), np.asarray(wm.ftype))
    assert (gm.ftype[0].numpy()[~valid] == TYPE_NONE).all()
    np.testing.assert_array_equal(gm.response[0].numpy(),
                                  np.asarray(wm.response))
    for f in ("dx", "dy", "ds"):
        np.testing.assert_allclose(getattr(gm, f)[0].numpy()[valid],
                                   np.asarray(getattr(wm, f))[valid],
                                   atol=1e-5, rtol=0, err_msg=f)
    np.testing.assert_allclose(ggrad[0].numpy(), np.asarray(wgrad),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(grot[0].numpy(), np.asarray(wrot),
                               atol=2e-6, rtol=0)


CASES = [(d, s, da) for d in ("hessian", "dog") for s in (True, False)
         for da in (False, True)]
IDS = [f"{d}-{'sub' if s else 'nosub'}-{'da' if da else 'noda'}"
       for d, s, da in CASES]


@pytest.mark.parametrize("detector,subpixel,darkness", CASES, ids=IDS)
def test_detect_matches_pallas_interpret(detector, subpixel, darkness):
    stack, p = _stack(detector, 192, 256, seed=3)
    kw = dict(threshold=p.threshold, edge_threshold=p.edge_threshold,
              subpixel=subpixel, darkness_adaption=darkness,
              detector=detector)
    want = detect_octave_pallas(jnp.asarray(stack), _norms(p), p.key_levels,
                                interpret=True, **kw)
    got = detect_octave(octave_from_numpy(stack), _norms(p), p.key_levels,
                        **kw)
    _compare(got, want, min_keys=20)


@pytest.mark.parametrize("detector,subpixel,darkness", CASES, ids=IDS)
def test_detect_matches_jnp_small_octave(detector, subpixel, darkness):
    stack, p = _stack(detector, 60, 80, seed=5)
    cfg = JConfig(detector=detector, subpixel=subpixel,
                  darkness_adaption=darkness)
    plan = jpyr.make_plan(60, 80, cfg)
    want = jpyr._detect_octave(jnp.asarray(stack), plan, cfg)
    got = detect_octave(octave_from_numpy(stack), _norms(p), p.key_levels,
                        threshold=p.threshold,
                        edge_threshold=p.edge_threshold, subpixel=subpixel,
                        darkness_adaption=darkness, detector=detector)
    _compare(got, want, min_keys=3)


def test_detect_batched_equals_per_image():
    s0, p = _stack("hessian", 48, 64, seed=7)
    s1, _ = _stack("hessian", 48, 64, seed=8)
    kw = dict(threshold=p.threshold, edge_threshold=p.edge_threshold)
    both = detect_octave(octave_from_numpy(np.stack([s0, s1])), _norms(p),
                         p.key_levels, **kw)
    for i, s in enumerate((s0, s1)):
        one = detect_octave(octave_from_numpy(s), _norms(p), p.key_levels,
                            **kw)
        for a, b in zip(both[0], one[0]):
            assert torch.equal(a[i], b[0])
        assert torch.equal(both[1][i], one[1][0])
        assert torch.equal(both[2][i], one[2][0])


def test_detect_on_cpu_is_the_plain_version():
    stack, p = _stack("dog", 40, 56, seed=9)
    args = (octave_from_numpy(stack), _norms(p), p.key_levels)
    kw = dict(threshold=p.threshold, edge_threshold=p.edge_threshold,
              detector="dog")
    a, b = detect_octave(*args, **kw), detect_octave_plain(*args, **kw)
    for x, y in zip(tuple(a[0]) + a[1:], tuple(b[0]) + b[1:]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bad", [
    dict(key_levels=[0, 1, 2]),            # needs plane -1
    dict(key_levels=[1, 2, 4]),            # needs plane 5 of 5
    dict(key_levels=[2, 1]),               # not ascending
    dict(key_levels=[]),
    dict(detector="harris"),
    dict(norms=[1.0]),
], ids=["low", "high", "order", "empty", "detector", "norms"])
def test_detect_refuses_bad_arguments(bad):
    g = torch.zeros(1, 5, 8, 8)
    kw = dict(norms=[1.0] * 5, key_levels=[1, 2, 3], threshold=0.01,
              edge_threshold=10.0)
    kw.update(bad)
    with pytest.raises(ValueError):
        detect_octave(g, **kw)
