"""The port's matcher (hessgpu_tpu_torch/matcher.py) on the CPU vs the JAX
package's (hessgpu_tpu/matcher.py) and vs numpy.

Tolerances: none. The dot matrix is exact (u8 values, sums below 2^24 in
float32, held to numpy's int64 with ==); the match indices are held equal
to the JAX package's, ties included (both take the first of equal maxima,
and a tie gives second best = best, which the ratio test rejects); the
guided gate's mask equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hessgpu_tpu import matcher as jm
from hessgpu_tpu_torch import SiftMatcher
from hessgpu_tpu_torch import matcher as tm


def _unit_desc(rng, n):
    d = np.abs(rng.randn(n, 128)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _scene(seed=0, n1=300, n2=260):
    """Quantized descriptors with planted matches (noisy copies), exact
    duplicates (ties along a row and along a column) and distractors."""
    rng = np.random.RandomState(seed)
    d1 = _unit_desc(rng, n1)
    d2 = _unit_desc(rng, n2)
    d2[:120] = d1[40:160] + rng.randn(120, 128).astype(np.float32) * 0.02
    d2[120:130] = d1[:10]            # row ties: the same copy twice
    d2[130:140] = d1[:10]
    d1[190:200] = d1[170:180]        # column ties
    d2[140:150] = d1[170:180]
    d2 = np.abs(d2) / np.linalg.norm(d2, axis=1, keepdims=True)
    return jm.quantize_descriptors(d1), jm.quantize_descriptors(d2)


def _jax_core(d1, d2, distmax, ratiomax, mutual, gate=None, v1=None, v2=None):
    v1 = np.ones(len(d1), bool) if v1 is None else v1
    v2 = np.ones(len(d2), bool) if v2 is None else v2
    return np.asarray(jm._match_core(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2),
        distmax, ratiomax, mutual_best=mutual,
        gate=None if gate is None else jnp.asarray(gate)))


def _port_core(d1, d2, distmax, ratiomax, mutual, gate=None, v1=None,
               v2=None):
    v1 = np.ones(len(d1), bool) if v1 is None else v1
    v2 = np.ones(len(d2), bool) if v2 is None else v2
    t = torch.from_numpy
    return tm._match_core(t(d1), t(d2), t(v1), t(v2), distmax, ratiomax,
                          mutual_best=mutual,
                          gate=None if gate is None else t(gate)).numpy()


def test_quantization_equals_jax():
    d = _unit_desc(np.random.RandomState(1), 50)
    np.testing.assert_array_equal(tm.quantize_descriptors(d),
                                  jm.quantize_descriptors(d))


@pytest.mark.parametrize("n1,n2", [(300, 260), (1, 7), (7, 1), (513, 129)])
def test_dots_are_exact(n1, n2):
    rng = np.random.RandomState(n1)
    d1 = rng.randint(0, 256, (n1, 128)).astype(np.uint8)
    d2 = rng.randint(0, 256, (n2, 128)).astype(np.uint8)
    d1[0] = 255                      # the largest dot: 128 * 255^2 < 2^24
    if n2 > 1:
        d2[1] = 255
    got = tm.descriptor_dots(torch.from_numpy(d1), torch.from_numpy(d2))
    want = d1.astype(np.int64) @ d2.astype(np.int64).T
    assert got.dtype == torch.float32
    assert (got.numpy().astype(np.int64) == want).all()
    assert (got.numpy() == want).all()


@pytest.mark.parametrize("mutual", [True, False], ids=["mutual", "rows"])
@pytest.mark.parametrize("distmax,ratiomax", [(0.7, 0.8), (1.2, 0.95),
                                              (0.3, 0.6)])
@pytest.mark.parametrize("seed", [0, 1])
def test_match_core_equals_jax(mutual, distmax, ratiomax, seed):
    d1, d2 = _scene(seed)
    want = _jax_core(d1, d2, distmax, ratiomax, mutual)
    got = _port_core(d1, d2, distmax, ratiomax, mutual)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).sum() >= 100
    assert (got[:10] == -1).all()     # every row tie is rejected


@pytest.mark.parametrize("mutual", [True, False], ids=["mutual", "rows"])
def test_match_core_with_masks_equals_jax(mutual):
    d1, d2 = _scene(2)
    rng = np.random.RandomState(3)
    v1 = rng.rand(len(d1)) > 0.1
    v2 = rng.rand(len(d2)) > 0.1
    gate = rng.rand(len(d1), len(d2)) > 0.05
    want = _jax_core(d1, d2, 0.7, 0.8, mutual, gate, v1, v2)
    got = _port_core(d1, d2, 0.7, 0.8, mutual, gate, v1, v2)
    np.testing.assert_array_equal(got, want)
    assert (got[~v1] == -1).all()


def _locations(seed, n1, n2):
    """Positions where the planted pairs of _scene (d2[j] ~ d1[40 + j])
    agree with a homography H, within a pixel, and with F = [t]x H, which
    every pair (x1, H x1) satisfies."""
    rng = np.random.RandomState(seed)
    loc1 = (rng.rand(n1, 2) * [640, 480]).astype(np.float32)
    H = np.array([[1.01, 0.02, 3.0], [-0.01, 0.99, -2.0], [1e-5, 0, 1]],
                 np.float32)
    x = np.concatenate([loc1, np.ones((n1, 1), np.float32)], 1) @ H.T
    loc2 = (rng.rand(n2, 2) * [640, 480]).astype(np.float32)
    loc2[:120] = x[40:160, :2] / x[40:160, 2:] \
        + rng.randn(120, 2).astype(np.float32)
    t = np.array([0.3, -0.2, 1.0])
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    return loc1, loc2, H, (tx @ H).astype(np.float32)


@pytest.mark.parametrize("hdist,fdist", [(32.0, 16.0), (4.0, 1e20),
                                         (1e20, 0.5)])
def test_guided_gate_equals_jax(hdist, fdist):
    loc1, loc2, H, F = _locations(5, 200, 180)
    want = np.asarray(jm._guided_gate(jnp.asarray(loc1), jnp.asarray(loc2),
                                      jnp.asarray(H), hdist, jnp.asarray(F),
                                      fdist))
    t = torch.from_numpy
    got = tm._guided_gate(t(loc1), t(loc2), t(H), hdist, t(F), fdist).numpy()
    assert got.dtype == bool and got.shape == (200, 180)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size


def test_matcher_leaves_the_tf32_setting_as_it_was():
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        tm.descriptor_dots(torch.zeros(2, 128, dtype=torch.uint8),
                           torch.zeros(3, 128, dtype=torch.uint8))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.parametrize("mode", ["plain", "guided-H", "guided-F",
                                  "guided-both", "guided-none", "rows"])
def test_sift_matcher_equals_jax(mode):
    d1, d2 = _scene(4, 200, 180)
    loc1, loc2, H, F = _locations(6, 200, 180)
    pairs = []
    for cls, kw in ((SiftMatcher, {"device": "cpu"}), (jm.SiftMatcher, {})):
        m = cls(**kw)
        m.set_descriptors(0, d1)
        m.set_descriptors(1, d2)
        m.set_feature_location(0, loc1)
        m.set_feature_location(1, loc2)
        if mode == "plain":
            pairs.append(m.get_sift_match())
        elif mode == "rows":
            pairs.append(m.get_sift_match(0.8, 0.9, mutual_best=False))
        else:
            Hm = H if mode in ("guided-H", "guided-both") else None
            Fm = F if mode in ("guided-F", "guided-both") else None
            pairs.append(m.get_guided_sift_match(Hm, Fm, hdistmax=8.0))
    got, want = pairs
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(got) > 20


def test_sift_matcher_match_and_float_input():
    rng = np.random.RandomState(7)
    d1 = _unit_desc(rng, 50)
    perm = rng.permutation(50)
    m = SiftMatcher(device="cpu")
    got = m.match({"desc": d1}, {"desc": d1[perm]})
    assert len(got) == 50 and (perm[got[:, 1]] == got[:, 0]).all()
    assert len(SiftMatcher(device="cpu").match({"desc": d1[:0]},
                                               {"desc": d1})) == 0
    m.set_feature_location(0, np.zeros((50, 2), np.float32))
    with pytest.raises(ValueError, match="set_feature_location"):
        SiftMatcher(device="cpu").get_guided_sift_match(np.eye(3))


def test_sift_matcher_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        SiftMatcher()
