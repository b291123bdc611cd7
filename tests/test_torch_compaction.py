"""Compaction of the port vs the JAX package: the first `capacity` valid
cells in raster order per key level, zeros past `count`, batched.

The JAX list carries its offsets through a 1/16384 fixed-point payload
(ops/compaction.py _Q) and the response through fp16; the port gathers the
f32 maps. So x, y differ by at most half a quantum (3.1e-5; atol 4e-5),
sigma by that times sigma*ln(sigma_step) (atol 4e-5 at these sigmas), and the
response - made fp16-exact in the inputs here, as the detector leaves it -
is equal. On maps wider than 64 (the row-cap cases) x and y are also one
float32 unit in the last place of the map's size apart at most: both sides
round col + 0.5 + dx to f32, with dx quantized on one side only.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hessgpu_tpu.ops import compaction as jcomp
from hessgpu_tpu.ops.keypoint import KeypointMaps as JMaps
from hessgpu_tpu_torch.ops import compaction as tcomp
from hessgpu_tpu_torch.ops.keypoint import KeypointMaps as TMaps

SIGMAS = [2.0159, 2.5398, 3.2]
STEP = 2.0 ** (1.0 / 3.0)


def _maps(rng, shape, density):
    """Random dense maps as the detector leaves them: NMS-like spacing is
    not needed for compaction; offsets in (-1, 1); fp16-exact responses."""
    valid = rng.rand(*shape) < density
    f = lambda: (rng.rand(*shape).astype(np.float32) * 1.9 - 0.95)
    resp = (rng.randn(*shape).astype(np.float32) * 0.05) \
        .astype(np.float16).astype(np.float32)
    ftype = np.where(valid, rng.randint(0, 3, shape), 3).astype(np.int32)
    return dict(valid=valid, response=np.where(valid, resp, 0).astype(np.float32),
                dx=f(), dy=f(), ds=f(), ftype=ftype)


def _jax_list(m, cap):
    jm = JMaps(**{k: jnp.asarray(v) for k, v in m.items()})
    fl = jcomp.compact_octave_keypoints(jm, SIGMAS, STEP, cap)
    return {f: np.asarray(getattr(fl, f)) for f in fl._fields}


def _torch_list(m, cap):
    tm = TMaps(**{k: torch.from_numpy(v) for k, v in m.items()})
    fl = tcomp.compact_octave_keypoints(tm, SIGMAS, STEP, cap)
    return {f: getattr(fl, f).numpy() for f in fl._fields}


def _assert_lists_agree(got, want, atol_xy=4e-5):
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["ftype"], want["ftype"])
    np.testing.assert_array_equal(got["response"], want["response"])
    np.testing.assert_array_equal(got["theta"], want["theta"])
    for f, atol in (("x", atol_xy), ("y", atol_xy), ("sigma", 4e-5)):
        np.testing.assert_allclose(got[f], want[f], atol=atol, rtol=0,
                                   err_msg=f)
    # same cells: the integer part of x/y is the column/row
    np.testing.assert_array_equal(np.floor(got["x"] - 0.5 + 0.96),
                                  np.floor(want["x"] - 0.5 + 0.96))


@pytest.mark.parametrize("shape,density,cap", [
    ((3, 40, 56), 0.01, 64),      # under the cap
    ((3, 40, 56), 0.05, 32),      # overflow: raster-order truncation
    ((3, 33, 47), 0.02, 2048),    # cap larger than the map holds
    ((3, 24, 24), 0.0, 32),       # nothing valid
], ids=["under", "overflow", "bigcap", "empty"])
def test_compact_octave_matches_jax(shape, density, cap):
    m = _maps(np.random.RandomState(11), shape, density)
    got, want = _torch_list(m, cap), _jax_list(m, cap)
    for f in got:
        assert got[f].shape == (shape[0], cap), f
    _assert_lists_agree(got, want)


def _flooded(rng, shape, rows, step):
    """_maps at 1% density with every `step`-th column valid in `rows` of
    every key level (and batch item): rows denser than the per-row cap."""
    m = _maps(rng, shape, 0.01)
    for r in rows:
        m["valid"][..., r, ::step] = True
    m["ftype"] = np.where(m["valid"], m["ftype"] % 3, 3).astype(np.int32)
    resp = (m["response"] + 0.25).astype(np.float16).astype(np.float32)
    m["response"] = np.where(m["valid"], resp, 0).astype(np.float32)
    return m


@pytest.mark.parametrize("shape,rows,step,cap,kpr", [
    ((2, 3, 48, 640), (5, 6, 30), 4, 1536, 32),    # 160 a row, cap 32
    ((2, 3, 32, 2048), (0, 17), 4, 1536, 64),      # 512 a row, cap 64
    ((2, 3, 20, 40), (3, 19), 1, 256, 32),         # 40 a row, cap 32 < w
    ((2, 3, 20, 24), (0, 9, 10), 1, 256, 24),      # cap = w: no cap
    ((2, 3, 48, 640), (2, 3, 4, 40), 2, 100, 32),  # the level cap binds too
], ids=["w640", "w2048", "w40", "w24", "capacity-binds"])
def test_row_cap_matches_jax(shape, rows, step, cap, kpr):
    """The per-row candidate cap: the leftmost kpr valid cells of a row are
    kept, then the first `cap` in raster order, as in the JAX package."""
    m = _flooded(np.random.RandomState(16), shape, rows, step)
    per_row = m["valid"].sum(-1)
    assert tcomp._row_cap(shape[-1]) == kpr or kpr == shape[-1]
    assert min(shape[-1], tcomp._row_cap(shape[-1])) == kpr
    assert (per_row[..., rows] > kpr).all() or kpr == shape[-1]
    got = _torch_list(m, cap)
    for b in range(shape[0]):
        want = _jax_list({k: v[b] for k, v in m.items()}, cap)
        _assert_lists_agree({f: got[f][b] for f in got}, want,
                            atol_xy=4e-5 + float(np.spacing(
                                np.float32(max(shape[-2:])))))
        # against numpy: the leftmost kpr of each row, then the first cap
        cells = [(r, c) for r in range(shape[-2])
                 for c in np.flatnonzero(m["valid"][b, 0, r])[:kpr]][:cap]
        n = got["valid"][b, 0].sum()
        assert n == len(cells)
        r, c = np.array(cells, dtype=int).reshape(-1, 2).T
        np.testing.assert_allclose(got["x"][b, 0, :n],
                                   c + 0.5 + m["dx"][b, 0][r, c], atol=1e-6)
        np.testing.assert_allclose(got["y"][b, 0, :n],
                                   r + 0.5 + m["dy"][b, 0][r, c], atol=1e-6)
    if cap == 100:
        assert (got["valid"].sum(-1) == cap).all()
        assert (per_row.clip(max=kpr).sum(-1) > cap).all()


def test_row_cap_equals_the_jax_package():
    """The port keeps its own copy of the cap; it equals the JAX value."""
    for w in range(1, 4097):
        assert tcomp._row_cap(w) == jcomp._row_cap(w), w


def test_raster_order_overflow_and_zero_tail():
    """Against numpy directly: slot j of level k is the j-th valid cell of
    that level in raster order; past count everything is zero."""
    shape, cap = (2, 3, 20, 30), 16
    m = _maps(np.random.RandomState(12), shape, 0.06)
    got = _torch_list(m, cap)
    for b in range(shape[0]):
        for k in range(shape[1]):
            rows, cols = np.nonzero(m["valid"][b, k])
            n = min(len(rows), cap)
            assert len(rows) > cap          # the case really overflows
            assert got["valid"][b, k].sum() == n
            want_x = cols[:n] + 0.5 + m["dx"][b, k][rows[:n], cols[:n]]
            want_y = rows[:n] + 0.5 + m["dy"][b, k][rows[:n], cols[:n]]
            np.testing.assert_allclose(got["x"][b, k, :n], want_x, atol=1e-6)
            np.testing.assert_allclose(got["y"][b, k, :n], want_y, atol=1e-6)
            want_s = SIGMAS[k] * STEP ** m["ds"][b, k][rows[:n], cols[:n]]
            np.testing.assert_allclose(got["sigma"][b, k, :n], want_s,
                                       rtol=1e-6)
            for f in got:
                assert not got[f][b, k, n:].any(), f


def test_batched_equals_per_image():
    shape = (4, 3, 32, 40)
    m = _maps(np.random.RandomState(13), shape, 0.03)
    both = _torch_list(m, 24)
    for b in range(shape[0]):
        one = _torch_list({k: v[b] for k, v in m.items()}, 24)
        want = _jax_list({k: v[b] for k, v in m.items()}, 24)
        for f in both:
            np.testing.assert_array_equal(both[f][b], one[f], err_msg=f)
        _assert_lists_agree(one, want)


def test_compact_level_is_one_row_of_the_octave():
    m = _maps(np.random.RandomState(14), (3, 28, 36), 0.03)
    tm = TMaps(**{k: torch.from_numpy(v) for k, v in m.items()})
    octave = tcomp.compact_octave_keypoints(tm, SIGMAS, STEP, 20)
    for k in range(3):
        level = tcomp.compact_level_keypoints(
            TMaps(*(a[k] for a in tm)), SIGMAS[k], STEP, 20)
        for f in level._fields:
            assert torch.equal(getattr(level, f), getattr(octave, f)[k]), f


@pytest.mark.parametrize("n,cap", [(50, 8), (50, 50), (10, 32)])
def test_compact_sorted_matches_jax(n, cap):
    rng = np.random.RandomState(15)
    valid = rng.rand(3, n) < 0.4
    vals = [rng.rand(3, n).astype(np.float32),
            rng.randint(0, 100, (3, n)).astype(np.int32)]
    cj, oj, sj = jcomp.compact_sorted(jnp.asarray(valid),
                                      [jnp.asarray(v) for v in vals], cap)
    ct, ot, st = tcomp.compact_sorted(torch.from_numpy(valid),
                                      [torch.from_numpy(v) for v in vals],
                                      cap)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    for a, b in zip(ot, oj):
        assert a.shape == (3, cap)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
