"""The fused octave-chain kernel's tiling, modelled in plain torch on the CPU.

csrc/conv.cu chain_kernel computes all levels of an octave in one launch: a
block stages its output tile grown by the chain's cumulative halo and cut to
the image, then runs the levels in place, level l+1 over the tile grown by
the halo the later levels still need (again cut to the image), every pass
reading through an index clamped to the region the block holds. A chain that
does not fit runs in groups of consecutive levels, the last level of a group
being the next group's base. A CUDA kernel cannot run here, so `_model_chain`
below repeats that structure - regions, clamps, origins, the centre that is
kept - with the kernel's arithmetic (acc = t[0]*x[0]; acc = acc + t[k]*x[k]).

Tolerance: none. The model must equal octave_chain_plain (chained
clamp-to-edge blurs) bit for bit for every tile, at corners and edges, for
an image smaller than the halo, odd shapes, identity transitions and any
split into groups.

What this file checks is the design, not the kernel: that such a tiling can
equal the plain chain at all, and what the plain chain's borders are (the
per-level clamp). The model is kept in step with conv.cu by hand, so no edit
of the CUDA source can fail a test here; the kernel itself is held against
octave_chain_plain on a GPU by tests/test_torch_cuda_kernels.py (marker
`gpu`) and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from hessgpu_tpu_torch.ops import gaussian as tgauss
from hessgpu_tpu_torch.ops.cuda import conv as kconv
from hessgpu_tpu_torch.params import ScaleSpaceParams, gaussian_taps


def _taps(detector):
    return [tgauss.taps_f32(t) for t in
            tgauss.chain_taps(ScaleSpaceParams(detector=detector))]


def _pass(buf, taps, idx, axis):
    """acc = t[0]*x[idx[0]]; acc = acc + t[k]*x[idx[k]] along `axis`;
    idx: (taps, outputs) positions in buf."""
    acc = float(taps[0]) * buf.index_select(axis, idx[0])
    for k in range(1, len(taps)):
        acc = acc + float(taps[k]) * buf.index_select(axis, idx[k])
    return acc


def _model_group(base, taps_list, th, tw):
    """Levels 1..n of one launch, tile by tile. base (B, H, W)."""
    B, H, W = base.shape
    nt = len(taps_list)
    rem = [0] * (nt + 1)
    for l in range(nt - 1, -1, -1):
        rem[l] = rem[l + 1] + len(taps_list[l]) // 2
    out = torch.full((B, nt, H, W), float("nan"))
    for row0 in range(0, H, th):
        for col0 in range(0, W, tw):
            ty1, tx1 = min(row0 + th, H), min(col0 + tw, W)
            y0, y1 = max(0, row0 - rem[0]), min(H, row0 + th + rem[0])
            x0, x1 = max(0, col0 - rem[0]), min(W, col0 + tw + rem[0])
            oy, ox = y0, x0
            a = base[:, y0:y1, x0:x1].clone()        # buffer A, origin (oy, ox)
            for l, taps in enumerate(taps_list):
                if len(taps) == 0:                   # identity: A stays
                    out[:, l, row0:ty1, col0:tx1] = \
                        a[:, row0 - oy:ty1 - oy, col0 - ox:tx1 - ox]
                    continue
                r = len(taps) // 2
                Y0, Y1 = max(0, row0 - rem[l + 1]), \
                    min(H, row0 + th + rem[l + 1])
                X0, X1 = max(0, col0 - rem[l + 1]), \
                    min(W, col0 + tw + rem[l + 1])
                k = torch.arange(len(taps))[:, None]
                # horizontal: rows [y0, y1), columns [X0, X1); reads clamp to
                # the columns [x0, x1) that A holds
                cols = (torch.arange(X0, X1)[None] - r + k).clamp(x0, x1 - 1)
                b = _pass(a[:, y0 - oy:y1 - oy], taps, cols - ox, 2)
                # vertical: rows [Y0, Y1) out of b's rows [y0, y1)
                rows = (torch.arange(Y0, Y1)[None] - r + k).clamp(y0, y1 - 1)
                v = _pass(b, taps, rows - y0, 1)
                # in place: only the new level's region is valid afterwards
                a = torch.full_like(a, float("nan"))
                a[:, Y0 - oy:Y1 - oy, X0 - ox:X1 - ox] = v
                out[:, l, row0:ty1, col0:tx1] = \
                    v[:, row0 - Y0:ty1 - Y0, col0 - X0:tx1 - X0]
                y0, y1, x0, x1 = Y0, Y1, X0, X1
    return out


def _model_chain(base, taps_list, th, tw, groups=None):
    """(B, 1 + len(taps_list), H, W); groups: sizes of the launches."""
    groups = groups or [len(taps_list)]
    assert sum(groups) == len(taps_list)
    levels, l0 = [base[:, None]], 0
    for n in groups:
        src = levels[-1][:, -1]          # read back from the output stack
        levels.append(_model_group(src, taps_list[l0:l0 + n], th, tw))
        l0 += n
    return torch.cat(levels, dim=1)


def _planes(shape, seed):
    return torch.from_numpy(
        np.random.RandomState(seed).rand(*shape).astype(np.float32))


def _same(a, b):
    return a.shape == b.shape and bool((a == b).all())


@pytest.mark.parametrize("detector", ["hessian", "dog"])
@pytest.mark.parametrize("shape,tile", [
    ((2, 30, 40), (64, 128)),     # smaller than the halo, one tile
    ((2, 30, 40), (16, 32)),      # smaller than the halo, 2 x 2 tiles
    ((1, 101, 75), (32, 32)),     # odd shape, ragged last tiles
    ((1, 101, 75), (48, 64)),
    ((1, 130, 170), (32, 64)),    # corners, edges and one interior tile
], ids=str)
def test_tiled_chain_equals_plain(detector, shape, tile):
    x = _planes(shape, 11)
    taps = _taps(detector)
    want = kconv.octave_chain_plain(x, taps)
    got = _model_chain(x, taps, *tile)
    assert not bool(got.isnan().any())
    assert _same(got, want)


@pytest.mark.parametrize("groups", [[1, 3], [2, 2], [3, 1], [1, 1, 1, 1]],
                         ids=str)
def test_chain_split_into_groups_equals_plain(groups):
    x = _planes((1, 101, 75), 12)
    taps = _taps("hessian")
    assert _same(_model_chain(x, taps, 32, 32, groups),
                 kconv.octave_chain_plain(x, taps))


@pytest.mark.parametrize("where", [0, 1, 3], ids=["first", "middle", "last"])
def test_identity_transition_in_the_tiled_chain(where):
    x = _planes((2, 50, 70), 13)
    taps = _taps("hessian")[:3]
    taps.insert(where, np.zeros(0, np.float32))
    want = kconv.octave_chain_plain(x, taps)
    got = _model_chain(x, taps, 16, 32)
    assert _same(got, want)
    assert _same(got[:, where + 1], got[:, where])


def test_widest_taps_in_groups():
    """Four 33-tap transitions (cumulative halo 64) in groups of two."""
    x = _planes((1, 70, 90), 14)
    taps = [tgauss.taps_f32(gaussian_taps(5.0))] * 4
    assert len(taps[0]) == 33
    assert _same(_model_chain(x, taps, 32, 32, [2, 2]),
                 kconv.octave_chain_plain(x, taps))


def test_per_level_clamp_is_not_an_extended_blur():
    """What the per-level clamp guards against: blurring a base extended by
    the cumulative halo once, without re-clamping each level, gives other
    border pixels from the second level on."""
    x = _planes((1, 40, 50), 15)
    taps = _taps("hessian")
    want = kconv.octave_chain_plain(x, taps)
    R = sum(len(t) // 2 for t in taps)
    iy = torch.arange(-R, 40 + R).clamp(0, 39)
    ix = torch.arange(-R, 50 + R).clamp(0, 49)
    ext = x[:, iy][:, :, ix]
    wrong = kconv.octave_chain_plain(ext, taps)[:, :, R:-R, R:-R]
    assert _same(wrong[:, 1], want[:, 1])
    assert not _same(wrong[:, 2], want[:, 2])
