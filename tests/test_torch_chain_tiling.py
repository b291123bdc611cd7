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

The decimation epilogue (chain_decimate) is modelled too: the launch that
computes level `dec` writes next[y, x] = level[2y, 2x], y < H // 2,
x < W // 2, tile by tile, each block the kept pixels of its own output tile,
read from buffer A - which holds a level only where the kernel keeps it
(every level but a launch's last, and the decimated one). Each kept pixel
must be written exactly once, and the plane must equal
downsample2_plain(octave_chain_plain(base)[:, dec])[..., :H // 2, :W // 2].

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


def _model_group(base, taps_list, th, tw, dec=-1, next_base=None, writes=None,
                 keep_decimated=True):
    """Levels 1..n of one launch, tile by tile. base (B, H, W). dec >= 0:
    level dec of the group (0 = its base) is also decimated into next_base
    (B, H // 2, W // 2), each write counted in `writes`. keep_decimated=False
    models A kept for the next transition only."""
    B, H, W = base.shape
    nt = len(taps_list)
    rem = [0] * (nt + 1)
    for l in range(nt - 1, -1, -1):
        rem[l] = rem[l + 1] + len(taps_list[l]) // 2
    out = torch.full((B, nt, H, W), float("nan"))
    oh, ow = H // 2, W // 2

    def decimate(a, row0, ty1, col0, tx1, oy, ox):
        """chain_decimate: the kept pixels (2y, 2x) of the tile, from A."""
        for y in range(row0 // 2, min((ty1 + 1) // 2, oh)):
            for x in range(col0 // 2, min((tx1 + 1) // 2, ow)):
                next_base[:, y, x] = a[:, 2 * y - oy, 2 * x - ox]
                writes[:, y, x] += 1

    for row0 in range(0, H, th):
        for col0 in range(0, W, tw):
            assert row0 % 2 == 0 and col0 % 2 == 0   # even tile origins
            ty1, tx1 = min(row0 + th, H), min(col0 + tw, W)
            y0, y1 = max(0, row0 - rem[0]), min(H, row0 + th + rem[0])
            x0, x1 = max(0, col0 - rem[0]), min(W, col0 + tw + rem[0])
            oy, ox = y0, x0
            a = base[:, y0:y1, x0:x1].clone()        # buffer A, origin (oy, ox)
            if dec == 0:
                decimate(a, row0, ty1, col0, tx1, oy, ox)
            for l, taps in enumerate(taps_list):
                if len(taps) == 0:                   # identity: A stays
                    out[:, l, row0:ty1, col0:tx1] = \
                        a[:, row0 - oy:ty1 - oy, col0 - ox:tx1 - ox]
                    if l + 1 == dec:
                        decimate(a, row0, ty1, col0, tx1, oy, ox)
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
                # in place: only the new level's region is valid afterwards;
                # a level that is not kept leaves no valid value in A
                a = torch.full_like(a, float("nan"))
                if l + 1 < nt or (keep_decimated and l + 1 == dec):
                    a[:, Y0 - oy:Y1 - oy, X0 - ox:X1 - ox] = v
                out[:, l, row0:ty1, col0:tx1] = \
                    v[:, row0 - Y0:ty1 - Y0, col0 - X0:tx1 - X0]
                if l + 1 == dec:
                    decimate(a, row0, ty1, col0, tx1, oy, ox)
                y0, y1, x0, x1 = Y0, Y1, X0, X1
    return out


def _group_dec(dec_level, l0, n):
    """The group-local level that the launch of transitions [l0, l0 + n)
    decimates (hg_octave_chain): the launch that computes the level,
    the first one for level 0; -1 for the others."""
    if dec_level == 0 and l0 == 0:
        return 0
    return dec_level - l0 if l0 < dec_level <= l0 + n else -1


def _model_chain(base, taps_list, th, tw, groups=None, dec_level=None,
                 keep_decimated=True):
    """(B, 1 + len(taps_list), H, W); groups: sizes of the launches. With
    dec_level, also (decimated plane, its write counts)."""
    groups = groups or [len(taps_list)]
    assert sum(groups) == len(taps_list)
    B, H, W = base.shape
    next_base = torch.full((B, H // 2, W // 2), float("nan"))
    writes = torch.zeros((B, H // 2, W // 2), dtype=torch.int32)
    levels, l0 = [base[:, None]], 0
    for n in groups:
        src = levels[-1][:, -1]          # read back from the output stack
        dec = -1 if dec_level is None else _group_dec(dec_level, l0, n)
        levels.append(_model_group(src, taps_list[l0:l0 + n], th, tw, dec,
                                   next_base, writes, keep_decimated))
        l0 += n
    stack = torch.cat(levels, dim=1)
    return stack if dec_level is None else (stack, next_base, writes)


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


# ---------------------------------------------------------------------------
# the decimation epilogue
# ---------------------------------------------------------------------------

K_TILE_H = [16, 32, 48, 64, 80, 96, 112, 128]        # conv.cu kTileH
K_TILE_W = [32, 64, 96, 128, 160, 192, 256]          # conv.cu kTileW


def _fits(shape, taps_list, th, tw):
    """plan_tile's rule: the two shared buffers of the whole chain in one
    launch fit 227 KB."""
    _, H, W = shape
    rem0 = sum(len(t) // 2 for t in taps_list)
    rem1 = rem0 - len(taps_list[0]) // 2
    rows0, cols0 = min(H, th + 2 * rem0), min(W, tw + 2 * rem0)
    cols1 = min(W, tw + 2 * rem1)
    return 4 * (rows0 * ((cols0 | 1) + (cols1 | 1)) + 8 * 33) <= 232448


def _lds(detector):
    p = ScaleSpaceParams(detector=detector)
    return p.level_ds - p.level_min


def _decimated(stack, level):
    """What both pyramids do: the plain decimation, cropped to the plan's
    floor-halved shape."""
    _, _, H, W = stack.shape
    return kconv.downsample2_plain(stack[:, level])[..., :H // 2, :W // 2]


def _check_epilogue(x, taps, tile, dec_level, groups=None):
    want = kconv.octave_chain_plain(x, taps)
    stack, nxt, writes = _model_chain(x, taps, *tile, groups, dec_level)
    assert _same(stack, want)
    assert bool((writes == 1).all()), writes.unique()
    assert _same(nxt, _decimated(want, dec_level))


ODD = (1, 97, 131)
TILES = [(th, tw) for th in K_TILE_H for tw in K_TILE_W]


@pytest.mark.parametrize("detector", ["hessian", "dog"])
@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_epilogue_every_tile(detector, tile):
    """Every tile of the kernel's list, at an odd shape: ragged tiles on
    both axes, an odd last row and column that no tile keeps."""
    taps = _taps(detector)
    assert _fits(ODD, taps, *tile)
    _check_epilogue(_planes(ODD, 21), taps, tile, _lds(detector))


@pytest.mark.parametrize("detector,level",
                         [("hessian", l) for l in range(5)]
                         + [("dog", l) for l in range(6)])
def test_epilogue_every_level(detector, level):
    """Any level decimated, the base (level 0, from the staged region) and
    the launch's last included; at some of them the halo left after the
    level (rem) is odd, so the region's first row is odd - the epilogue's
    rows follow the tile, not the region."""
    taps = _taps(detector)
    assert level <= len(taps)
    _check_epilogue(_planes((2, 50, 70), 22), taps, (16, 32), level)


def test_an_odd_halo_at_the_decimated_level():
    """The cases above hold one: a halo after the decimated level that is
    odd (Hessian, level 0: 5 + 6 + 8 + 10)."""
    taps = _taps("hessian")
    assert sum(len(t) // 2 for t in taps) % 2 == 1


@pytest.mark.parametrize("detector", ["hessian", "dog"])
@pytest.mark.parametrize("tile", [(64, 128), (16, 32)], ids=str)
def test_epilogue_smaller_than_the_halo(detector, tile):
    """30 x 40, the main path's last octave: every region is the image."""
    _check_epilogue(_planes((3, 30, 40), 23), _taps(detector), tile,
                    _lds(detector))


@pytest.mark.parametrize("groups", [[2, 2], [1, 3], [3, 1], [1, 1, 1, 1]],
                         ids=str)
@pytest.mark.parametrize("level", range(5), ids=lambda l: f"level{l}")
def test_epilogue_in_groups(groups, level):
    """Four 33-tap transitions in groups: the decimated level a group's
    base (decimated by the group before, whose last level it is), inside a
    later group, or the launch's last level."""
    x = _planes((1, 70, 90), 24)
    taps = [tgauss.taps_f32(gaussian_taps(5.0))] * 4
    _check_epilogue(x, taps, (32, 32), level, groups)


@pytest.mark.parametrize("where", [0, 1, 3], ids=["first", "middle", "last"])
def test_epilogue_of_an_identity_transition(where):
    """The level the identity transition produces, still in A."""
    taps = _taps("hessian")[:3]
    taps.insert(where, np.zeros(0, np.float32))
    _check_epilogue(_planes((2, 50, 70), 25), taps, (16, 32), where + 1)


def test_a_groups_last_level_must_be_kept_for_the_epilogue():
    """Why the kernel keeps the decimated level in A when it is a launch's
    last: kept for the next transition only, A holds no valid value there
    and the epilogue reads garbage."""
    x = _planes((1, 70, 90), 26)
    taps = [tgauss.taps_f32(gaussian_taps(5.0))] * 4
    _, nxt, _ = _model_chain(x, taps, 32, 32, [2, 2], 2,
                             keep_decimated=False)
    assert bool(nxt.isnan().all())
    _, nxt, _ = _model_chain(x, taps, 32, 32, [2, 2], 3,
                             keep_decimated=False)
    assert not bool(nxt.isnan().any())
