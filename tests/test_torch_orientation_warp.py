"""The orientation kernel's order, modelled in plain torch on the CPU.

csrc/patch.cu orientation_kernel gives a warp one valid slot at a time. Lane
l takes the pixels l, l + 32, ... of the support's bounding box in raster
order - its (row, col) stepped by 32 with one wrap, no division per pixel -
and adds each voting pixel's weight into its own column of a 36 x 32
histogram. Lanes 0..17 then hold bins 2l and 2l + 1: each bin's 32 columns
are summed as two chains of 16, columns l, l + 1, ... and l + 16, l + 17,
... mod 32, then the two halves. Six smoothing rounds take bin 2l - 1 from
lane l - 1 and bin 2l + 2 from lane l + 1 (lane 0 wraps to 17 and back),
((pre + cur) + nxt) / 3 per bin; half-SIFT adds lane l + 9's pair to lane
l's. Peaks are a butterfly over the 32 lanes of (vote, bin), taking the
other lane's pair when its vote is larger or equal with a lower bin.

A CUDA kernel cannot run here, so the functions below repeat that order
with the kernel's arithmetic. Tolerance: none where the order is the
kernel's own - smoothing, fold and peaks must equal ops.orientation's
_smooth6 + peaks_from_votes bit for bit (NaN where they give NaN), on
histograms built to be adversarial: equal votes in two or more bins,
plateaus, peaks at bins 0 and 35, an all-zero histogram. The walk must
count exactly the voting pixels of _histogram36 (seeded tables, keypoints at
the level border, a large sigma such as describe_keypoints meets); its
votes, summed in another order than torch.sum, stay within VOTE_TOL of the
keypoint's largest bin, the tolerance the card holds the kernel to.

What this file checks is the design, not the kernel: the model is kept in
step with patch.cu by hand, so no edit of the CUDA source can fail a test
here. The kernel itself is held against orientation_plain on a GPU by
tests/test_torch_cuda_kernels.py (marker `gpu`) and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from hessgpu_tpu_torch.convert import level_maps_from_numpy
from hessgpu_tpu_torch.ops import orientation as tori
from hessgpu_tpu_torch.ops.cuda import patch

LANES, BINS, PAIRS = 32, 36, 18     # a warp; kBins, kPairs in csrc/patch.cu
VOTE_TOL = 2e-5
F = np.float32
MODES = [dict(single=True), dict(max_peaks=1), dict(max_peaks=2),
         dict(max_peaks=3), dict(max_peaks=4),
         dict(max_peaks=2, half_sift=True),
         dict(single=True, half_sift=True)]
MODE_IDS = ["single", "m1", "m2", "m3", "m4", "m2-half", "single-half"]


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


# ---- the walk ----------------------------------------------------------------

def _steps(nx, npx):
    """(row, col) of every lane in every round, as the kernel steps them:
    one division a slot, then += (32 // nx, 32 % nx) with one wrap."""
    drow, dcol = LANES // nx, LANES - (LANES // nx) * nx
    lane = np.arange(LANES)
    row, col = lane // nx, lane - (lane // nx) * nx
    out = []
    for _ in range(0, npx, LANES):
        out.append((row.copy(), col.copy()))
        row, col = row + drow, col + dcol
        wrap = col >= nx
        col, row = np.where(wrap, col - nx, col), np.where(wrap, row + 1, row)
    return out


def _model_histogram(grad, rot, kx, ky, sigma, gf=1.5, wf=2.0):
    """One keypoint's 36 bins the way the kernel sums them, and the number
    of pixels that voted. grad, rot: (H, W) float32 maps of its level."""
    H, W = grad.shape
    kx, ky, sg = F(kx), F(ky), F(sigma)
    win = F(np.abs(sg) * F(gf * wf))
    gsigma = F(sg * F(gf))
    dist_threshold = F(F(win * win) + F(0.5))
    factor = F(F(-0.5) / F(gsigma * gsigma))
    ix0 = int(max(F(1.0), np.floor(F(kx - win))))
    ix1 = int(min(F(W) - F(2.0), np.floor(F(kx + win))))
    iy0 = int(max(F(1.0), np.floor(F(ky - win))))
    iy1 = int(min(F(H) - F(2.0), np.floor(F(ky + win))))
    nx, ny = ix1 - ix0 + 1, iy1 - iy0 + 1
    npx = nx * ny if nx > 0 and ny > 0 else 0
    cols = np.zeros((BINS, LANES), F)
    count = 0
    lanes = np.arange(LANES)
    for row, col in _steps(max(nx, 1), npx):
        live = row < ny
        iy, ix = iy0 + row[live], ix0 + col[live]
        dx = (ix.astype(F) + F(0.5)) - kx
        dy = (iy.astype(F) + F(0.5)) - ky
        sq = dx * dx + dy * dy
        vote = sq < dist_threshold
        iy, ix, sq, lane = iy[vote], ix[vote], sq[vote], lanes[live][vote]
        count += int(vote.sum())
        ob = np.floor(rot[iy, ix] * F(tori.BINS_PER_RADIAN)).astype(np.int32)
        ob = np.clip(np.where(ob < 0, ob + BINS, ob), 0, BINS - 1)
        w = grad[iy, ix] * torch.exp(torch.from_numpy(sq * factor)).numpy()
        cols[ob, lane] = cols[ob, lane] + w    # one address per lane
    return _merge(cols), count


def _merge(cols):
    """(36, 32) lane columns -> (36,) bins: lane b // 2's two chains."""
    out = np.zeros(BINS, F)
    for b in range(BINS):
        l = b // 2
        a, c = cols[b, l], cols[b, (l + 16) & 31]
        for s in range(1, 16):
            a = F(a + cols[b, (l + s) & 31])
            c = F(c + cols[b, (l + 16 + s) & 31])
        out[b] = F(a + c)
    return out


# ---- smoothing, fold and peaks across the lanes ------------------------------

def _model_smooth(votes, half_sift):
    """(K, 36) raw histograms -> smoothed (and folded), pair layout."""
    lo, hi = votes[:, 0::2], votes[:, 1::2]
    prv = (torch.arange(PAIRS) + PAIRS - 1) % PAIRS
    nxl = (torch.arange(PAIRS) + 1) % PAIRS
    three = _f32(3.0)
    for _ in range(6):
        pre, nxt = hi[:, prv], lo[:, nxl]
        lo, hi = ((pre + lo) + hi) / three, ((lo + hi) + nxt) / three
    if half_sift:
        h = PAIRS // 2
        lo = torch.cat([lo[:, :h] + lo[:, h:], torch.zeros_like(lo[:, h:])], 1)
        hi = torch.cat([hi[:, :h] + hi[:, h:], torch.zeros_like(hi[:, h:])], 1)
    return torch.stack([lo, hi], -1).reshape(votes.shape)


def _warp_best(v, b):
    """The butterfly of warp_best over (K, 32) lanes; every lane must end
    with the same (vote, bin)."""
    lane = torch.arange(LANES)
    for off in (16, 8, 4, 2, 1):
        ov, ob = v[:, lane ^ off], b[:, lane ^ off]
        take = (ov > v) | ((ov == v) & (ob < b))
        v, b = torch.where(take, ov, v), torch.where(take, ob, b)
    assert bool((v == v[:, :1]).all() | v.isnan().all()) \
        and bool((b == b[:, :1]).all())
    return v[:, 0], b[:, 0]


def _lanes(votes):
    """Smoothed (K, 36) -> each lane's (lo, hi), lanes 18..31 holding 0."""
    K = votes.shape[0]
    lo = torch.zeros(K, LANES)
    hi = torch.zeros(K, LANES)
    lo[:, :PAIRS], hi[:, :PAIRS] = votes[:, 0::2], votes[:, 1::2]
    return lo, hi


def _model_peaks(votes, single=False, max_peaks=4, peak_threshold=0.8):
    """Thetas (K, 4) and valid (K, 4) the way the kernel picks them."""
    K = votes.shape[0]
    lane = torch.arange(LANES)
    inl = (lane < PAIRS).expand(K, -1)
    neg = torch.tensor(float("-inf"))
    lo, hi = _lanes(votes)
    v = torch.where(inl, lo, neg)
    b = (2 * lane).expand(K, -1)
    up = inl & (hi > lo)
    vmax, imax = _warp_best(torch.where(up, hi, v),
                            torch.where(up, b + 1, b))
    at = lambda i: votes.gather(1, (i % BINS)[:, None])[:, 0]
    thetas = torch.zeros(K, 4)
    valid = torch.zeros(K, 4, dtype=torch.bool)
    if single or max_peaks <= 1:       # the wrapper's rule
        pre, nxt = at(imax + BINS - 1), at(imax + 1)
        off = 0.5 * (nxt - pre) / (vmax + vmax - nxt - pre)
        thetas[:, 0] = ((imax.float() + 0.5) + off) \
            / _f32(tori.BINS_PER_RADIAN)
        valid[:, 0] = True
        return thetas, valid
    thr = _f32(peak_threshold) * vmax
    prv = (lane + PAIRS - 1) % PAIRS
    nxl = (lane + 1) % PAIRS
    pre, nxt = hi[:, prv], lo[:, nxl]
    t = thr[:, None]
    pk_lo = inl & (lo > t) & (lo > pre) & (lo > hi)
    pk_hi = inl & (hi > t) & (hi > lo) & (hi > nxt)
    done = torch.zeros(K, dtype=torch.bool)
    for s in range(min(4, max_peaks)):
        best = torch.where(pk_lo, lo, neg)
        bi = b.clone()
        up = pk_hi & (hi > best)
        best, bi = _warp_best(torch.where(up, hi, best),
                              torch.where(up, bi + 1, bi))
        done |= best == neg
        pk_lo &= bi[:, None] != b
        pk_hi &= bi[:, None] != b + 1
        bp, bn = at(bi + BINS - 1), at(bi + 1)
        di = 0.5 * (bn - bp) / (best + best - bn - bp)
        rotb = (bi.float() + di) + 0.5
        frac = rotb / _f32(36.0)
        frac = torch.where(frac < 0, frac + 1.0, frac)
        q = torch.floor(frac * 255.0) * _f32(tori.TWO_PI / 255.0)
        thetas[:, s] = torch.where(done, 0.0, q)
        valid[:, s] = ~done
    return thetas, valid


def _plain_smooth(votes, half_sift):
    v = tori._smooth6(votes)
    if half_sift:
        v = torch.cat([v[:, :18] + v[:, 18:], torch.zeros_like(v[:, 18:])], 1)
    return v


def _same(a, b):
    return a.shape == b.shape and bool(
        ((a == b) | (a.isnan() & b.isnan())).all())


# ---- adversarial histograms ------------------------------------------------

def _raw_histograms():
    """Raw (pre-smoothing) histograms by kind. Deltas 13 or more bins apart
    smooth to the same bits (six rounds spread one by six bins)."""
    rng = np.random.RandomState(17)
    z = lambda: np.zeros(BINS, F)
    kinds = {}
    kinds["random"] = rng.rand(8, BINS).astype(F)
    two = z(); two[[3, 20]] = 1.0
    three = z(); three[[0, 12, 24]] = 0.7
    edges = z(); edges[0], edges[35] = 1.0, 0.9
    edge35 = z(); edge35[35], edge35[17] = 1.0, 0.95
    kinds["equal"] = np.stack([two, three])
    kinds["edges"] = np.stack([edges, edge35])
    kinds["constant"] = np.full((2, BINS), 0.25, F)
    kinds["zero"] = np.zeros((1, BINS), F)
    p2 = z(); p2[[10, 11]] = 1.0; p2[[28, 29]] = 1.0
    p5 = z(); p5[10:15] = 0.5; p5[30:35] = 0.5
    kinds["plateau"] = np.stack([p2, p5])
    five = z(); five[[2, 9, 16, 23, 30]] = [1.0, 0.98, 0.96, 0.94, 0.92]
    low = z(); low[[5, 25]] = [1.0, 0.5]
    kinds["many"] = np.stack([five, low])
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in kinds.items()}


RAW = _raw_histograms()


def _crafted_votes():
    """Smoothed-looking votes built for the peak picker: exact ties, a
    plateau of two (no strict maximum), peaks at bins 0 and 35 (their
    neighbours wrap), a peak exactly at 0.8 * max, five peaks, all zero."""
    v = np.zeros((9, BINS), F)
    v[0, [4, 22]] = 1.0; v[0, [3, 5, 21, 23]] = 0.5           # equal peaks
    v[1, [7, 19, 31]] = 0.6; v[1, [6, 8, 18, 20, 30, 32]] = 0.1
    v[2, [10, 11]] = 1.0; v[2, [9, 12]] = 0.2; v[2, 30] = 0.9  # plateau
    v[3, 0], v[3, 35], v[3, 1] = 1.0, 0.3, 0.4                # peak at 0
    v[4, 35], v[4, 0], v[4, 34] = 1.0, 0.2, 0.6               # peak at 35
    v[5, 6] = 1.0
    v[5, 20] = F(F(0.8) * F(1.0))                             # at threshold
    v[5, 28] = np.nextafter(F(F(0.8) * F(1.0)), F(1.0))       # just above
    v[6, [1, 8, 15, 22, 29]] = [0.9, 1.0, 0.95, 1.0, 0.85]    # five peaks
    v[7] = 0.3                                                # flat
    return torch.from_numpy(v)                                # row 8: zeros


# ---- tests -----------------------------------------------------------------

@pytest.mark.parametrize("nx", [1, 2, 3, 5, 7, 13, 31, 32, 33, 47, 64, 101])
def test_row_col_stepping_is_raster_order(nx):
    """The stepping without division puts lane l of round t on the box's
    pixel 32 t + l, for every row width."""
    ny = 5
    for t, (row, col) in enumerate(_steps(nx, nx * ny)):
        p = 32 * t + np.arange(LANES)
        assert (row == p // nx).all() and (col == p % nx).all()


def test_merge_reads_distinct_banks():
    """At every step of the merge the 18 lanes read 18 banks (bin b of
    column c lies at b * 32 + c), in each of the two chains."""
    lane = np.arange(PAIRS)
    for s in range(16):
        for e in (0, 1):
            for start in (0, 16):
                addr = (2 * lane + e) * 32 + ((lane + start + s) & 31)
                assert len(set(addr % 32)) == PAIRS


@pytest.mark.parametrize("half_sift", [False, True], ids=["full", "half"])
@pytest.mark.parametrize("kind", list(RAW))
def test_smoothing_equals_smooth6(kind, half_sift):
    votes = RAW[kind]
    assert _same(_model_smooth(votes, half_sift),
                 _plain_smooth(votes, half_sift))


@pytest.mark.parametrize("mode", MODES[:5], ids=MODE_IDS[:5])
def test_peaks_equal_peaks_from_votes(mode):
    votes = _crafted_votes()
    th, ov = _model_peaks(votes, **mode)
    want_th, want_ov = tori.peaks_from_votes(votes, **mode)
    assert _same(th, want_th) and torch.equal(ov, want_ov)
    if not (mode.get("single") or mode["max_peaks"] <= 1):
        # ties to the lower bin; no strict maximum, no orientation
        assert ov.sum(1).tolist()[7:] == [0, 0]
        assert th[0, 0] < th[0, 1]
    else:
        assert bool(th[8, 0].isnan())          # all zero: 0 / 0


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_model_equals_plain_on_adversarial_histograms(mode):
    """Smoothing, fold and peaks together, from raw histograms of every
    kind, against _smooth6 (+ fold) + peaks_from_votes."""
    raw = torch.cat(list(RAW.values()))
    half = mode.get("half_sift", False)
    peak_mode = {k: v for k, v in mode.items() if k != "half_sift"}
    got = _model_smooth(raw, half)
    want = _plain_smooth(raw, half)
    assert _same(got, want)
    th, ov = _model_peaks(got, **peak_mode)
    want_th, want_ov = tori.peaks_from_votes(want, **peak_mode)
    assert _same(th, want_th) and torch.equal(ov, want_ov)


def _level_scene(seed, shape, n, place, sigma):
    """One level of seeded maps and n keypoints: `place` "interior",
    "border" (within 2 px of an edge, or beyond it) or "outside"."""
    rng = np.random.RandomState(seed)
    H, W = shape
    grad = rng.rand(H, W).astype(F)
    rot = ((rng.rand(H, W) * 2 - 1) * np.pi).astype(F)
    if place == "interior":
        kx = rng.rand(n) * (W - 2) + 1
        ky = rng.rand(n) * (H - 2) + 1
    elif place == "border":
        side = rng.randint(0, 4, n)
        kx = np.where(side == 0, rng.rand(n) * 2.5,
                      np.where(side == 1, W - rng.rand(n) * 3,
                               rng.rand(n) * W))
        ky = np.where(side == 2, rng.rand(n) * 2.5,
                      np.where(side == 3, H - rng.rand(n) * 3,
                               rng.rand(n) * H))
    else:
        kx = W + 5 + rng.rand(n) * 40
        ky = rng.rand(n) * H
    ks = sigma[0] + (sigma[1] - sigma[0]) * rng.rand(n)
    return grad, rot, kx.astype(F), ky.astype(F), ks.astype(F)


@pytest.mark.parametrize("case", [
    (3, (48, 64), 12, "interior", (1.6, 3.2)),
    (4, (40, 56), 12, "interior", (0.4, 1.6)),   # boxes narrower than a warp
    (5, (48, 64), 16, "border", (1.6, 3.2)),
    (6, (30, 40), 8, "border", (4.0, 8.0)),      # the clamp on both sides
    (7, (130, 150), 4, "interior", (15.0, 19.0)),   # ~10^4 pixels a box
    (8, (40, 56), 4, "outside", (1.6, 3.2)),     # an empty box
], ids=["interior", "small-sigma", "border", "border-wide", "large-sigma",
        "outside"])
def test_walk_counts_the_plain_pixels(case):
    seed, shape, n, place, sigma = case
    grad, rot, kx, ky, ks = _level_scene(seed, shape, n, place, sigma)
    maps = level_maps_from_numpy([grad], [rot])
    row = lambda a: torch.from_numpy(np.ascontiguousarray(a))[None]
    wsize = 2 * int(np.ceil(float(ks.max()) * 3.0 + 1.0)) + 1
    want = patch.orientation_plain(row(kx), row(ky), row(ks),
                                   torch.ones((1, n), dtype=torch.bool),
                                   torch.zeros((1, n), dtype=torch.int32),
                                   maps, wsize)
    hists, counts = zip(*(_model_histogram(grad, rot, x, y, s)
                          for x, y, s in zip(kx, ky, ks)))
    assert list(counts) == want.support[0].tolist()
    if place == "outside":
        assert sum(counts) == 0
        return
    assert min(counts) > 0
    if place == "interior" and sigma[0] > 10:
        assert min(counts) > 2000
    got = tori._smooth6(torch.from_numpy(np.stack(hists)))
    scale = want.votes[0].amax(-1, keepdim=True)
    assert float(((got - want.votes[0]).abs() / scale).max()) <= VOTE_TOL
