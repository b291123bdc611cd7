"""GENERATE_FEATURE_LIST: the wrapper's CPU route, and the feature-list
kernels' design modelled on the CPU.

ops/cuda/compact.py's compact_octave and feature_table return, for CPU
tensors, exactly what ops/compaction.py's compact_octave_keypoints and
_globalize return (with the level counts and the count that
pyramid.detect_from_octaves reports), and launch nothing.

csrc/compact.cu makes the global table in three kernels: capped counts of
each row's valid bytes, read as 16-byte aligned chunks with the bytes outside
the row masked off (a row starts anywhere); a scan of each level's rows into
row offsets and the level's count; and a scatter in which a row's first n
set bytes go to slots (counts of the earlier levels) + (row offset) + rank,
n = min(count, level count - offset, G - earlier - offset), with the slots
past a frame's count zeroed. A CUDA kernel cannot run here, so
`_model_table` repeats those steps - masks, popcounts, the ranks of set bits,
the slot rule - on a byte buffer that holds the map at any alignment
between bytes of garbage, and the result must be the plain route's table.

Tolerance: none, but for sigma, which the model takes from torch.pow over
another tensor than the plain route: PyTorch's CPU pow runs SLEEF's vector
powf (1 ulp) or std::pow by an element's place in its tensor, and the
product with the level's sigma can widen that one ulp of pow to two of
sigma, so sigma agrees within 2**-22 relative. The kernel itself is held to the
plain route bit for bit, sigma included, on a GPU by
tests/test_torch_cuda_kernels.py (marker `gpu`). The model is kept in step
with compact.cu by hand, so no edit of the CUDA source can fail a test here.
"""

import numpy as np
import pytest
import torch

from hessgpu_tpu_torch import SiftConfig, make_plan
from hessgpu_tpu_torch import pyramid as tpyr
from hessgpu_tpu_torch.ops import compaction as tcomp
from hessgpu_tpu_torch.ops.cuda import compact as kcompact
from hessgpu_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
from hessgpu_tpu_torch.ops.keypoint import KeypointMaps, f32
from hessgpu_tpu_torch.sfm.synthetic import texture_frame

SIGMAS = torch.tensor([2.0159, 2.5398, 3.2], dtype=torch.float32)
STEP = 2.0 ** (1.0 / 3.0)


# ---- the wrapper's CPU route -------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(detector="dog"),
                                dict(threshold=0.0005, global_feature_cap=64)],
                         ids=["hessian", "dog", "table-overflow"])
def test_cpu_route_is_the_plain_route(kw):
    """On CPU tensors the wrapper is compact_octave_keypoints an octave and
    _globalize over all of them, its counts those of detect_from_octaves,
    and it launches nothing."""
    cfg = SiftConfig(compute_descriptors=False, fixed_orientation=True, **kw)
    p = cfg.scale_params()
    imgs = torch.from_numpy(np.stack([texture_frame(s, 96, 128)
                                      for s in range(2)]))
    plan = make_plan(96, 128, cfg)
    consts = tpyr._plan_constants(plan, cfg, "cpu")
    octaves = tpyr._build_pyramid(imgs, plan, cfg)
    G = min(cfg.global_feature_cap, sum(plan.level_caps))
    nk = len(p.key_levels)
    reset_launch_counts()
    got, want = [], []
    for o, gauss in enumerate(octaves):
        maps = tpyr._detect_octave(gauss, cfg)[0]
        cap = plan.level_caps[o * nk]
        got.append(kcompact.compact_octave(maps, consts.key_sigmas, p.sigmak,
                                           cap))
        want.append(tcomp.compact_octave_keypoints(maps, consts.key_sigmas,
                                                   p.sigmak, cap))
        assert isinstance(got[-1], tcomp.FeatureList)
        for a, b in zip(got[-1], want[-1]):
            assert torch.equal(a, b)
    table, counts, pre = kcompact.feature_table(got, G, consts.level_ids)
    assert not any(launch_counts().values())
    want_table = tcomp._globalize(want, G, consts.level_ids)
    for a, b in zip(table, want_table):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(counts, torch.cat([fl.count() for fl in want], -1))
    assert torch.equal(pre, want_table.count())
    assert int(pre.min()) > 0
    if "global_feature_cap" in kw:
        assert int(pre.max()) == G < int(counts.sum(-1).max())
    # and detect_from_octaves reports the same
    t2, _, aux = tpyr.detect_from_octaves(octaves, plan, cfg)
    for a, b in zip(t2, table):
        assert torch.equal(a, b)
    assert torch.equal(aux["level_counts"], counts)
    assert torch.equal(aux["pre_count"], pre)


# ---- the kernels' design -----------------------------------------------------

def _chunk_mask(s, e):
    """csrc/compact.cu chunk_mask: bytes [s, e) of a 16-byte chunk as four
    little-endian 32-bit word masks."""
    out = []
    for j in range(4):
        a = min(max(s - 4 * j, 0), 4)
        b = min(max(e - 4 * j, 0), 4)
        below_b = 0xffffffff if b == 4 else (1 << (8 * b)) - 1
        below_a = 0xffffffff if a == 4 else (1 << (8 * a)) - 1
        out.append(below_b & ~below_a & 0xffffffff)
    return np.array(out, np.uint32)


def _row_words(buf, start, W):
    """RowChunks: the masked (chunks, 4) uint32 words of the W-byte row at
    byte `start` of buf (a chunk is 16-byte aligned in buf) and the row's
    lead (bytes of chunk 0 before it)."""
    a0, lead = start - start % 16, start % 16
    n = (lead + W + 15) // 16
    words = buf[a0:a0 + 16 * n].view("<u4").reshape(n, 4).copy()
    for c in range(n):
        words[c] &= _chunk_mask(lead - 16 * c, lead + W - 16 * c)
    return words, lead


def _popc(words):
    return int(sum(bin(int(w)).count("1") for w in np.ravel(words)))


def _laid_out(valid, shift, rng):
    """valid's bytes at offset `shift` of a buffer padded to whole chunks
    with garbage bytes (neither 0 nor 1) on both sides."""
    flat = valid.numpy().reshape(-1).astype(np.uint8)
    n = -(-(shift + flat.size) // 16) * 16 + 16
    buf = rng.randint(2, 256, n).astype(np.uint8)
    buf[shift:shift + flat.size] = flat
    return buf


def _model_table(octs, caps, G, sigmas, step, shifts, seed=0):
    """The three kernels of compact.cu on the CPU: row_count_kernel per
    octave, level_scan_kernel, table_scatter_kernel (tail blocks too).
    octs: KeypointMaps with (B, NK, H, W) leaves; shifts: each valid map's
    byte offset from a chunk boundary."""
    rng = np.random.RandomState(seed)
    B, NK = octs[0].valid.shape[:2]
    nl = len(octs) * NK
    rows = []
    for m, shift in zip(octs, shifts):                    # row_count_kernel
        _, _, H, W = m.valid.shape
        buf = _laid_out(m.valid, shift, rng)
        kpr = min(W, tcomp._row_cap(W))
        cnt = np.zeros((B, NK, H), np.int64)
        for b in range(B):
            for k in range(NK):
                for r in range(H):
                    start = shift + ((b * NK + k) * H + r) * W
                    cnt[b, k, r] = min(_popc(_row_words(buf, start, W)[0]),
                                       kpr)
        rows.append((buf, cnt))
    level_counts = np.zeros((B, nl), np.int64)             # level_scan_kernel
    offs = []
    for o, (_, cnt) in enumerate(rows):
        offs.append(np.cumsum(cnt, -1) - cnt)
        level_counts[:, o * NK:(o + 1) * NK] = np.minimum(cnt.sum(-1), caps[o])
    f = dict(x=np.zeros((B, G), np.float32), y=np.zeros((B, G), np.float32),
             sigma=np.zeros((B, G), np.float32),
             theta=np.zeros((B, G), np.float32),
             response=np.zeros((B, G), np.float32),
             ftype=np.zeros((B, G), np.int32),
             level_id=np.zeros((B, G), np.int32),
             valid=np.zeros((B, G), bool))
    written = np.zeros((B, G), np.int64)
    for b in range(B):                                  # table_scatter_kernel
        for o, (m, (buf, cnt)) in enumerate(zip(octs, rows)):
            _, _, H, W = m.valid.shape
            for k in range(NK):
                L = o * NK + k
                before = int(level_counts[b, :L].sum())
                for r in range(H):
                    c, off = int(cnt[b, k, r]), int(offs[o][b, k, r])
                    if c == 0 or off >= level_counts[b, L]:
                        continue
                    n = min(c, int(level_counts[b, L]) - off, G - before - off)
                    if n <= 0:
                        continue
                    start = shifts[o] + ((b * NK + k) * H + r) * W
                    words, lead = _row_words(buf, start, W)
                    rank = 0
                    for ch, word4 in enumerate(words):
                        for q, w in enumerate(word4):
                            w = int(w)
                            while w and rank < n:
                                low = (w & -w).bit_length() - 1
                                w &= w - 1
                                col = 16 * ch + 4 * q + (low >> 3) - lead
                                t = before + off + rank
                                cell = (b, k, r, col)
                                f["x"][b, t] = np.float32(col) \
                                    + np.float32(0.5) + m.dx[cell].numpy()
                                f["y"][b, t] = np.float32(r) \
                                    + np.float32(0.5) + m.dy[cell].numpy()
                                f["sigma"][b, t] = (sigmas[k] * torch.pow(
                                    f32(step), m.ds[cell])).numpy()
                                f["response"][b, t] = m.response[cell]
                                f["ftype"][b, t] = m.ftype[cell]
                                f["level_id"][b, t] = L
                                f["valid"][b, t] = True
                                written[b, t] += 1
                                rank += 1
    pre = np.minimum(level_counts.sum(-1), G)           # the tail blocks
    for b in range(B):
        assert (written[b, :pre[b]] == 1).all() and not written[b, pre[b]:].any()
    table = tcomp.GlobalTable(**{k: torch.from_numpy(v) for k, v in f.items()})
    return (table, torch.from_numpy(level_counts.astype(np.int32)),
            torch.from_numpy(pre.astype(np.int32)))


def _maps(rng, shape, density, flood_rows=()):
    """Random (B, NK, H, W) maps: valid cells at `density`, every cell of the
    `flood_rows` valid; payload everywhere, offsets in (-1, 1)."""
    valid = rng.rand(*shape) < density
    for r in flood_rows:
        valid[..., r, :] = True
    u = lambda: torch.from_numpy(   # noqa: E731
        (rng.rand(*shape) * 1.9 - 0.95).astype(np.float32))
    return KeypointMaps(
        valid=torch.from_numpy(valid), response=u(), dx=u(), dy=u(), ds=u(),
        ftype=torch.from_numpy(rng.randint(0, 3, shape).astype(np.int32)))


# (octave (H, W) shapes, density, flooded rows of octave 0, level caps, G)
CASES = {
    "odd-widths": ([(24, 47), (12, 23), (6, 11)], 0.2, (), (400, 200, 50),
                   1000),
    "narrow": ([(9, 20), (5, 3), (2, 1)], 0.5, (), (100, 100, 100), 500),
    "row-cap-flood": ([(8, 640), (4, 320)], 0.02, (1, 5), (800, 800), 4000),
    "level-cap": ([(16, 75), (8, 37)], 0.3, (3,), (40, 10), 1000),
    "table-cap": ([(16, 75), (8, 37)], 0.3, (), (400, 100), 150),
    "empty": ([(10, 33), (5, 16)], 0.0, (), (50, 50), 64),
}


@pytest.mark.parametrize("shift", [0, 5, 13])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_model_equals_the_plain_route(case, shift):
    shapes, density, flood, caps, G = CASES[case]
    rng = np.random.RandomState(sorted(CASES).index(case))
    octs = [_maps(rng, (2, 3, h, w), density, flood if o == 0 else ())
            for o, (h, w) in enumerate(shapes)]
    lists = [tcomp.compact_octave_keypoints(m, SIGMAS, STEP, cap)
             for m, cap in zip(octs, caps)]
    nk = 3
    level_ids = torch.from_numpy(np.concatenate([
        np.repeat(o * nk + np.arange(nk), cap) for o, cap in enumerate(caps)])
        .astype(np.int32))
    want, want_counts, want_pre = kcompact.feature_table_plain(
        lists, G, level_ids)
    shifts = [(shift + 7 * o) % 16 for o in range(len(octs))]
    got, counts, pre = _model_table(octs, caps, G, SIGMAS, STEP, shifts)
    assert torch.equal(counts, want_counts) and torch.equal(pre, want_pre)
    for name in tcomp.GlobalTable._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        if name == "sigma":
            torch.testing.assert_close(a, b, rtol=2.0 ** -22, atol=0)
        else:
            assert torch.equal(a, b), name
    if case == "row-cap-flood":         # the cap decided membership
        assert int(want_counts[:, 0].max()) < int(octs[0].valid[:, 0].sum(
            (-1, -2)).max())
    if case == "level-cap":
        assert bool((want_counts[:, :3] == caps[0]).any())
    if case == "table-cap":
        assert int(want_pre.max()) == G < int(want_counts.sum(-1).max())
    if case == "empty":
        assert int(want_pre.max()) == 0


def test_chunk_masks_cover_a_row_once():
    """Every byte of a row lies in exactly one chunk's mask, whatever the
    row's lead and length, and no byte outside it does."""
    for lead in range(16):
        for W in (1, 2, 15, 16, 17, 31, 47, 640):
            n = (lead + W + 15) // 16
            covered = np.concatenate([
                np.unpackbits(_chunk_mask(lead - 16 * c, lead + W - 16 * c)
                              .view(np.uint8), bitorder="little")[::8]
                for c in range(n)])
            want = np.zeros(16 * n, np.uint8)
            want[lead:lead + W] = 1
            assert np.array_equal(covered, want), (lead, W)
