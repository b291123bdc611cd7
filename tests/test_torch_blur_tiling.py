"""The blur kernel's walk, modelled in plain torch on the CPU.

csrc/conv.cu blur_kernel gives a block one column strip (64 output columns)
of one plane and one segment of its rows. The block walks down the segment
in steps of 32 rows: it stages the next input rows of the strip with the
horizontal halo (column index clamped to the image), runs the horizontal
pass into a ring of 64 shared rows (slot = row & 63), and then writes every
output row whose vertical taps, row index clamped to the image, lie among
the rows computed so far, reading them from the ring. So each horizontal row
of a segment is computed once. A CUDA kernel cannot run here, so `_model_blur`
below repeats that walk - strips, segments, steps, ring slots, clamps - with
the kernel's arithmetic (acc = t[0]*x[0]; acc = acc + t[k]*x[k]); the ring
starts as NaN, so a read of a slot not yet written, or written over too
early, shows.

Tolerance: none. The model must equal blur_plain (clamp-to-edge, horizontal
then vertical) bit for bit at the main path's shape (16 x 480 x 640, 13
taps), at the octave shapes 240 x 320 down to 30 x 40, with 33 taps, for one
row, one column and widths smaller than the halo, under the kernel's own
segment rule and under other segment heights.

What this file checks is the design, not the kernel: the model is kept in
step with conv.cu by hand, so no edit of the CUDA source can fail a test
here. The kernel itself is held against blur_plain on a GPU by
tests/test_torch_cuda_kernels.py (marker `gpu`), which also holds the
kernel's segment rule to `_segment_rows`, and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from hessgpu_tpu_torch.ops import gaussian as tgauss
from hessgpu_tpu_torch.ops.cuda import conv as kconv
from hessgpu_tpu_torch.params import gaussian_taps

STRIP, STEP, RING = 64, 32, 64     # kBW, kBH, kRing in csrc/conv.cu
BLOCKS_PER_SM = 4                  # kBlurBlocksPerSM
H100_SMS = 132
TAPS13 = gaussian_taps(1.5198684153570665)   # the initial blur
TAPS33 = gaussian_taps(5.0)                  # the widest filter


def _cdiv(a, b):
    return -(-a // b)


def _segment_rows(B, H, W, sms=H100_SMS):
    """blur_segment_rows in conv.cu: the fewest segments that give
    BLOCKS_PER_SM blocks an SM, no more than one per STEP rows."""
    want = _cdiv(BLOCKS_PER_SM * sms, B * _cdiv(W, STRIP))
    return _cdiv(H, min(want, _cdiv(H, STEP)))


def _model_blur(x, taps, seg_rows, ring_rows=RING):
    """blur_kernel's walk over every strip at once (strips are independent),
    segment by segment and step by step. x (B, H, W)."""
    t = tgauss.taps_f32(taps)
    n, r = len(t), len(t) // 2
    B, H, W = x.shape
    S = _cdiv(W, STRIP)
    # staged columns of each strip, the index clamped to the image
    cols = (torch.arange(S)[:, None] * STRIP - r
            + torch.arange(STRIP + 2 * r)[None]).clamp(0, W - 1)
    out = torch.full((B, H, S * STRIP), float("nan"))
    for R0 in range(0, H, seg_rows):
        R1 = min(H, R0 + seg_rows)
        hend = min(H, R1 + r)
        hy, odone = max(0, R0 - r), R0
        ring = torch.full((B, ring_rows, S, STRIP), float("nan"))
        while hy < hend:
            rows = min(STEP, hend - hy)
            staged = x[:, hy:hy + rows][:, :, cols]     # (B, rows, S, 64+2r)
            acc = float(t[0]) * staged[..., 0:STRIP]
            for k in range(1, n):
                acc = acc + float(t[k]) * staged[..., k:k + STRIP]
            ring[:, torch.arange(hy, hy + rows) & (ring_rows - 1)] = acc
            hy += rows
            oend = R1 if hy == H else min(R1, hy - r)
            ys = torch.arange(odone, oend)
            slot = lambda k: (ys - r + k).clamp(0, H - 1) & (ring_rows - 1)
            v = float(t[0]) * ring[:, slot(0)]
            for k in range(1, n):
                v = v + float(t[k]) * ring[:, slot(k)]
            out[:, odone:oend] = v.reshape(B, len(ys), S * STRIP)
            odone = oend
        assert odone == R1
    return out[..., :W]


def _planes(shape, seed):
    return torch.from_numpy(
        np.random.RandomState(seed).rand(*shape).astype(np.float32))


def _same(a, b):
    return a.shape == b.shape and bool((a == b).all())


@pytest.mark.parametrize("shape,taps", [
    ((16, 480, 640), TAPS13),      # the main path's initial blur
    ((16, 480, 640), TAPS33),
    ((16, 240, 320), TAPS13),      # the octave shapes below it
    ((16, 120, 160), TAPS13),
    ((16, 60, 80), TAPS33),
    ((16, 30, 40), TAPS13),
    ((16, 30, 40), TAPS33),
    ((17, 101, 75), TAPS13),       # odd shape, ragged strip
    ((2, 1, 77), TAPS33),          # one row
    ((2, 50, 1), TAPS13),          # one column
    ((3, 40, 7), TAPS33),          # narrower than the halo
    ((2, 5, 9), TAPS33),           # smaller than the halo both ways
], ids=lambda v: str(v) if isinstance(v, tuple) else f"{len(v)}taps")
def test_walk_equals_plain(shape, taps):
    x = _planes(shape, 21)
    got = _model_blur(x, taps, _segment_rows(*shape))
    assert not bool(got.isnan().any())
    assert _same(got, kconv.blur_plain(x, taps))


@pytest.mark.parametrize("seg_rows", [1, 7, 31, 32, 33, 64, 100])
def test_any_segment_height_equals_plain(seg_rows):
    """Segment edges inside the image, a segment shorter than the halo and
    one step holding the end of the image."""
    x = _planes((2, 100, 150), 22)
    for taps in (TAPS13, TAPS33):
        got = _model_blur(x, taps, seg_rows)
        assert _same(got, kconv.blur_plain(x, taps))


def test_segment_rule():
    """The choice the header of conv.cu states: 4 segments of 120 rows for
    the initial blur (640 blocks on 132 SMs), one segment for a 16-plane
    30 x 40 stack, never more than one per 32 rows."""
    assert _segment_rows(16, 480, 640) == 120
    assert _segment_rows(16, 30, 40) == 30
    assert _segment_rows(1, 1, 640) == 1
    assert _segment_rows(1, 480, 640) == 32


def test_ring_holds_the_halo():
    """64 slots hold a step's 32 new rows plus 2r <= 32 halo rows: with a
    32-row ring the walk reads slots already written over."""
    x = _planes((1, 96, 64), 23)
    assert _same(_model_blur(x, TAPS13, 96, ring_rows=64),
                 kconv.blur_plain(x, TAPS13))
    assert not _same(_model_blur(x, TAPS13, 96, ring_rows=32),
                     kconv.blur_plain(x, TAPS13))
