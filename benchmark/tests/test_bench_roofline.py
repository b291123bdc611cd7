"""Each kernel stage's byte and operation count against a hand count at a
small shape, and the context the harness builds for them from the
reference's work counts."""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from benchlib import manifest  # noqa: E402
from benchlib.cell import roofline_context  # noqa: E402

REF = manifest.reference("hessian_sift")

# B = 2 frames of 32 x 48: octaves 32x48, 16x24, 8x12 (min_dim 16: 3)
SHAPES = [(32, 48), (16, 24), (8, 12)]


def ctx(**over):
    c = dict(batch=2, octave_shapes=SHAPES, num_levels=5, key_levels=3,
             blur_taps=13, chain_taps=[9, 11, 13, 17],
             valid_cells=[10, 4, 0], fixed_orientation=False,
             compute_descriptors=True, table_rows=2 * 2048, ori_pixels=5000,
             desc_table_rows=2 * 3072, desc_pixels=90000)
    c.update(over)
    return c


def count(stage, **over):
    return manifest.stage_counter(stage)(ctx(**over))


def test_blur():
    n = 2 * 32 * 48
    assert count("blur") == {"initial": (8 * n, 4 * 13 * n)}
    assert count("blur", blur_taps=0) == {}


def test_octave_chain_and_decimate():
    taps = 9 + 11 + 13 + 17
    want = {}
    for o, (h, w) in enumerate(SHAPES):
        n = 2 * h * w
        want[f"octave{o}"] = (4 * 5 * n, 4 * taps * n)
    assert count("octave_chain") == want
    # the chain of octave o writes octave o + 1's base: its pixels once
    assert count("decimate") == {"octave0": (4 * 2 * 16 * 24, 0),
                                 "octave1": (4 * 2 * 8 * 12, 0)}


def test_detect():
    got = count("detect_octave")
    n0 = 2 * 32 * 48
    assert got["octave0"] == (n0 * (4 * 5 + 9 * 3) + 20 * 10,
                              n0 * (13 * 5 + 30 * 3) + 170 * 10)
    n2 = 2 * 8 * 12
    assert got["octave2"] == (n2 * (20 + 27), n2 * (65 + 90))


def test_per_keypoint_stages():
    assert count("orientation") == {
        "table": (8 * 5000 + 4096 * 37, 25 * 5000)}
    assert count("orientation", fixed_orientation=True) == {}
    assert count("descriptor") == {
        "table": (8 * 90000 + 6144 * 533, 75 * 90000)}
    assert count("descriptor", compute_descriptors=False) == {}


def test_context_from_the_reference():
    """The harness's context: the plan's shapes, the taps the pyramid uses,
    and the work the reference counted on these frames."""
    s = REF.Settings()
    plan = REF.make_plan(64, 96, s)
    assert list(plan.octave_shapes) == [(64, 96), (32, 48), (16, 24)]
    frames = torch.rand(2, 64, 96, generator=torch.Generator().manual_seed(1))
    _, work = REF.run(frames, s)
    c = roofline_context(s, plan, 2, work, REF)
    assert c["blur_taps"] == len(REF.gaussian_taps(s.initial_blur_sigma(),
                                                   4.0)) == 13
    assert c["chain_taps"] == [len(REF.gaussian_taps(g, 4.0))
                               for g in s.incremental_sigmas()]
    assert c["valid_cells"] == list(work.valid_cells)
    assert c["table_rows"] == 2 * work.table_rows // 2
    assert sum(c["valid_cells"]) >= 0 and c["num_levels"] == 5


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3",
                                  "NVIDIA H100 PCIe"])
def test_peaks(kind):
    assert manifest.peaks(kind) == (3.35e12, 67e12)
