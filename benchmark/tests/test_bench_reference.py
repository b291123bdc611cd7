"""The reference against the port's CPU route at a tiny size, its
independence from the program and from JAX, the frame generator, and the
control: the reference with its Gaussian planes in bfloat16, in the
program's place, comes out not correct under every cell's limits."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from benchlib import compare, manifest  # noqa: E402
from benchlib.frames import ALPHA_MAX, blob_count, blob_frames  # noqa: E402

REF = manifest.reference("hessian_sift")
DENSITY = 0.0022
CELLS = ("tum640.describe.b16", "eth3d24mp.describe.b1",
         "tum640.detect_only.b16")
MODES = {"describe": {},
         "detect_only": {"compute_descriptors": False,
                         "fixed_orientation": True}}


@pytest.fixture(scope="module")
def frames():
    return blob_frames(2, 200, 256, DENSITY, 2 ** 31 + 77, "cpu")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_reference_equals_the_port_on_the_cpu(frames, mode):
    sys.path.insert(0, str(ROOT))
    from hessgpu_tpu_torch import SiftConfig, detect_batch
    fields = MODES[mode]
    got = compare.to_host(detect_batch(frames, SiftConfig(**fields),
                                       device="cpu"))
    table, work = REF.run(frames, REF.Settings.from_fields(fields))
    want = compare.to_host(table)
    for f in compare.FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert want["valid"].sum() > 40
    nums = compare.compare([(got, want)])
    assert nums["kp_unmatched"] == nums["kp_field_gap"] == 0
    assert nums["row_unmatched_share"] == nums["desc_max_gap"] == 0
    assert sum(work.valid_cells) >= work.oriented_keypoints


def test_reference_and_harness_load_neither_program_nor_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchlib import manifest, compare, frames, trace\n"
        "manifest.reference('hessian_sift')\n"
        "print([m for m in sys.modules if m.split('.')[0] in "
        "('hessgpu_tpu_torch', 'hessgpu_tpu', 'jax', 'jaxlib', 'flax')])\n"
        % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_unknown_settings_are_refused():
    with pytest.raises(ValueError):
        REF.Settings.from_fields({"conv_mode": "direct"})


def test_frames_are_a_function_of_the_seed():
    a = blob_frames(3, 48, 64, 4 * DENSITY, 2 ** 33 + 5, "cpu")
    b = blob_frames(3, 48, 64, 4 * DENSITY, 2 ** 33 + 5, "cpu")
    c = blob_frames(3, 48, 64, 4 * DENSITY, 2 ** 33 + 6, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.float32 and 0.0 <= float(a.min()) \
        and float(a.max()) <= 1.0


def test_frames_composite_the_blobs_in_order():
    """The vectorised compositor equals compositing blob after blob."""
    n, h, w, seed = 2, 40, 56, 12345
    got = blob_frames(n, h, w, 8 * DENSITY, seed, "cpu").numpy()
    gen = torch.Generator()
    gen.manual_seed(seed)
    nb = blob_count(h, w, 8 * DENSITY)

    def rand(*shape):
        return torch.rand(shape, generator=gen, dtype=torch.float64).numpy()

    cx, cy = rand(n, nb) * w, rand(n, nb) * h
    sg, val = 1.2 + rand(n, nb) ** 2 * 7.0, rand(n, nb)
    noise = torch.rand((n, h, w), generator=gen).numpy()
    t = np.full((n, h, w), 0.5)
    yy, xx = np.mgrid[0:h, 0:w]
    for f in range(n):
        for i in range(nb):
            d2 = (xx - cx[f, i]) ** 2 + (yy - cy[f, i]) ** 2
            m = d2 < (3 * sg[f, i]) ** 2
            a = np.minimum(np.exp(-0.5 * d2[m] / sg[f, i] ** 2), ALPHA_MAX)
            t[f][m] = (1 - a) * t[f][m] + a * val[f, i]
    want = np.clip(t.astype(np.float32) + 0.02 * noise, 0, 1)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(frames, cell):
    """The control (the reference's Gaussian planes in bfloat16) against the
    reference, under the cell's own settings and limits."""
    c = manifest.cell(cell)
    s = REF.Settings.from_fields({**c.config["sift"], **c.traffic["sift"]})
    want = compare.to_host(REF.run(frames, s)[0])
    ctl = compare.to_host(REF.run(frames, s, plane_dtype=torch.bfloat16)[0])
    numbers = compare.compare([(ctl, want)])
    correct, checks = compare.judge(numbers, c.limits)
    assert not correct, checks
    failed = [k for k, v, lim in checks if v > lim]
    assert "kp_unmatched" in failed and "kp_field_gap" in failed
