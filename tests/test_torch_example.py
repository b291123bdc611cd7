"""examples/simple_sift_torch.py on the CPU: its default images (two
overlapping crops of one seeded texture, written as PGMs), in process and
through the port's feature server binary (built into a temporary directory
as in tests/test_torch_server_wire.py): features and matches on both, the
in-process matches equal to SiftMatcher on the same features, the server's
equal to SiftMatcher on the descriptors it sent; the script itself run as a
user runs it, and refusing the card's default without one.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hessgpu_tpu_torch import SiftMatcher

from test_torch_server_wire import server_bin  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))

import simple_sift_torch as example  # noqa: E402


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    return example.default_images(str(tmp_path_factory.mktemp("images")))


def test_default_images_overlap(images):
    from hessgpu_tpu_torch.io_image import load_pnm
    a, b = (load_pnm(p) for p in images)
    (h, w), (dy, dx) = example.SHAPE, example.SHIFT
    assert a.shape == b.shape == (h, w)
    np.testing.assert_array_equal(a[dy:, dx:], b[:h - dy, :w - dx])


def test_in_process_matches_are_the_matchers(images):
    f1, f2, matches = example.run(*images, device="cpu")
    assert len(f1["desc"]) > 0 and len(f2["desc"]) > 0
    assert len(matches) > 20
    want = SiftMatcher(device="cpu").match(f1, f2)
    np.testing.assert_array_equal(matches, want)
    # the pairs are the shift between the crops
    dy, dx = example.SHIFT
    i, j = matches[:, 0], matches[:, 1]
    shift = np.stack([f1["x"][i] - f2["x"][j], f1["y"][i] - f2["y"][j]], 1)
    assert np.median(np.abs(shift - [dx, dy]), axis=0).max() < 0.5


def test_remote_mode_over_the_server(images, server_bin):  # noqa: F811
    f1, f2, matches = example.run(*images, device="cpu", remote=True,
                                  server_binary=server_bin)
    assert f1["kp"].shape[1] == 6 and f1["desc"].shape[1] == 128
    assert len(f1["desc"]) > 0 and len(f2["desc"]) > 0
    assert len(matches) > 20
    matcher = SiftMatcher(device="cpu")
    matcher.set_descriptors(0, f1["desc"])
    matcher.set_descriptors(1, f2["desc"])
    np.testing.assert_array_equal(matches, matcher.get_sift_match())


def _script(*args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    script = os.path.join(REPO, "examples", "simple_sift_torch.py")
    return subprocess.run([sys.executable, script, *args],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=REPO)


def test_the_script_runs_on_the_cpu():
    out = _script("--device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    counts = [int(line.rsplit(": ", 1)[1].split()[0]) for line in lines[:2]]
    assert min(counts) > 0 and lines[2].endswith(" matches")
    assert int(lines[2].split()[0]) > 20


def test_the_script_defaults_to_the_card():
    """No silent fallback: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _script()
    assert out.returncode != 0
    assert "cuda" in out.stderr.lower()
