"""The port's hess CLI (python -m hessgpu_tpu_torch.cli.hess) with
--device cpu against the JAX package's hess CLI, on seeded PGM files.

Tolerances: the .sift files parse to the same features within the
pipeline's tolerances (tests/test_torch_pipeline_default.py), coarsened by
the text format's own rounding: x, y to 0.005 + 1e-3 px times 2^octave,
sigma and theta to 5e-4 plus the pipeline's tolerance, descriptors to one
1/512 step. Binary (-b) files: the record layout, and the values within
those tolerances of the JAX CLI's text file (the writers themselves are held
byte for byte in tests/test_torch_formats_io.py).
"""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from hessgpu_tpu.cli import hess as jhess
from hessgpu_tpu.utils.timing import REFERENCE_BUCKETS as JAX_BUCKETS
from hessgpu_tpu_torch.cli import hess
from hessgpu_tpu_torch.formats import load_sift_text
from hessgpu_tpu_torch.sfm.synthetic import texture_frame

from test_torch_detector import write_pgm
from _torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (96, 128)
ONE_QUANTUM = 2 * np.pi / 255 + 1e-6


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    return d, [write_pgm(d / f"img{i}.pgm", texture_frame(30 + i, *SHAPE))
               for i in range(2)]


def _sift_files_agree(got_path, want_path, min_count=10):
    got, want = load_sift_text(got_path), load_sift_text(want_path)
    assert len(got["x"]) == len(want["x"]) >= min_count
    for k in ("level", "ftype"):
        np.testing.assert_array_equal(got[k], want[k])
    tol = 0.005 + 1e-3 * np.exp2(want["level"] // 3)
    for k in ("x", "y"):
        assert (np.abs(got[k] - want[k]) <= tol).all(), k
    assert (np.abs(got["sigma"] - want["sigma"]) <= 5e-4 + tol).all()
    dth = np.abs(np.mod(got["theta"] - want["theta"] + np.pi, 2 * np.pi)
                 - np.pi)
    assert dth.max() <= ONE_QUANTUM and (dth > 1e-3).sum() <= len(dth) // 100
    same = dth <= 1e-3
    assert np.abs(got["desc"][same] - want["desc"][same]).max() <= \
        1.0 / 512 + 1e-6
    return got


@pytest.fixture(scope="module")
def jax_sift(images, tmp_path_factory):
    """The JAX package's CLI on image 0: its .sift file."""
    d, imgs = images
    out = str(tmp_path_factory.mktemp("jax") / "a.sift")
    assert jhess.main(["-i", imgs[0], "-o", out]) == 0
    return out


def test_cli_matches_jax(images, jax_sift, tmp_path):
    d, imgs = images
    out = str(tmp_path / "a.sift")
    assert hess.main(["-i", imgs[0], "-o", out, "--device", "cpu"]) == 0
    got = _sift_files_agree(out, jax_sift)
    norms = np.linalg.norm(got["desc"], axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=0.01)


def test_cli_image_list_writes_beside_each_image(images, tmp_path):
    d, imgs = images
    sub = tmp_path / "imgs"
    sub.mkdir()
    lst = sub / "list.txt"
    names = []
    for i, p in enumerate(imgs):
        q = sub / f"l{i}.pgm"
        q.write_bytes(open(p, "rb").read())
        names.append(q.name)
    lst.write_text("\n".join(names) + "\n")
    assert hess.main(["-il", str(lst), "-topk", "20", "--device", "cpu"]) == 0
    for n in names:
        got = load_sift_text(str(sub / n.replace(".pgm", ".sift")))
        assert 15 <= len(got["x"]) <= 40    # 20 keypoints, some with two


def test_cli_binary_output_matches_jax(images, jax_sift, tmp_path):
    d, imgs = images
    out = str(tmp_path / "b.sift")
    assert hess.main(["-i", imgs[0], "-b", "-o", out, "--device", "cpu"]) == 0
    data = open(out, "rb").read()
    n, dim = struct.unpack("<ii", data[:8])
    rec = np.dtype([("yxso", "<f4", 4), ("resp", "<f4"), ("type", "<u2"),
                    ("level", "<u2"), ("desc", "<f4", dim)])
    got = np.frombuffer(data, rec, count=n, offset=8)
    assert len(data) == 8 + n * rec.itemsize
    want = load_sift_text(jax_sift)
    assert dim == 128 and n == len(want["x"]) >= 10
    np.testing.assert_array_equal(got["level"], want["level"])
    np.testing.assert_array_equal(got["type"], want["ftype"])
    tol = 0.005 + 1e-3 * np.exp2(want["level"] // 3)
    assert (np.abs(got["yxso"][:, 0] - want["y"]) <= tol).all()
    assert (np.abs(got["yxso"][:, 1] - want["x"]) <= tol).all()
    assert np.abs(got["desc"] - want["desc"]).max() <= 1.0 / 512 + 1e-6


def test_cli_time_writes_the_buckets(images, tmp_path):
    d, imgs = images
    p = tmp_path / "t.pgm"
    p.write_bytes(open(imgs[0], "rb").read())
    assert hess.main(["-i", str(p), "-time", "--device", "cpu"]) == 0
    lines = (tmp_path / "t.timings").read_text().splitlines()
    assert lines[0] == "load,pipeline,download"
    assert tuple(lines[2].split(",")) == JAX_BUCKETS
    vals = np.array([float(v) for v in lines[3].split(",")])
    assert np.isfinite(vals).all() and (vals >= 0).all()
    assert (tmp_path / "t.sift").exists()


def test_cli_speed(tmp_path, capsys):
    p = write_pgm(tmp_path / "s.pgm", texture_frame(40, 48, 64))
    assert hess.main(["-i", p, "-speed", "--device", "cpu", "-sd"]) == 0
    out = capsys.readouterr().out
    assert out.count(" Hz (") == 2 and "[set 2]" in out
    lines = (tmp_path / "s.speed.csv").read_text().splitlines()
    assert lines[0] == "set,hz,ms_per_img,features" and len(lines) == 5
    assert tuple(lines[3].split(",")) == JAX_BUCKETS


def test_cli_dump_intermediates(images, tmp_path):
    d, imgs = images
    out = tmp_path / "views"
    assert hess.main(["-i", imgs[0], "-o", str(tmp_path / "v.sift"),
                      "--dump-intermediates", str(out),
                      "--device", "cpu"]) == 0
    names = set(os.listdir(out / "img0"))
    assert {"0_input.png", "6_keypoints.png", "5_key_o0_l1.png"} <= names


def test_cli_help_and_usage(capsys):
    assert hess.main(["-h"]) == 0
    out = capsys.readouterr().out
    assert "--device" in out
    for line in jhess.HELP.splitlines()[1:]:
        assert line in out
    assert hess.main([]) == 1
    assert "usage" in capsys.readouterr().err


def test_cli_runs_as_a_module(images, tmp_path):
    """python -m hessgpu_tpu_torch.cli.hess, as a user calls it."""
    d, imgs = images
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "hessgpu_tpu_torch.cli.hess", "-i", imgs[0],
         "-o", str(tmp_path / "m.sift"), "-v", "1", "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "#Features:" in r.stdout
    assert load_sift_text(str(tmp_path / "m.sift"))["x"].shape[0] > 10
