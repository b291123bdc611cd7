"""The port's own copies of the host-side modules: features.keypoint_buffer,
formats.py (the three .sift writers and the text loader), io_image.py (the
PNM parser, load_image, limit_working_size) and native.py, against the JAX
package's.

Tolerances: none. The writers are held byte for byte, the buffer and the
parsed images bit for bit; the text loader's values come back as the JAX
loader reads them (the text format keeps 2-3 decimals and 1/512 steps of
the descriptor). With csrc/hessio.cpp built, both packages take the native
paths and are held to each other the same way.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from hessgpu_tpu import features as jfeatures
from hessgpu_tpu import formats as jformats
from hessgpu_tpu import io_image as jio
from hessgpu_tpu.config import SiftConfig as JConfig
from hessgpu_tpu_torch import formats, io_image, native
from hessgpu_tpu_torch.config import SiftConfig
from hessgpu_tpu_torch.features import keypoint_buffer


def _feats(n=23, dim=128, seed=0):
    rng = np.random.RandomState(seed)
    desc = np.abs(rng.randn(n, dim)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    return {
        "x": (rng.rand(n) * 640).astype(np.float32),
        "y": (rng.rand(n) * 480).astype(np.float32),
        "sigma": (rng.rand(n) * 20 + 1).astype(np.float32),
        "theta": (rng.rand(n) * 2 * np.pi).astype(np.float32),
        "response": (rng.randn(n) * 0.01).astype(np.float32),
        "level": rng.randint(0, 15, n).astype(np.int32),
        "ftype": rng.randint(0, 3, n).astype(np.int32),
        "desc": desc,
    }


@pytest.fixture(autouse=True)
def no_native(monkeypatch):
    """Both packages on their pure-Python paths (libhessio.so is an
    optional build of the repository; neither writer may depend on it)."""
    from hessgpu_tpu import native as jnative
    for mod in (native, jnative):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_TRIED", True)


@pytest.mark.parametrize("n", [0, 1, 23])
def test_keypoint_buffer_bit_equal(n):
    f = _feats(n)
    got, want = keypoint_buffer(f), jfeatures.keypoint_buffer(f)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    packed = got[:, 5].view(np.uint32)
    np.testing.assert_array_equal(packed & 0xFFFF, f["level"])
    np.testing.assert_array_equal(packed >> 16, f["ftype"])


@pytest.mark.parametrize("binary", [0, 1, 2], ids=["text", "b", "bvlf"])
@pytest.mark.parametrize("opts", [{}, {"compute_descriptors": False},
                                  {"half_sift": True}],
                         ids=["desc", "sd", "half"])
@pytest.mark.parametrize("n", [0, 23])
def test_writers_byte_equal(tmp_path, binary, opts, n):
    f = _feats(n, dim=64 if opts.get("half_sift") else 128)
    a, b = str(tmp_path / "port.sift"), str(tmp_path / "jax.sift")
    formats.save_sift(a, f, SiftConfig(binary_sift=binary, **opts),
                      image_size=(480, 640))
    jformats.save_sift(b, f, JConfig(binary_sift=binary, **opts),
                       image_size=(480, 640))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        got, want = fa.read(), fb.read()
    assert len(got) > 0 and got == want


def test_load_sift_text_roundtrip(tmp_path):
    f = _feats()
    p = str(tmp_path / "t.sift")
    formats.save_sift_text(p, f)
    got, want = formats.load_sift_text(p), jformats.load_sift_text(p)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["x"], f["x"], atol=0.005)
    np.testing.assert_allclose(got["sigma"], f["sigma"], atol=5e-4)
    np.testing.assert_allclose(got["desc"], f["desc"], atol=0.5 / 512 + 1e-7)
    np.testing.assert_array_equal(got["level"], f["level"])
    np.testing.assert_array_equal(got["ftype"], f["ftype"])


def test_load_sift_text_reads_the_four_field_header(tmp_path):
    p = str(tmp_path / "old.sift")
    with open(p, "w") as fh:
        fh.write("2 3\n1.5 2.5 3.0 0.1\n1 2 3\n4.5 5.5 6.0 0.2\n4 5 6\n")
    got, want = formats.load_sift_text(p), jformats.load_sift_text(p)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["x"], [2.5, 5.5])


def _write_pnm(path, magic, arr, maxval=255, comment=True):
    h, w = arr.shape[:2]
    head = f"{magic}\n" + ("# made by a test\n" if comment else "") + \
        f"{w} {h}\n{maxval}\n"
    with open(path, "wb") as fh:
        fh.write(head.encode())
        if magic in ("P5", "P6"):
            dt = ">u2" if maxval > 255 else np.uint8
            fh.write(arr.astype(dt).tobytes())
        else:
            fh.write(" ".join(str(int(v)) for v in arr.ravel()).encode())


@pytest.mark.parametrize("magic", ["P2", "P3", "P5", "P6"])
@pytest.mark.parametrize("maxval", [255, 4095, 65535])
def test_pnm_parser_equals_jax(tmp_path, magic, maxval):
    rng = np.random.RandomState(3)
    shape = (13, 17, 3) if magic in ("P3", "P6") else (13, 17)
    arr = rng.randint(0, maxval + 1, shape)
    p = str(tmp_path / f"t.{'ppm' if len(shape) == 3 else 'pgm'}")
    _write_pnm(p, magic, arr, maxval)
    got, want = io_image.load_pnm(p), jio.load_pnm(p)
    assert got.dtype == want.dtype == np.uint8 and got.shape == shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(io_image.load_image(p), jio.load_image(p))
    if maxval == 255:
        np.testing.assert_array_equal(got, arr)


def test_pnm_parser_refuses_other_files(tmp_path):
    p = str(tmp_path / "t.pgm")
    with open(p, "wb") as fh:
        fh.write(b"P4\n2 2\n\x00")
    with pytest.raises(ValueError, match="not a PGM/PPM"):
        io_image.load_pnm(p)


def test_load_image_png_equals_jax(tmp_path):
    from PIL import Image
    arr = np.random.RandomState(4).randint(0, 256, (9, 11, 4), np.uint8)
    p = str(tmp_path / "t.png")
    Image.fromarray(arr, "RGBA").save(p)
    got, want = io_image.load_image(p), jio.load_image(p)
    assert got.shape == (9, 11, 3)
    np.testing.assert_array_equal(got, want)


def test_pgm_needs_no_image_library(tmp_path, monkeypatch):
    """Without Pillow a PGM still loads; another format raises an
    ImportError that names the file."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    arr = np.arange(12, dtype=np.uint8).reshape(3, 4)
    p = str(tmp_path / "t.pgm")
    _write_pnm(p, "P5", arr)
    np.testing.assert_array_equal(io_image.load_image(p), arr)
    png = str(tmp_path / "t.png")
    with pytest.raises(ImportError, match="t.png"):
        io_image.load_image(png)


@pytest.mark.parametrize("shape,max_dim", [((1000, 1600), 800),
                                           ((1000, 1600), 4000),
                                           ((480, 640), 100), ((7, 5, 3), 2)],
                         ids=str)
def test_limit_working_size_equals_jax(shape, max_dim):
    img = np.random.RandomState(2).rand(*shape).astype(np.float32)
    got, gds = io_image.limit_working_size(img, max_dim)
    want, wds = jio.limit_working_size(img, max_dim)
    assert gds == wds and max(got.shape[:2]) <= max_dim
    np.testing.assert_array_equal(got, want)


def test_native_gives_none_without_the_library(tmp_path, monkeypatch):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert native.LIB_PATH == os.path.join(repo, "csrc", "build",
                                           "libhessio.so")
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "absent.so"))
    monkeypatch.setattr(native, "_TRIED", False)
    assert not native.available()
    assert native.decode_pnm_gray(str(tmp_path / "x.pgm")) is None
    assert native.write_sift_text(str(tmp_path / "x.sift"), _feats(2)) is False


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def hessio_lib(tmp_path_factory):
    """csrc/hessio.cpp built as csrc/Makefile builds libhessio.so, into a
    temporary directory."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        pytest.skip("no C++ compiler to build csrc/hessio.cpp")
    out = str(tmp_path_factory.mktemp("hessio") / "libhessio.so")
    subprocess.run([cxx, "-O2", "-std=c++17", "-Wall", "-shared", "-fPIC",
                    "-o", out, os.path.join(REPO, "csrc", "hessio.cpp")],
                   check=True)
    return out


@pytest.fixture
def with_native(hessio_lib, monkeypatch):
    """Both packages on the native paths, through one loaded library."""
    from hessgpu_tpu import native as jnative
    monkeypatch.setattr(native, "LIB_PATH", hessio_lib)
    monkeypatch.setattr(native, "_TRIED", False)
    assert native.available()
    monkeypatch.setattr(jnative, "_LIB", native._LIB)
    monkeypatch.setattr(jnative, "_TRIED", True)


@pytest.mark.parametrize("n", [1, 23])
def test_native_writer_equals_jax(tmp_path, with_native, monkeypatch, n):
    f = _feats(n)
    got, want, py = (str(tmp_path / f"{k}.sift") for k in ("got", "want", "py"))
    formats.save_sift_text(got, f, SiftConfig())
    jformats.save_sift_text(want, f, JConfig())
    with open(got, "rb") as a, open(want, "rb") as b:
        got_bytes = a.read()
        assert got_bytes == b.read()
    # the native writer ends a descriptor line without the Python writer's
    # trailing blank; nothing else differs
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    formats.save_sift_text(py, f, SiftConfig())
    with open(py, "rb") as fh:
        assert got_bytes == fh.read().replace(b" \n", b"\n")


@pytest.mark.parametrize("magic", ["P2", "P3", "P5", "P6"])
@pytest.mark.parametrize("maxval", [255, 4095, 65535])
def test_native_decode_equals_jax(tmp_path, with_native, magic, maxval):
    """The native decoder gives (H, W) gray for every PNM, PPM too (the
    Python parser gives a PPM's RGB); a PGM equals the Python parser's."""
    rng = np.random.RandomState(5)
    shape = (13, 17, 3) if magic in ("P3", "P6") else (13, 17)
    p = str(tmp_path / "t.pnm")
    _write_pnm(p, magic, rng.randint(0, maxval + 1, shape), maxval)
    got, want = io_image.load_image(p), jio.load_image(p)
    assert got.dtype == want.dtype == np.uint8 and got.shape == shape[:2]
    np.testing.assert_array_equal(got, want)
    if len(shape) == 2:
        np.testing.assert_array_equal(got, io_image.load_pnm(p))
