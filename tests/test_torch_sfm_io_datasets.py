"""The port's checkpoints, dataset parsers and scene renderer
(hessgpu_tpu_torch/sfm/{io,datasets,synthetic}.py) on the CPU vs the JAX
package's.

Tolerances: none for the files (a .npz written by either package loads in
the other field for field; write_tum_sequence writes the same rgb.txt and
groundtruth.txt bytes and the same PNG pixels; the parsers return equal
arrays); render 1e-6 absolute (both are float64 NumPy, the textures equal).
The end-to-end run (render, detect, reconstruct on the CPU) is held to the
JAX tests' ATE bound, 0.05.
"""

import os

import numpy as np
import pytest
import torch

from hessgpu_tpu.sfm import datasets as jds
from hessgpu_tpu.sfm import incremental as jinc
from hessgpu_tpu.sfm import io as jio
from hessgpu_tpu.sfm import synthetic as jsyn
from hessgpu_tpu_torch import SiftConfig
from hessgpu_tpu_torch.convert import reconstruction_from_numpy
from hessgpu_tpu_torch.sfm import datasets as tds
from hessgpu_tpu_torch.sfm import incremental as tinc
from hessgpu_tpu_torch.sfm import io as tio
from hessgpu_tpu_torch.sfm import synthetic as tsyn
from _torch_threads import one_torch_thread  # noqa: F401


def _reconstruction(cls, seed=0):
    """A small Reconstruction of either package: float32 poses after a BA,
    float64 for the gauge camera, as reconstruct_sequence leaves them."""
    rng = np.random.RandomState(seed)
    R = [np.eye(3)] + [np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
                       for _ in range(3)]
    t = [np.zeros(3)] + [rng.randn(3).astype(np.float32) for _ in range(3)]
    obs = [(int(c), int(p), float(rng.rand() * 640), float(rng.rand() * 480))
           for c in range(4) for p in range(c, 20, 2)]
    track_of = {(v, f): int(rng.randint(20)) for v in (0, 2, 5, 6)
                for f in range(7)}
    return cls(R=R, t=t, K=np.diag([500.0, 500.0, 1.0]),
               points=rng.randn(20, 3).astype(np.float32), obs=obs,
               track_of=track_of, view_ids=[0, 2, 5, 6])


def _same(a, b):
    assert a.view_ids == b.view_ids and a.obs == b.obs
    assert a.track_of == b.track_of
    for f in ("R", "t"):
        x, y = np.stack(getattr(a, f)), np.stack(getattr(b, f))
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    for f in ("K", "points"):
        assert getattr(a, f).dtype == getattr(b, f).dtype
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_cross_between_the_packages(tmp_path, direction):
    path = str(tmp_path / "ckpt.npz")
    if direction == "jax_to_port":
        rec = _reconstruction(jinc.Reconstruction)
        jio.save_reconstruction(path, rec)
        back = tio.load_reconstruction(path)
        assert isinstance(back, tinc.Reconstruction)
    else:
        rec = _reconstruction(tinc.Reconstruction)
        tio.save_reconstruction(path, rec)
        back = jio.load_reconstruction(path)
    _same(back, jio.load_reconstruction(path))
    np.testing.assert_array_equal(np.stack(back.R), np.stack(rec.R))
    assert back.obs == rec.obs and back.track_of == rec.track_of
    with np.load(path) as z:
        _same(reconstruction_from_numpy(z), back)


@pytest.fixture(scope="module")
def tum_dirs(tmp_path_factory):
    """The same small sequence written by each package."""
    root = tmp_path_factory.mktemp("tum")
    out = {}
    for name, mod in (("jax", jsyn), ("port", tsyn)):
        d = str(root / name)
        out[name] = (d, mod.write_tum_sequence(d, n_frames=6, h=96, w=128))
    return out


def test_write_tum_sequence_matches_jax(tum_dirs):
    from PIL import Image

    (dj, mj), (dt, mt) = tum_dirs["jax"], tum_dirs["port"]
    np.testing.assert_array_equal(mt["K"], mj["K"])
    np.testing.assert_array_equal(mt["gt_centers"], mj["gt_centers"])
    for name in ("rgb.txt", "groundtruth.txt"):
        with open(os.path.join(dj, name), "rb") as a, \
                open(os.path.join(dt, name), "rb") as b:
            assert a.read() == b.read(), name
    names = sorted(os.listdir(os.path.join(dj, "rgb")))
    assert names == sorted(os.listdir(os.path.join(dt, "rgb")))
    assert len(names) == 6
    frames, K, Rs, cs = tsyn.tum_sequence(6, 96, 128)
    for i, n in enumerate(names):
        a = np.asarray(Image.open(os.path.join(dj, "rgb", n)))
        b = np.asarray(Image.open(os.path.join(dt, "rgb", n)))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(frames[i], a)   # the in-memory frames


def test_parsers_match_jax(tum_dirs, tmp_path):
    d = tum_dirs["port"][0]
    got = tds.load_tum_sequence(d)
    want = jds.load_tum_sequence(d)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    np.testing.assert_allclose(got["gt_centers"], tum_dirs["port"][1]
                               ["gt_centers"], atol=1e-6)
    sub = tds.load_tum_sequence(d, max_frames=2, stride=2)
    assert sub["image_paths"] == want["image_paths"][::2][:2]
    # the ground truth's quaternions parse back to the rotations
    _, _, Rs, _ = tsyn.tum_sequence(6, 96, 128)
    for q, R in zip(got["gt_quats"], Rs):
        np.testing.assert_allclose(tds.quat_to_rot(*q), R.T, atol=1e-5)
        np.testing.assert_allclose(tds.quat_to_rot(*q),
                                   jds.quat_to_rot(*q), atol=0)
    # KITTI: 3x4 camera-to-world rows, one pose a line
    path = str(tmp_path / "poses.txt")
    with open(path, "w") as fh:
        for R, c in zip(Rs, got["gt_centers"]):
            fh.write(" ".join(f"{v:.9f}" for v in np.hstack(
                [R.T, c[:, None]]).ravel()) + "\n")
        fh.write("\n")
    for a, b in zip(tds.load_kitti_poses(path), jds.load_kitti_poses(path)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tds.load_kitti_poses(path)[0],
                               np.transpose(Rs, (0, 2, 1)), atol=1e-8)


def test_render_matches_jax():
    planes_j = jsyn.corner_scene(np.random.RandomState(7))
    planes_t = tsyn.corner_scene(np.random.RandomState(7))
    for a, b in zip(planes_j, planes_t):
        np.testing.assert_array_equal(a.tex, b.tex)
    Rs, cs = tsyn.arc_trajectory(5, passes=2)
    Rj, cj = jsyn.arc_trajectory(5, passes=2)
    np.testing.assert_array_equal(Rs, Rj)
    np.testing.assert_array_equal(cs, cj)
    K = np.array([[86.4, 0, 48.0], [0, 86.4, 36.0], [0, 0, 1.0]])
    for i in (0, 3):
        want = jsyn.render(planes_j, K, Rj[i], cj[i], 72, 96)
        got = tsyn.render(planes_t, K, Rs[i], cs[i], 72, 96)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for R in Rs:
        q = tsyn.rot_to_quat(R.T)
        np.testing.assert_array_equal(q, jsyn.rot_to_quat(R.T))
        np.testing.assert_allclose(tds.quat_to_rot(*q), R.T, atol=1e-12)


def test_evaluate_sequence_ate_end_to_end_on_the_cpu(tmp_path):
    """8 frames at 240x320: render, HessianSift, reconstruct, ATE."""
    meta = tsyn.write_tum_sequence(str(tmp_path), n_frames=8, h=240, w=320)
    seq = tds.load_tum_sequence(str(tmp_path))
    res = tds.evaluate_sequence_ate(
        seq["image_paths"], seq["gt_centers"], K=meta["K"],
        cfg=SiftConfig(threshold=0.003), device="cpu")
    assert res["registered"] == 8 and res["points"] > 100
    assert res["ate"] < 0.05
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tds.evaluate_sequence_ate(seq["image_paths"][:2],
                                      seq["gt_centers"][:2], K=meta["K"])
