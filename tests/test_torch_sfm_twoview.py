"""The port's two-view geometry (hessgpu_tpu_torch/sfm/twoview.py) on the
CPU vs the JAX package's (hessgpu_tpu/sfm/twoview.py), on seeded scenes: 300
points seen by two cameras, 0.3 px noise, 60 outliers that lie at least 6 px
(Sampson) off their epipolar lines, 100 of them 2D-3D for PnP with 20
outliers at least 30 px off.

Tolerances: eight_point's F and sampson_error 1e-4 relative to the largest
entry, F after scaling to unit norm and the sign of its largest entry (the
SVDs' sign conventions differ between the libraries); the RANSAC cores fed
the indices jax.random.choice draws for the same key: inlier masks equal
(the margins above are far outside float32 noise), F 1e-4 as above, PnP R
and t 1e-3 absolute (a 6-point DLT through a 12 x 12 SVD in float32 carries
the libraries' last-bit differences to 1e-4); recover_pose on the same E:
R and t 1e-4 absolute after cheirality, the front mask equal; triangulate
1e-4 relative to each point's norm; type_aware_match_mask equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hessgpu_tpu.sfm import twoview as jtv
from hessgpu_tpu.sfm.ba import so3_exp
from hessgpu_tpu_torch.sfm import twoview as ttv
from _torch_threads import one_torch_thread  # noqa: F401

K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
N, N_OUT = 300, 60
N_PNP, N_PNP_OUT = 100, 20


def _project(X, R, t):
    xc = X @ R.T + t
    return xc[:, :2] / xc[:, 2:] * K[0, 0] + K[:2, 2]


def _sampson(F, a, b):
    x1 = np.concatenate([a, np.ones((len(a), 1))], 1)
    x2 = np.concatenate([b, np.ones((len(b), 1))], 1)
    Fx1, Ftx2 = x1 @ F.T, x2 @ F
    num = np.sum(x2 * Fx1, 1) ** 2
    return num / (Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + Ftx2[:, 0] ** 2
                  + Ftx2[:, 1] ** 2)


def _scene(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(N, 3) * np.array([6, 4, 6]) + np.array([-3, -2, 4])
    R2 = np.asarray(so3_exp(jnp.asarray([0.05, 0.2, -0.03])), np.float64)
    t2 = np.array([-2.0, 0.2, 0.3])
    p1 = _project(X, np.eye(3), np.zeros(3))
    p2 = _project(X, R2, t2)
    p1 = p1 + rng.randn(N, 2) * 0.3
    p2 = p2 + rng.randn(N, 2) * 0.3
    tx = np.array([[0, -t2[2], t2[1]], [t2[2], 0, -t2[0]],
                   [-t2[1], t2[0], 0]])
    Kinv = np.linalg.inv(K)
    F_true = Kinv.T @ tx @ R2 @ Kinv
    out = rng.choice(N, N_OUT, replace=False)
    for i in out:                # outliers well off their epipolar lines
        while True:
            p2[i] = rng.rand(2) * [640, 480]
            if _sampson(F_true, p1[i:i + 1], p2[i:i + 1])[0] > 36.0:
                break
    inl = np.ones(N, bool)
    inl[out] = False
    assert _sampson(F_true, p1[inl], p2[inl]).max() < 1.0
    # PnP: camera 2 from the first N_PNP points, 20 of them moved >= 30 px
    uv = _project(X[:N_PNP], R2, t2) + rng.randn(N_PNP, 2) * 0.3
    pout = rng.choice(N_PNP, N_PNP_OUT, replace=False)
    uv[pout] += rng.choice([-1, 1], (N_PNP_OUT, 2)) * (30 + rng.rand(
        N_PNP_OUT, 2) * 40)
    pnp_inl = np.ones(N_PNP, bool)
    pnp_inl[pout] = False
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(X=f32(X), p1=f32(p1), p2=f32(p2), inl=inl, R2=R2, t2=t2,
                F_true=F_true, uv=f32(uv), pnp_X=f32(X[:N_PNP]),
                pnp_inl=pnp_inl)


def _canon(F):
    F = np.asarray(F, np.float64)
    F = F / np.linalg.norm(F)
    return F * np.sign(F.flat[np.argmax(np.abs(F))])


def _close(a, b, rel=1e-4):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() <= rel * np.abs(b).max()


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module")
def jax_runs(scene):
    """Every JAX reference once: the sample indices for key 0, the RANSAC
    results, eight_point, the essential matrix and pose, triangulation."""
    s = scene
    p1, p2 = jnp.asarray(s["p1"]), jnp.asarray(s["p2"])
    valid = jnp.ones(N, bool)
    key = jax.random.PRNGKey(0)
    # the indices ransac_fundamental draws inside its jit for this key
    probs = valid.astype(jnp.float32)
    fidx = jax.random.choice(key, N, shape=(512, 8),
                             p=probs / jnp.sum(probs))
    fres = jtv.ransac_fundamental(key, p1, p2, valid)
    pvalid = jnp.asarray(np.arange(128) < N_PNP)
    X = np.zeros((128, 3), np.float32)
    uv = np.zeros((128, 2), np.float32)
    X[:N_PNP], uv[:N_PNP] = s["pnp_X"], s["uv"]
    probs = pvalid.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1e-12)
    pidx = jax.random.choice(key, 128, shape=(256, 6), p=probs)
    pres = jtv.ransac_pnp(key, jnp.asarray(X), jnp.asarray(uv), pvalid,
                          jnp.asarray(K, jnp.float32))
    E = jtv.essential_from_fundamental(fres.F, jnp.asarray(K, jnp.float32),
                                       jnp.asarray(K, jnp.float32))
    pose = jtv.recover_pose(E, p1, p2, jnp.asarray(K, jnp.float32),
                            jnp.asarray(K, jnp.float32), valid=fres.inliers)
    P1 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    P2 = np.concatenate([s["R2"], s["t2"][:, None]], 1).astype(np.float32)
    n1 = ((s["p1"] - K[:2, 2]) / K[0, 0]).astype(np.float32)
    n2 = ((s["p2"] - K[:2, 2]) / K[0, 0]).astype(np.float32)
    tri = jtv.triangulate(jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(n1),
                          jnp.asarray(n2))
    return dict(
        fidx=np.asarray(fidx), fres=fres, pidx=np.asarray(pidx), pres=pres,
        pnp_X=X, pnp_uv=uv, pnp_valid=np.asarray(pvalid),
        eight=np.asarray(jtv.eight_point(p1[:40], p2[:40])),
        sampson=np.asarray(jtv.sampson_error(jnp.asarray(
            s["F_true"], jnp.float32), p1, p2)),
        E=np.asarray(E), pose=[np.asarray(a) for a in pose],
        tri=(P1, P2, n1, n2, np.asarray(tri)))


def test_eight_point_and_sampson_match_jax(scene, jax_runs):
    t = torch.from_numpy
    F = ttv.eight_point(t(scene["p1"][:40]), t(scene["p2"][:40])).numpy()
    assert _close(_canon(F), _canon(jax_runs["eight"]))
    assert abs(F[2, 2] - 1.0) < 1e-6
    err = ttv.sampson_error(t(scene["F_true"].astype(np.float32)),
                            t(scene["p1"]), t(scene["p2"])).numpy()
    assert _close(err, jax_runs["sampson"])


def test_ransac_fundamental_core_matches_jax(scene, jax_runs):
    t = torch.from_numpy
    want = jax_runs["fres"]
    got = ttv.ransac_fundamental_from_samples(
        t(jax_runs["fidx"].astype(np.int64)), t(scene["p1"]), t(scene["p2"]),
        torch.ones(N, dtype=torch.bool))
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    np.testing.assert_array_equal(got.inliers.numpy(), scene["inl"])
    assert int(got.num_inliers) == int(want.num_inliers) == N - N_OUT
    assert _close(_canon(got.F.numpy()), _canon(want.F))


def test_ransac_pnp_core_matches_jax(scene, jax_runs):
    t = torch.from_numpy
    want = jax_runs["pres"]
    got = ttv.ransac_pnp_from_samples(
        t(jax_runs["pidx"].astype(np.int64)), t(jax_runs["pnp_X"]),
        t(jax_runs["pnp_uv"]), t(jax_runs["pnp_valid"]),
        t(K.astype(np.float32)))
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    np.testing.assert_array_equal(got.inliers.numpy()[:N_PNP],
                                  scene["pnp_inl"])
    assert int(got.num_inliers) == int(want.num_inliers)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0,
                               atol=1e-3)


def test_public_ransacs_draw_from_a_generator(scene, jax_runs):
    """The sampling wrappers: a torch.Generator's draws find the same
    inliers, and the same seed gives the same result."""
    t = torch.from_numpy
    runs = [ttv.ransac_fundamental(
        t(scene["p1"]), t(scene["p2"]), torch.ones(N, dtype=torch.bool),
        generator=torch.Generator().manual_seed(5)) for _ in range(2)]
    assert torch.equal(runs[0].F, runs[1].F)
    np.testing.assert_array_equal(runs[0].inliers.numpy(), scene["inl"])
    pnp = ttv.ransac_pnp(t(jax_runs["pnp_X"]), t(jax_runs["pnp_uv"]),
                         t(jax_runs["pnp_valid"]), t(K.astype(np.float32)),
                         generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(pnp.inliers.numpy()[:N_PNP],
                                  scene["pnp_inl"])
    assert not pnp.inliers.numpy()[N_PNP:].any()


def test_essential_and_recover_pose_match_jax(scene, jax_runs):
    t = torch.from_numpy
    Kt = t(K.astype(np.float32))
    F = t(np.asarray(jax_runs["fres"].F))
    E = ttv.essential_from_fundamental(F, Kt, Kt).numpy()
    assert _close(_canon(E), _canon(jax_runs["E"]))
    R, tt, X, front = ttv.recover_pose(
        t(jax_runs["E"]), t(scene["p1"]), t(scene["p2"]), Kt, Kt,
        valid=t(np.asarray(jax_runs["fres"].inliers)))
    Rj, tj, Xj, fj = jax_runs["pose"]
    np.testing.assert_allclose(R.numpy(), Rj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), tj, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(front.numpy(), fj)
    assert _close(X.numpy()[fj], Xj[fj])
    # and the truth: the rotation, and the baseline's direction
    np.testing.assert_allclose(R.numpy(), scene["R2"], atol=1e-2)
    tdir = scene["t2"] / np.linalg.norm(scene["t2"])
    assert np.dot(tt.numpy(), tdir) > 0.99


def test_triangulate_matches_jax(jax_runs):
    P1, P2, n1, n2, want = jax_runs["tri"]
    t = torch.from_numpy
    got = ttv.triangulate(t(P1), t(P2), t(n1), t(n2)).numpy()
    err = np.linalg.norm(got - want, axis=1)
    assert (err <= 1e-4 * np.linalg.norm(want, axis=1)).all()


def test_type_aware_match_mask_matches_jax():
    rng = np.random.RandomState(1)
    a = rng.randint(0, 3, 50).astype(np.int32)
    b = rng.randint(0, 3, 40).astype(np.int32)
    want = np.asarray(jtv.type_aware_match_mask(jnp.asarray(a),
                                                jnp.asarray(b)))
    got = ttv.type_aware_match_mask(torch.from_numpy(a),
                                    torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
