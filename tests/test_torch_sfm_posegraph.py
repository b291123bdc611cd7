"""The port's pose graph (hessgpu_tpu_torch/sfm/posegraph.py) on the CPU vs
the JAX package's (hessgpu_tpu/sfm/posegraph.py): a seeded 12-camera loop
with odometry and two loop-closure edges, every pose but the gauge drifted.

Tolerances: so3_log 1e-5 absolute on the round trip and against the JAX
package's; 20 Gauss-Newton iterations (40 CG steps each): poses 1e-4
absolute; graph_cost 1e-4 relative before, and below 1e-3 of it after.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hessgpu_tpu.sfm import posegraph as jpg
from hessgpu_tpu.sfm.ba import so3_exp as jso3_exp
from hessgpu_tpu_torch.sfm import posegraph as tpg
from hessgpu_tpu_torch.sfm.ba import so3_exp
from _torch_threads import one_torch_thread  # noqa: F401

C = 12


def _drifted_loop(seed=42):
    rng = np.random.RandomState(seed)
    Rs = np.stack([np.asarray(jso3_exp(jnp.asarray([0.0, 0.3 * c, 0.0])))
                   for c in range(C)]).astype(np.float64)
    ts = np.stack([np.array([np.cos(0.3 * c), 0.1 * c % 0.5,
                             np.sin(0.3 * c)]) for c in range(C)])
    edges = [(c, c + 1) for c in range(C - 1)] + [(0, C - 1), (0, C // 2)]
    ei = np.array([i for i, _ in edges])
    ej = np.array([j for _, j in edges])
    Rij = np.stack([Rs[j] @ Rs[i].T for i, j in edges])
    tij = np.stack([ts[j] - Rs[j] @ Rs[i].T @ ts[i] for i, j in edges])
    Rp, tp = Rs.copy(), ts.copy()
    for c in range(1, C):
        Rp[c] = np.asarray(jso3_exp(jnp.asarray(0.05 * rng.randn(3)))) @ Rp[c]
        tp[c] = tp[c] + 0.1 * rng.randn(3)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(ei=ei, ej=ej, Rij=f32(Rij), tij=f32(tij),
                w=np.ones(len(edges), np.float32), Rp=f32(Rp), tp=f32(tp),
                Rs=Rs, ts=ts)


@pytest.fixture(scope="module")
def loop():
    return _drifted_loop()


@pytest.fixture(scope="module")
def jax_run(loop):
    g = jpg.PoseGraph(edge_i=jnp.asarray(loop["ei"], jnp.int32),
                      edge_j=jnp.asarray(loop["ej"], jnp.int32),
                      R_ij=jnp.asarray(loop["Rij"]),
                      t_ij=jnp.asarray(loop["tij"]),
                      weight=jnp.asarray(loop["w"]))
    R, t = jpg.optimize_pose_graph(jnp.asarray(loop["Rp"]),
                                   jnp.asarray(loop["tp"]), g,
                                   iterations=20)
    return dict(R=np.asarray(R), t=np.asarray(t),
                cost0=jpg.graph_cost(loop["Rp"], loop["tp"], g))


def _graph(loop):
    t = torch.from_numpy
    return tpg.PoseGraph(edge_i=t(loop["ei"]), edge_j=t(loop["ej"]),
                         R_ij=t(loop["Rij"]), t_ij=t(loop["tij"]),
                         weight=t(loop["w"]))


def test_so3_log_round_trip_and_jax():
    rng = np.random.RandomState(0)
    w = np.concatenate([rng.randn(20, 3) * 0.8, rng.randn(3, 3) * 1e-7,
                        np.zeros((1, 3))]).astype(np.float32)
    R = so3_exp(torch.from_numpy(w))
    back = tpg.so3_log(R).numpy()
    np.testing.assert_allclose(back, w, rtol=0, atol=1e-5)
    want = np.asarray(jpg.so3_log(jnp.asarray(R.numpy())))
    np.testing.assert_allclose(back, want, rtol=0, atol=1e-5)


def test_optimize_pose_graph_matches_jax(loop, jax_run):
    g = _graph(loop)
    cost0 = tpg.graph_cost(loop["Rp"], loop["tp"], g)
    assert abs(cost0 - jax_run["cost0"]) <= 1e-4 * jax_run["cost0"]
    R, t = tpg.optimize_pose_graph(torch.from_numpy(loop["Rp"]),
                                   torch.from_numpy(loop["tp"]), g,
                                   iterations=20)
    np.testing.assert_allclose(R.numpy(), jax_run["R"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.numpy(), jax_run["t"], rtol=0, atol=1e-4)
    assert tpg.graph_cost(R, t, g) < 1e-3 * cost0
    # the gauge stays where it was
    np.testing.assert_array_equal(R[0].numpy(), loop["Rp"][0])
    np.testing.assert_array_equal(t[0].numpy(), loop["tp"][0])
