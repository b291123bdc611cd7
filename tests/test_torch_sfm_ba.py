"""The port's bundle adjustment (hessgpu_tpu_torch/sfm/ba.py) on the CPU vs
the JAX package's (hessgpu_tpu/sfm/ba.py), on one seeded problem of 8
cameras x 256 points (every camera sees every other point, 0.5 px noise, one
observation in 37 moved 30 px, perturbed start).

Tolerances: so3_exp 1e-6 absolute; residuals at the zero increment 1e-5
relative to the largest projected pixel coordinate (float32 ulps there are
6e-5 px, and the two packages' products differ by 1-2 of them); the robust
weights 5e-5 absolute (those 1.2e-4 px through dw/dr <= 0.33 / delta);
_block_jacobi's inverse blocks 1e-4 relative to the largest entry; one
lm_step from the same state: cost0 1e-6 relative, cost1 1e-4 relative,
accepted equal, the new state 1e-4 absolute; bundle_adjust over 10
iterations with and without the Cauchy loss: RMSE 1e-3 px, poses 1e-3
absolute; prune_outliers: the same mask. The sums run in another order
than XLA's segment sums, and 30 PCG steps carry the last bits into the
step.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hessgpu_tpu.sfm import ba as jba
from hessgpu_tpu_torch.convert import ba_from_numpy
from hessgpu_tpu_torch.sfm import ba as tba
from _torch_threads import one_torch_thread  # noqa: F401

CAMS, PTS = 8, 256
# bundle_adjust runs: plain least squares (huber_delta 0 turns the robust
# loss off) and the Cauchy loss at 2 px
_BA_RUNS = {"plain": 0.0, "cauchy": 2.0}


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (PTS, 3)).astype(np.float32)
    X[:, 2] += 6.0
    w = rng.normal(0, 0.1, (CAMS, 3)).astype(np.float32)
    R = np.asarray(jba.so3_exp(jnp.asarray(w)))
    t = rng.normal(0, 0.3, (CAMS, 3)).astype(np.float32)
    intr = np.tile(np.array([800.0, 320.0, 240.0], np.float32), (CAMS, 1))
    ci = np.concatenate([np.full(PTS // 2, c) for c in range(CAMS)])
    pi = np.concatenate([np.arange(c % 2, PTS, 2) for c in range(CAMS)])
    xc = np.einsum("oij,oj->oi", R[ci], X[pi]) + t[ci]
    uv = xc[:, :2] / xc[:, 2:] * 800.0 + np.array([320.0, 240.0])
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    uv[::37] += 30.0                 # gross outliers for the robust losses
    weight = np.ones(len(ci), np.float32)
    t0 = (t + rng.normal(0, 0.05, t.shape)).astype(np.float32)
    X0 = (X + rng.normal(0, 0.05, X.shape)).astype(np.float32)
    return dict(R=R, t=t0, X=X0, intr=intr, cam_idx=ci, pt_idx=pi, uv=uv,
                weight=weight)


def _jax(p):
    return (jba.BAState(R=jnp.asarray(p["R"]), t=jnp.asarray(p["t"]),
                        X=jnp.asarray(p["X"]), intr=jnp.asarray(p["intr"])),
            jba.BAProblem(cam_idx=jnp.asarray(p["cam_idx"], jnp.int32),
                          pt_idx=jnp.asarray(p["pt_idx"], jnp.int32),
                          uv=jnp.asarray(p["uv"]),
                          weight=jnp.asarray(p["weight"])))


@pytest.fixture(scope="module")
def problem():
    return _problem()


@pytest.fixture(scope="module")
def jax_runs(problem):
    """The JAX package's results, each computed once for the module."""
    st, pr = _jax(problem)
    out = {"step": jba.lm_step(st, pr, jnp.asarray(1e-3), cg_iters=30)}
    for run, delta in _BA_RUNS.items():
        s, _ = jba.bundle_adjust(st, pr, iterations=10, huber_delta=delta,
                                 loss="cauchy")
        out[run] = (s, jba.reprojection_rmse(s, pr))
    out["pruned"] = jba.prune_outliers(out["cauchy"][0], pr, 4.0)
    return out


def _port(p):
    return ba_from_numpy(device="cpu", **p)


def test_so3_exp_matches_jax():
    rng = np.random.RandomState(3)
    w = np.concatenate([rng.randn(20, 3) * 0.8, np.zeros((1, 3)),
                        rng.randn(4, 3) * 1e-6]).astype(np.float32)
    want = np.asarray(jba.so3_exp(jnp.asarray(w)))
    got = tba.so3_exp(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    one = tba.so3_exp(torch.from_numpy(w[0])).numpy()
    np.testing.assert_allclose(one, want[0], rtol=0, atol=1e-6)


def test_residuals_at_zero_match_jax(problem):
    st, pr = _jax(problem)
    zero = (jnp.zeros((CAMS, 6)), jnp.zeros((PTS, 3)))
    want = np.asarray(jba._residual_fn(st, pr)(zero))
    ts, tp = _port(problem)
    got = tba._residuals(ts, tp).numpy()
    scale = np.abs(want + problem["uv"]).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def test_block_jacobi_matches_jax(problem):
    st, pr = _jax(problem)
    ts, tp = _port(problem)
    want = jba._block_jacobi(st, pr, 1e-3)
    got = tba._block_jacobi(ts, tp, torch.tensor(1e-3))
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_lm_step_matches_jax(problem, jax_runs):
    new_j, lam_j, c0_j, c1_j, acc_j = jax_runs["step"]
    ts, tp = _port(problem)
    new_t, lam_t, c0_t, c1_t, acc_t = tba.lm_step(ts, tp, torch.tensor(1e-3),
                                                  cg_iters=30)
    assert abs(float(c0_t) - float(c0_j)) <= 1e-6 * abs(float(c0_j))
    assert abs(float(c1_t) - float(c1_j)) <= 1e-4 * abs(float(c1_j))
    assert bool(acc_t) == bool(acc_j) and bool(acc_t)
    assert float(lam_t) == pytest.approx(float(lam_j), rel=1e-6)
    for f in ("R", "t", "X", "intr"):
        np.testing.assert_allclose(getattr(new_t, f).numpy(),
                                   np.asarray(getattr(new_j, f)),
                                   rtol=0, atol=1e-4, err_msg=f)


@pytest.mark.parametrize("run", list(_BA_RUNS))
def test_bundle_adjust_matches_jax(problem, jax_runs, run):
    """10 LM iterations, without and with the Cauchy loss."""
    want, rmse_j = jax_runs[run]
    ts, tp = _port(problem)
    got, cost = tba.bundle_adjust(ts, tp, iterations=10,
                                  huber_delta=_BA_RUNS[run], loss="cauchy")
    assert np.isfinite(cost)
    assert abs(tba.reprojection_rmse(got, tp) - rmse_j) <= 1e-3
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0,
                               atol=1e-3)


def test_robust_weights_match_jax(problem):
    st, pr = _jax(problem)
    ts, tp = _port(problem)
    for loss in ("huber", "cauchy"):
        want = np.asarray(jba.robust_weights(st, pr, 2.0, loss=loss))
        got = tba.robust_weights(ts, tp, 2.0, loss=loss)
        assert not got.requires_grad
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)
    with pytest.raises(ValueError):
        tba.robust_weights(ts, tp, 2.0, loss="l1")


def test_prune_outliers_matches_jax(problem, jax_runs):
    (want_prob, want_n) = jax_runs["pruned"]
    s = jax_runs["cauchy"][0]
    ts, tp = ba_from_numpy(np.asarray(s.R), np.asarray(s.t),
                           np.asarray(s.X), np.asarray(s.intr),
                           problem["cam_idx"], problem["pt_idx"],
                           problem["uv"], problem["weight"], device="cpu")
    got_prob, got_n = tba.prune_outliers(ts, tp, 4.0)
    assert got_n == want_n and got_n > 0
    np.testing.assert_array_equal(got_prob.weight.numpy(),
                                  np.asarray(want_prob.weight))
