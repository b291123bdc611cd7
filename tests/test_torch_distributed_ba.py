"""The port's distributed bundle adjustment
(hessgpu_tpu_torch/sfm/distributed_ba.py) on the CPU against the JAX
package's (hessgpu_tpu/sfm/distributed_ba.py) on its 8 virtual CPU devices
(tests/conftest.py), on tests/test_ba.py's problem (4 cameras x 60 points,
perturbed start, no noise) and on tests/test_torch_sfm_ba.py's (8 cameras x
256 points, 0.5 px noise, outliers).

Tolerances: pad_problem equal, element for element; one sharded LM step
from the same state at n = 8 on the noisy problem: cost0 within 1e-5
relative and cost1 within 1e-4 relative of the JAX step's (the psum's order
and the segment sums' differ from XLA's, and 30 PCG steps carry the last
bits). On the noise-free problem one step takes the cost from 1e4 to ~1,
the round-off floor, where the JAX package's own step moves by 40% between
meshes of 1, 2 and 8 devices; that problem is held to the convergence
bounds only. 12 iterations
converge as tests/test_distributed_ba.py asks of the JAX package:
translations within 1e-2 of the one-device solve, RMSE within 0.02 px of
it. The in-process mesh repeats itself bit for bit, and a one-shard mesh is
the one-device step bit for bit.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hessgpu_tpu.parallel.distributed import device_mesh as jax_device_mesh
from hessgpu_tpu.sfm import distributed_ba as jdba
from hessgpu_tpu_torch.convert import ba_from_numpy
from hessgpu_tpu_torch.parallel.distributed import local_mesh
from hessgpu_tpu_torch.sfm import ba as tba
from hessgpu_tpu_torch.sfm import distributed_ba as tdba
from test_ba import _make_problem
from test_torch_sfm_ba import _problem as _noisy_problem
from _torch_graph_route import graph_route  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401


def _arrays(seed=42):
    _, init, prob = _make_problem(np.random.RandomState(seed))
    return {f: np.asarray(v) for f, v in
            list(init._asdict().items()) + list(prob._asdict().items())}


def _port(a):
    return ba_from_numpy(**a, device="cpu")


@pytest.mark.parametrize("n_obs, multiple", [(240, 8), (237, 8), (13, 3)])
def test_pad_problem_matches_jax(n_obs, multiple):
    a = _arrays()
    a = {**a, **{f: a[f][:n_obs] for f in ("cam_idx", "pt_idx", "uv",
                                             "weight")}}
    _, prob = _port(a)
    got = tdba.pad_problem(prob, multiple)
    want = jdba.pad_problem(jdba.BAProblem(
        cam_idx=jnp.asarray(a["cam_idx"]), pt_idx=jnp.asarray(a["pt_idx"]),
        uv=jnp.asarray(a["uv"]), weight=jnp.asarray(a["weight"])), multiple)
    assert got.cam_idx.shape[0] % multiple == 0
    for f in ("cam_idx", "pt_idx", "uv", "weight"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


@functools.lru_cache(maxsize=None)
def _jax_step_costs():
    """cost0 and cost1 of the JAX package's sharded step at n = 8 on the
    noisy problem, run once per process."""
    a = _noisy_problem()
    mesh = jax_device_mesh("obs", 8)
    jstate = jdba.BAState(R=jnp.asarray(a["R"]), t=jnp.asarray(a["t"]),
                          X=jnp.asarray(a["X"]), intr=jnp.asarray(a["intr"]))
    jprob = jdba.pad_problem(jdba.BAProblem(
        cam_idx=jnp.asarray(a["cam_idx"], jnp.int32),
        pt_idx=jnp.asarray(a["pt_idx"], jnp.int32),
        uv=jnp.asarray(a["uv"]), weight=jnp.asarray(a["weight"])), 8)
    _, _, jc0, jc1 = jdba.make_sharded_lm_step(mesh)(
        jstate, jnp.asarray(1e-3), *jprob)
    return float(jc0), float(jc1)


def _check_one_step():
    jc0, jc1 = _jax_step_costs()
    state, prob = _port(_noisy_problem())
    step = tdba.make_sharded_lm_step(local_mesh(8))
    _, lam, c0, c1 = step(state, torch.tensor(1e-3),
                          tdba.pad_problem(prob, 8))
    np.testing.assert_allclose(float(c0), jc0, rtol=1e-5)
    np.testing.assert_allclose(float(c1), jc1, rtol=1e-4)
    assert float(c1) < float(c0) and float(lam) == pytest.approx(5e-4)


def test_one_sharded_step_matches_jax():
    _check_one_step()


def test_the_captured_sharded_step_matches_jax(graph_route):
    """The function a card captures for the step on an in-process mesh
    (the whole step, key (mesh size, cg_iters, fix_first_cam)), run here by
    the graph_route fixture."""
    _check_one_step()
    assert [c.key for c in graph_route] == [(8, 30, True)]
    assert graph_route[0].cache is tdba._SHARDED_LM_GRAPHS


def test_twelve_iterations_converge_like_the_local_solve():
    a = _arrays()
    state, prob = _port(a)
    out_l, _ = tba.bundle_adjust(state, prob, iterations=12)
    out_s, _ = tdba.bundle_adjust_sharded(state, prob, local_mesh(8),
                                          iterations=12)
    np.testing.assert_allclose(out_s.t.numpy(), out_l.t.numpy(), atol=1e-2)
    rms_l = tba.reprojection_rmse(out_l, prob)
    rms_s = tba.reprojection_rmse(out_s, prob)
    assert abs(rms_l - rms_s) < 0.02 and rms_s < 0.05, (rms_l, rms_s)


def test_the_in_process_mesh_repeats_and_one_shard_is_the_local_step():
    a = _arrays()
    state, prob = _port(a)
    lam = torch.tensor(1e-3)
    runs = [tdba.make_sharded_lm_step(local_mesh(4))(state, lam, prob)
            for _ in range(2)]
    for x, y in zip(runs[0][0], runs[1][0]):
        assert x.numpy().tobytes() == y.numpy().tobytes()
    one = tdba.make_sharded_lm_step(local_mesh(1))(state, lam, prob)
    local = tba.lm_step(state, prob, lam)
    for x, y in zip(one[0], local[0]):
        assert x.numpy().tobytes() == y.numpy().tobytes()
    assert float(one[2]) == float(local[2])
    assert float(one[3]) == float(local[3])
