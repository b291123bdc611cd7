"""The port's incremental reconstruction (hessgpu_tpu_torch/sfm/incremental.py)
on the CPU vs the JAX package's (hessgpu_tpu/sfm/incremental.py), on
tests/test_sfm.py's synthetic sequences (a camera moving past a seeded point
cloud; descriptors encode point identity).

The port draws its RANSAC samples as the JAX package does (sfm/prng.py
reproduces jax.random.choice under the same keys; held here index for
index), so it must reproduce the JAX run: the same view_ids and point
count, camera centres within 1e-3. Fed another random stream (a
torch.Generator per key) it must still meet the JAX tests' own bounds:
every view registered, ATE below 0.05 (the trajectory spans ~3 units). A
checkpoint written by the JAX package's sfm.io resumes in the port.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hessgpu_tpu.parallel.distributed import device_mesh as jax_device_mesh
from hessgpu_tpu.sfm import incremental as jinc
from hessgpu_tpu.sfm.io import save_reconstruction as jax_save
from hessgpu_tpu_torch.parallel.distributed import local_mesh
from hessgpu_tpu_torch.sfm import incremental as tinc
from hessgpu_tpu_torch.sfm import posegraph as tpg
from hessgpu_tpu_torch.sfm.evaluate import ate_rmse, camera_centers
from hessgpu_tpu_torch.sfm.io import load_reconstruction
from test_sfm import _synthetic_sequence
from _torch_threads import one_torch_thread  # noqa: F401


def _torch_sampler(seed, n, shape, probs, device):
    """Another random stream: torch.multinomial from a generator seeded
    with the key's integer."""
    g = torch.Generator().manual_seed(int(seed))
    idx = torch.multinomial(torch.as_tensor(probs, dtype=torch.float64),
                            int(np.prod(shape)), replacement=True,
                            generator=g)
    return idx.reshape(tuple(shape)).to(device)


def _ate(rec, Rs, ts):
    views = rec.view_ids
    return ate_rmse(camera_centers(rec.R, rec.t),
                    camera_centers([Rs[v] for v in views],
                                   [ts[v] for v in views]))


@pytest.fixture(scope="module")
def seq5():
    return _synthetic_sequence(np.random.RandomState(42))


@pytest.fixture(scope="module")
def jax_rec5(seq5):
    K, _, _, _, feats = seq5
    return jinc.reconstruct_sequence(feats, K, ba_every=2)


@pytest.mark.parametrize("seed", [0, 3, 39, 12034])
@pytest.mark.parametrize("n, shape, valid", [
    (300, (512, 8), 300), (57, (512, 8), 57), (128, (256, 6), 100),
    (2048, (256, 6), 1500)])
def test_sample_indices_are_the_jax_draws(seed, n, shape, valid):
    probs = (np.arange(n) < valid).astype(np.float32)
    probs = probs / probs.sum()
    want = jax.random.choice(jax.random.PRNGKey(seed), n, shape=shape,
                             p=jnp.asarray(probs))
    got = tinc.sample_indices(seed, n, shape, probs, "cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_the_port_reproduces_the_jax_run(seq5, jax_rec5):
    K, Rs, ts, _, feats = seq5
    rec = tinc.reconstruct_sequence(feats, K, ba_every=2, device="cpu")
    assert rec.view_ids == jax_rec5.view_ids == list(range(5))
    assert rec.num_points == jax_rec5.num_points
    np.testing.assert_allclose(camera_centers(rec.R, rec.t),
                               camera_centers(jax_rec5.R, jax_rec5.t),
                               rtol=0, atol=1e-3)
    # the host-side dtypes the JAX run leaves behind
    assert rec.points.dtype == jax_rec5.points.dtype
    assert [r.dtype for r in rec.R] == [r.dtype for r in jax_rec5.R]
    assert _ate(rec, Rs, ts) < 0.05


def test_the_cpu_run_repeats_itself(seq5):
    """ROADMAP Queue 3: the same features at the same thread count (one,
    this module's setting) reconstruct bit for bit twice. At four threads
    two runs of one process already part (the ordered segment sums of
    sfm/ba.py add from several threads at once on the CPU; see
    test_torch_sfm_ba.py::test_segment_sum_at_one_thread_is_the_serial_sum)."""
    K, _, _, _, feats = seq5
    a, b = (tinc.reconstruct_sequence(feats, K, ba_every=2, device="cpu")
            for _ in range(2))
    assert a.view_ids == b.view_ids and a.obs == b.obs
    for f in ("R", "t"):
        for x, y in zip(getattr(a, f), getattr(b, f)):
            assert x.tobytes() == y.tobytes()
    assert a.points.tobytes() == b.points.tobytes()


def test_another_random_stream_registers_every_view(seq5):
    K, Rs, ts, _, feats = seq5
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tinc, "sample_indices", _torch_sampler)
        rec = tinc.reconstruct_sequence(feats, K, ba_every=2, device="cpu")
    assert rec is not None and rec.view_ids == list(range(5))
    assert _ate(rec, Rs, ts) < 0.05


def test_loop_closure_runs_the_pose_graph():
    """12 views, loop_gap=6: loop candidates are verified and the pose graph
    runs (counted), every view is registered and ATE stays low."""
    K, Rs, ts, _, feats = _synthetic_sequence(np.random.RandomState(42),
                                              n_views=12, noise=0.2)
    calls = []
    real = tpg.optimize_pose_graph

    def counted(*a, **kw):
        calls.append(len(a[2].edge_i))
        return real(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpg, "optimize_pose_graph", counted)
        rec = tinc.reconstruct_sequence(feats, K, ba_every=3, loop_gap=6,
                                        device="cpu")
    assert rec.view_ids == list(range(12))
    assert len(calls) == 1 and calls[0] > 11      # odometry + loop edges
    assert _ate(rec, Rs, ts) < 0.05


def test_resume_from_a_jax_checkpoint(tmp_path):
    """A prefix reconstructed and saved by the JAX package resumes in the
    port over the full sequence."""
    K, Rs, ts, _, feats = _synthetic_sequence(np.random.RandomState(42),
                                              n_views=8)
    prefix = jinc.reconstruct_sequence(feats[:5], K, ba_every=2,
                                       loop_closure=False)
    path = str(tmp_path / "ckpt.npz")
    jax_save(path, prefix)
    loaded = load_reconstruction(path)
    assert loaded.view_ids == prefix.view_ids
    rec = tinc.reconstruct_sequence(feats, K, ba_every=2, resume=loaded,
                                    device="cpu")
    assert rec.view_ids == list(range(8))
    assert _ate(rec, Rs, ts) < 0.05


def test_a_missing_card_is_refused(seq5):
    K, _, _, _, feats = seq5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tinc.reconstruct_sequence(feats, K)     # device defaults to cuda


def test_a_mesh_reproduces_the_jax_mesh_run(seq5):
    """mesh=: every periodic and the final BA end with the distributed LM
    polish, the port's over a 2-shard in-process mesh, the JAX package's
    over 2 virtual CPU devices: the same view_ids and point count, camera
    centres within 1e-3 (the bound of the mesh=None run above)."""
    K, Rs, ts, _, feats = seq5
    want = jinc.reconstruct_sequence(feats, K, ba_every=2,
                                     mesh=jax_device_mesh("obs", 2))
    rec = tinc.reconstruct_sequence(feats, K, ba_every=2, mesh=local_mesh(2),
                                    device="cpu")
    assert rec.view_ids == want.view_ids == list(range(5))
    assert rec.num_points == want.num_points
    np.testing.assert_allclose(camera_centers(rec.R, rec.t),
                               camera_centers(want.R, want.t),
                               rtol=0, atol=1e-3)
    assert _ate(rec, Rs, ts) < 0.05


def test_the_mesh_polish_prunes_what_the_robust_solve_ignored(seq5):
    """A periodic BA's distributed polish is plain least squares: five
    observations of camera 2 moved 80 px pull the default polish (the JAX
    package's, polish_prune_px=0) 0.37 away in camera centre; the opt-in
    polish_prune_px=4 stays within 2e-3 of the reconstruction without them.
    On clean observations the two polishes are the same, bit for bit."""
    K, _, _, _, feats = seq5
    rec = tinc.reconstruct_sequence(feats, K, ba_every=2, device="cpu")
    bad = copy.deepcopy(rec)
    for i in [i for i, o in enumerate(bad.obs) if o[0] == 2][:5]:
        c, t, u, v = bad.obs[i]
        bad.obs[i] = (c, t, u + 80.0, v - 60.0)

    def centres(r, **kw):
        out = tinc.run_global_ba(copy.deepcopy(r), huber_delta=1.5,
                                 mesh=local_mesh(2), device="cpu", **kw)
        return camera_centers(out.R, out.t)

    clean = centres(rec)
    assert np.array_equal(clean, centres(rec, polish_prune_px=4.0))
    assert np.abs(centres(bad, polish_prune_px=4.0) - clean).max() < 2e-3
    assert np.abs(centres(bad) - clean).max() > 0.1
