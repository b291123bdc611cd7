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

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hessgpu_tpu.sfm import incremental as jinc
from hessgpu_tpu.sfm.io import save_reconstruction as jax_save
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


def test_mesh_and_a_missing_card_are_refused(seq5):
    K, _, _, _, feats = seq5
    with pytest.raises(NotImplementedError, match="distributed"):
        tinc.reconstruct_sequence(feats, K, mesh=object(), device="cpu")
    rec = tinc.Reconstruction(R=[np.eye(3)], t=[np.zeros(3)], K=K,
                              points=np.zeros((0, 3)), obs=[], track_of={})
    with pytest.raises(NotImplementedError, match="distributed"):
        tinc.run_global_ba(rec, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tinc.reconstruct_sequence(feats, K)     # device defaults to cuda
