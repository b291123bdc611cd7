"""The process-group route of the port's meshes against the in-process
route: two gloo ranks (one spawn) run detect_batch(mesh=), the row-sharded
detect + describe and bundle_adjust_sharded over a group of two, and every
rank's result is held to the same calls on local_mesh(2) in this process.

Tolerances: keypoint fields (x, y, sigma, theta, response, level, ftype,
valid) bit-equal - the same CPU kernels on the same rows; descriptors
within 2e-5, the bound for one frame's descriptors across two CPU
processes (PyTorch's CPU products take their summation order from
process-wide library state: tests/test_torch_server_wire.py); the
bundle adjustment's state and cost within 1e-5 relative (gloo's all_reduce
of two shards adds in its own order, and the products as above).
"""

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from hessgpu_tpu_torch import SiftConfig
from hessgpu_tpu_torch.convert import ba_from_numpy
from hessgpu_tpu_torch.ops.gaussian import blur
from hessgpu_tpu_torch.parallel.batch import detect_batch
from hessgpu_tpu_torch.parallel.distributed import local_mesh
from hessgpu_tpu_torch.parallel.spatial import sharded_detect_and_describe
from hessgpu_tpu_torch.sfm.distributed_ba import bundle_adjust_sharded
from hessgpu_tpu_torch.sfm.synthetic import texture_frame
from _torch_mesh_worker import rank_main
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_distributed_ba import _arrays

EXACT = ("x", "y", "sigma", "theta", "response", "level", "ftype", "valid")


def test_two_gloo_ranks_equal_the_in_process_mesh(tmp_path):
    frames = np.stack([texture_frame(i, 120, 160) for i in range(4)])
    rng = np.random.RandomState(42)
    image = blur(torch.from_numpy(rng.rand(512, 192).astype(np.float32))
                 [None], 2.0)[0].numpy()
    ba = _arrays()
    init = f"file://{tmp_path / 'rendezvous'}"
    mp.start_processes(rank_main, args=(2, init, frames, image, ba,
                                        str(tmp_path)),
                       nprocs=2, join=True, start_method="spawn")

    mesh = local_mesh(2)
    want = {}
    table = detect_batch(frames, SiftConfig(), mesh=mesh, device="cpu")
    want.update({f"batch_{k}": v.numpy() for k, v in
                 table._asdict().items()})
    table = sharded_detect_and_describe(
        image, SiftConfig(threshold=0.001, max_level_features=256), mesh,
        device="cpu")
    want.update({f"spatial_{k}": v.numpy() for k, v in
                 table._asdict().items()})
    state, prob = ba_from_numpy(**ba, device="cpu")
    state, cost = bundle_adjust_sharded(state, prob, mesh, iterations=3)
    want.update({f"ba_{k}": v.numpy() for k, v in state._asdict().items()})
    assert int(want["batch_valid"].sum()) > 100
    assert int(want["spatial_valid"].sum()) > 50

    for rank in range(2):
        got = np.load(tmp_path / f"rank{rank}.npz")
        for part in ("batch", "spatial"):
            for f in EXACT:
                np.testing.assert_array_equal(got[f"{part}_{f}"],
                                              want[f"{part}_{f}"],
                                              err_msg=f"{part}_{f}")
            np.testing.assert_allclose(got[f"{part}_desc"],
                                       want[f"{part}_desc"], rtol=0,
                                       atol=2e-5)
        for f in ("R", "t", "X"):
            np.testing.assert_allclose(got[f"ba_{f}"], want[f"ba_{f}"],
                                       rtol=1e-5, atol=1e-6)
        assert float(got["ba_cost"]) == pytest.approx(cost, rel=1e-5)
