"""One rank of the port's two-process mesh test
(tests/test_torch_mesh_ranks.py): joins a gloo group through a file:// init
method and runs the batch mesh, the row-sharded detect + describe and the
distributed bundle adjustment over the mesh of both ranks on the CPU,
saving every rank's results. Imports torch and the port only."""

import numpy as np
import torch


def rank_main(rank, world, init_url, frames, image, ba_arrays, out_dir):
    from hessgpu_tpu_torch import SiftConfig
    from hessgpu_tpu_torch.convert import ba_from_numpy
    from hessgpu_tpu_torch.parallel import distributed as td
    from hessgpu_tpu_torch.parallel.batch import detect_batch
    from hessgpu_tpu_torch.parallel.spatial import sharded_detect_and_describe
    from hessgpu_tpu_torch.sfm.distributed_ba import bundle_adjust_sharded

    torch.set_num_threads(1)
    td.initialize(init_url, world, rank, device="cpu")
    try:
        mesh = td.device_mesh("rows")
        out = {}
        table = detect_batch(frames, SiftConfig(), mesh=mesh, device="cpu")
        out.update({f"batch_{k}": v.numpy() for k, v in
                    table._asdict().items()})
        table = sharded_detect_and_describe(
            image, SiftConfig(threshold=0.001, max_level_features=256),
            mesh, device="cpu")
        out.update({f"spatial_{k}": v.numpy() for k, v in
                    table._asdict().items()})
        state, prob = ba_from_numpy(**ba_arrays, device="cpu")
        state, cost = bundle_adjust_sharded(state, prob, mesh, iterations=3)
        out.update({f"ba_{k}": v.numpy() for k, v in
                    state._asdict().items()})
        out["ba_cost"] = np.float64(cost)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        torch.distributed.destroy_process_group()
