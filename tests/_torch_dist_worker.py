"""One rank of the port's two-process matching test
(tests/test_torch_distributed.py): joins a gloo group through a file:// init
method, runs match_sharded over the mesh of both ranks on the CPU, and saves
its full (N1,) result per case. Imports torch and the port only."""

import numpy as np
import torch


def rank_main(rank, world, init_url, cases, out_dir):
    from hessgpu_tpu_torch.parallel import distributed as td

    torch.set_num_threads(1)
    td.initialize(init_url, world, rank, device="cpu")
    try:
        mesh = td.device_mesh("rows")
        assert (mesh.size, mesh.rank) == (world, rank)
        for name, (d1, d2, kw) in cases.items():
            got = td.match_sharded(d1, d2, mesh, device="cpu", **kw)
            np.save(f"{out_dir}/{name}_rank{rank}.npy", got.numpy())
    finally:
        torch.distributed.destroy_process_group()
