#!/usr/bin/env python3
"""match_sharded over a torch.distributed group: one process per card
(nccl), or per CPU process (gloo, --device cpu), on bench_match.py's table.

    python3 scripts/torch_match_ranks.py [--ranks 4] [--n 65536] [--n2-tile 16384] [--device cuda]

Every rank runs the mesh route; each must return the full (N1,) result,
equal to the one-device route that rank 0 runs alone on its own card
(mutual-best and rows only). Rank 0 then times the mesh route (warm-up,
best of 3 windows of >= 1 s, every rep) and prints one JSON line, then
nvidia-smi's name and power limit. Exits non-zero on any mismatch.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def worker(rank, world, init, n, tile, device, out):
    sys.path.insert(0, REPO)
    from hessgpu_tpu_torch.parallel import distributed as td
    from hessgpu_tpu_torch.utils.timing import synchronize
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from torch_match_tiles import bench_descriptors

    td.initialize(init, world, rank, device=device)
    try:
        dev = torch.device(device, rank) if device == "cuda" \
            else torch.device("cpu")
        mesh = td.device_mesh("rows")
        d1, d2 = (torch.from_numpy(a).to(dev) for a in bench_descriptors(n))
        rep = {"rank": rank}
        for mutual in (True, False):
            got = td.match_sharded(d1, d2, mesh, mutual_best=mutual,
                                   n2_tile=tile, device=dev)
            key = "mutual" if mutual else "rows"
            if rank == 0:
                one = td.match_sharded(d1, d2, mutual_best=mutual,
                                       n2_tile=tile, device=dev)
                rep[f"{key}_equal_one_device"] = bool(torch.equal(got, one))
                rep[f"{key}_matches"] = int((got >= 0).sum())
            gathered = [torch.empty_like(got) for _ in range(world)]
            dist.all_gather(gathered, got)
            rep[f"{key}_ranks_agree"] = all(torch.equal(g, got)
                                            for g in gathered)
        times = []
        for w in range(4):                   # a warm-up, then 3 windows
            dist.barrier()
            calls, t0 = 0, time.perf_counter()
            while True:
                td.match_sharded(d1, d2, mesh, n2_tile=tile, device=dev)
                synchronize(dev)
                calls += 1
                flag = torch.tensor([time.perf_counter() - t0 >= 1.0],
                                    dtype=torch.int32, device=dev)
                dist.all_reduce(flag, op=dist.ReduceOp.MIN)
                if bool(flag.item()):
                    break
            if w:
                times.append((time.perf_counter() - t0) / calls)
        if rank == 0:
            s = min(times)
            rep.update(ranks=world, n=n, n2_tile=tile, device=device,
                       seconds_per_table=s, seconds_reps=times,
                       gpairs_per_s=n * n / s / 1e9)
            with open(out, "w") as f:
                json.dump(rep, f)
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=None)
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--n2-tile", type=int, default=16384)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device")
    ranks = args.ranks or (torch.cuda.device_count()
                           if args.device == "cuda" else 4)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        mp.start_processes(worker, args=(ranks, f"file://{tmp}/rendezvous",
                                         args.n, args.n2_tile, args.device,
                                         out),
                           nprocs=ranks, join=True, start_method="spawn")
        with open(out) as f:
            rep = json.load(f)
    print(json.dumps(rep), flush=True)
    if not all(v for k, v in rep.items() if k.endswith(("_equal_one_device",
                                                        "_ranks_agree"))):
        sys.exit("the mesh route differs from one device")
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
