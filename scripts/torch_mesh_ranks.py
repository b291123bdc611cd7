#!/usr/bin/env python3
"""The multi-device layer over a torch.distributed group: one process per
card (nccl), or per CPU process (gloo, --device cpu).

    python3 scripts/torch_mesh_ranks.py [--ranks 4] [--height 4032]
        [--width 6048] [--batch 16] [--ba-iters 10] [--device cuda]

Every rank runs, over the group's mesh: sharded_detect_and_describe on one
--height x --width frame (make_texture's blobs at the 640x480 frames'
density, seed 3, default SiftConfig), detect_batch on --batch 640x480
textures, and bundle_adjust_sharded on bench_ba.py's problem
(chip_smoke.ba_problem). Rank 0 also runs each on its own card alone: the
in-process mesh of as many shards (local_mesh), and the one-device call.
Checks: the group's spatial table equal, field for field, to the in-process
mesh's; the group's batch table equal to detect_batch without a mesh; the
group's BA state within 1e-4 relative of the in-process mesh's (all_reduce
adds in the backend's order, and 30 CG steps an iteration carry the last
bits). Times (host clock around work that ends in a synchronize, the ranks
meeting at a barrier first; 5 runs after a warm-up): ms per frame and per
batch, LM iterations/s. Prints one JSON line, then nvidia-smi's name and
power limit. Exits non-zero on any mismatch.
"""

import argparse
import json
import os
import statistics
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

REPS = 5


def worker(rank, world, init, args, out):
    sys.path.insert(0, REPO)
    from chip_smoke import BA_CG_ITERS, ba_problem
    from hessgpu_tpu_torch import SiftConfig, detect_and_describe, detect_batch
    from hessgpu_tpu_torch.convert import ba_from_numpy
    from hessgpu_tpu_torch.parallel import distributed as td
    from hessgpu_tpu_torch.parallel.spatial import sharded_detect_and_describe
    from hessgpu_tpu_torch.sfm.distributed_ba import bundle_adjust_sharded
    from hessgpu_tpu_torch.sfm.synthetic import make_texture, texture_frame
    from hessgpu_tpu_torch.utils.timing import synchronize

    td.initialize(init, world, rank, device=args.device)
    try:
        dev = torch.device(args.device, rank) if args.device == "cuda" \
            else torch.device("cpu")
        if args.device == "cpu":
            torch.set_num_threads(1)
        mesh = td.device_mesh("rows")
        local = td.local_mesh(world)
        side = max(args.height, args.width)
        blobs = int(900 * (side / 640.0) ** 2)
        image = make_texture(np.random.RandomState(3), side,
                             blobs)[:args.height, :args.width]
        img = torch.from_numpy(np.ascontiguousarray(image)).to(dev)
        frames = torch.from_numpy(np.stack([
            texture_frame(s, 480, 640) for s in range(args.batch)])).to(dev)
        cfg = SiftConfig()
        st, pr = ba_from_numpy(device=dev, **ba_problem())

        def timed(fn, group=True):
            fn()
            ms = []
            for _ in range(REPS):
                if group:
                    dist.barrier()
                synchronize(dev)
                t0 = time.perf_counter()
                fn()
                synchronize(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
            return ms

        ba = lambda m: bundle_adjust_sharded(st, pr, m,
                                             iterations=args.ba_iters,
                                             cg_iters=BA_CG_ITERS)
        rep = {"rank": rank}
        spatial = sharded_detect_and_describe(img, cfg, mesh, device=dev)
        batch = detect_batch(frames, cfg, mesh=mesh, device=dev)
        ba_out, _ = ba(mesh)
        rep["spatial_ms"] = timed(lambda: sharded_detect_and_describe(
            img, cfg, mesh, device=dev))
        rep["batch_ms"] = timed(lambda: detect_batch(frames, cfg, mesh=mesh,
                                                     device=dev))
        ba_ms = timed(lambda: ba(mesh))
        rep["ba_lm_iters_per_s"] = [args.ba_iters / (t / 1e3) for t in ba_ms]
        if rank == 0:
            one_sp = sharded_detect_and_describe(img, cfg, local, device=dev)
            rep["spatial_equal_in_process"] = all(
                torch.equal(getattr(spatial, f), getattr(one_sp, f))
                for f in spatial._fields)
            one_b = detect_batch(frames, cfg, device=dev)
            rep["batch_equal_mesh_none"] = all(
                torch.equal(getattr(batch, f), getattr(one_b, f))
                for f in batch._fields)
            ba_in, _ = ba(local)
            rep["ba_max_rel_diff_in_process"] = max(
                float((getattr(ba_out, f) - getattr(ba_in, f)).abs().max()
                      / getattr(ba_in, f).abs().max()) for f in ("R", "t",
                                                                "X"))
            rep["features"] = int(spatial.count())
            rep["in_process_spatial_ms"] = timed(
                lambda: sharded_detect_and_describe(img, cfg, local,
                                                    device=dev), False)
            rep["one_device_spatial_ms"] = timed(
                lambda: detect_and_describe(image, cfg, device=dev), False)
            rep["one_device_batch_ms"] = timed(
                lambda: detect_batch(frames, cfg, device=dev), False)
            rep["in_process_ba_lm_iters_per_s"] = [
                args.ba_iters / (t / 1e3) for t in timed(lambda: ba(local),
                                                         False)]
        gathered = [None] * world
        dist.all_gather_object(gathered, rep)
        if rank == 0:
            for r in gathered:
                for k in ("spatial_ms", "batch_ms"):
                    r[f"{k}_median"] = statistics.median(r[k])
            with open(out, "w") as f:
                json.dump({"ranks": world, "device": args.device,
                           "height": args.height, "width": args.width,
                           "batch": args.batch, "ba_iters": args.ba_iters,
                           "per_rank": gathered}, f)
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=None)
    ap.add_argument("--height", type=int, default=4032)
    ap.add_argument("--width", type=int, default=6048)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ba-iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device")
    ranks = args.ranks or (torch.cuda.device_count()
                           if args.device == "cuda" else 4)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        mp.start_processes(worker, args=(ranks, f"file://{tmp}/rendezvous",
                                         args, out),
                           nprocs=ranks, join=True, start_method="spawn")
        with open(out) as f:
            rep = json.load(f)
    print(json.dumps(rep), flush=True)
    r0 = rep["per_rank"][0]
    if not (r0["spatial_equal_in_process"] and r0["batch_equal_mesh_none"]
            and r0["ba_max_rel_diff_in_process"] <= 1e-4):
        sys.exit("the group's route differs from the in-process one")
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
