#!/usr/bin/env python3
"""bench_match.py's table (seed 0, N1 = N2 = 65536, d2 = d1 rolled by 7)
through the port's match_sharded on one card, at several column tiles.

    python3 scripts/torch_match_tiles.py [--n 65536] [--tiles 4096,8192,16384,32768,65536] [--device cuda]

Per tile, one JSON line: seconds per table (warm-up, then the best of 3
windows of >= 1 s, every rep), Gpairs/s, rows per block, peak memory above
the inputs, and the result equal to the first tile's. Then the device work
of one table at the first tile of 16384 or the first given (torch.profiler:
ms and launches by kernel), and the guided table (an H gate) at that tile.
Ends with nvidia-smi's name and power limit. --device cpu runs the same at a
small --n (a rehearsal: no device numbers).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hessgpu_tpu_torch.parallel import distributed as td  # noqa: E402
from hessgpu_tpu_torch.utils.timing import device_profile, synchronize  # noqa: E402


def bench_descriptors(n):
    """bench_match.py:39-44."""
    rng = np.random.default_rng(0)
    d = rng.standard_normal((n, 128)).astype(np.float32)
    d = np.abs(d) / np.linalg.norm(d, axis=1, keepdims=True)
    d1 = (d * 512).astype(np.uint8)
    return d1, np.roll(d1, 7, axis=0)


def best_of_windows(fn, device, windows=3, seconds=1.0):
    fn()
    synchronize(device)
    reps = []
    for _ in range(windows):
        calls, t0 = 0, time.perf_counter()
        while True:
            fn()
            synchronize(device)
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        reps.append((time.perf_counter() - t0) / calls)
    return min(reps), reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--tiles", default="4096,8192,16384,32768,65536")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        sys.exit("no CUDA device")
    n = args.n
    tiles = [min(int(t), n) for t in args.tiles.split(",")]
    d1, d2 = (torch.from_numpy(a).to(dev) for a in bench_descriptors(n))
    first = None
    for tile in tiles:
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        rows = td._row_tile(n, tile, False, dev)
        m = td.match_sharded(d1, d2, n2_tile=tile, device=dev)
        synchronize(dev)
        peak = torch.cuda.max_memory_allocated() - base if on_card else None
        first = m if first is None else first
        s, reps = best_of_windows(
            lambda: td.match_sharded(d1, d2, n2_tile=tile, device=dev), dev)
        print(json.dumps({
            "n": n, "n2_tile": tile, "rows_per_block": rows,
            "equal_to_first_tile": bool(torch.equal(m, first)),
            "matches": int((m >= 0).sum()), "seconds_per_table": s,
            "seconds_reps": reps, "gpairs_per_s": n * n / s / 1e9,
            "peak_memory_bytes": peak}), flush=True)
    tile = 16384 if 16384 in tiles else tiles[0]
    if on_card:
        prof = device_profile(lambda: td.match_sharded(
            d1, d2, n2_tile=tile, device=dev), runs=2)
        print(json.dumps({
            "profile_n2_tile": tile, "busy_ms": prof["busy_ms"],
            "launches": prof["launches"], "wall_ms": prof["wall_ms"],
            "by_kernel": dict(list(prof["by_kernel"].items())[:10])}),
            flush=True)
    g = np.random.RandomState(12)
    loc1 = (g.rand(n, 2) * [640, 480]).astype(np.float32)
    H = np.array([[0.98, -0.17, 50.0], [0.17, 0.98, -40.0], [0, 0, 1]],
                 np.float32)
    x2 = np.c_[np.roll(loc1, 7, axis=0), np.ones(n)] @ H.T
    loc2 = (x2[:, :2] / x2[:, 2:]).astype(np.float32)
    l1, l2 = (torch.from_numpy(a).to(dev) for a in (loc1, loc2))
    guided = lambda: td.match_sharded(d1, d2, loc1=l1, loc2=l2, H=H,  # noqa
                                      n2_tile=tile, device=dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    mg = guided()
    synchronize(dev)
    s, reps = best_of_windows(guided, dev)
    print(json.dumps({
        "guided_H": True, "n2_tile": tile,
        "rows_per_block": td._row_tile(n, tile, True, dev),
        "matches": int((mg >= 0).sum()), "seconds_per_table": s,
        "seconds_reps": reps, "gpairs_per_s": n * n / s / 1e9,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated() - base)
        if on_card else None}), flush=True)
    if on_card:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
