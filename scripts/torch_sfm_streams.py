#!/usr/bin/env python3
"""ATE of the port's reconstruction under several RANSAC random streams,
on chip_smoke.py's sfm sequence (write_tum_sequence's scene, seed 7, 40
frames at 640x480, SiftConfig(threshold=0.003), reconstruct_sequence's
defaults).

    python3 scripts/torch_sfm_streams.py [--device cpu|cuda] [--streams 5]

Detects once, then reconstructs with the JAX package's own draws (the
port's default, sfm/prng.py) and with `--streams` torch.Generator streams
(stream k seeds its generator with the JAX key's integer + 7919 k). One
JSON line per run: stream, ATE, registered, points, seconds.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hessgpu_tpu_torch import HessianSift, SiftConfig
from hessgpu_tpu_torch.sfm import incremental
from hessgpu_tpu_torch.sfm.evaluate import ate_rmse, camera_centers
from hessgpu_tpu_torch.sfm.synthetic import tum_sequence


def torch_stream(k):
    def sample(seed, n, shape, probs, device):
        g = torch.Generator().manual_seed(int(seed) + 7919 * k)
        idx = torch.multinomial(torch.as_tensor(probs, dtype=torch.float64),
                                int(np.prod(shape)), replacement=True,
                                generator=g)
        return idx.reshape(tuple(shape)).to(device)
    return sample


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--streams", type=int, default=5)
    args = ap.parse_args()
    frames, K, _, centers = tum_sequence(40, 480, 640)
    sift = HessianSift(SiftConfig(threshold=0.003), device=args.device)
    feats = [sift.run(f) for f in frames]
    jax_draws = incremental.sample_indices
    runs = [("jax_draws", jax_draws)] + [
        (f"torch_{k}", torch_stream(k)) for k in range(args.streams)]
    for name, sampler in runs:
        incremental.sample_indices = sampler
        t0 = time.perf_counter()
        rec = incremental.reconstruct_sequence(feats, K, device=args.device)
        dt = time.perf_counter() - t0
        print(json.dumps({
            "stream": name, "device": args.device,
            "ate": ate_rmse(camera_centers(rec.R, rec.t),
                            centers[rec.view_ids]),
            "registered": rec.num_cameras, "points": rec.num_points,
            "seconds": dt}), flush=True)
    incremental.sample_indices = jax_draws


if __name__ == "__main__":
    main()
