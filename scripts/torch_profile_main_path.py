#!/usr/bin/env python3
"""Where the time goes on the port's main path (needs one CUDA device).

    python3 scripts/torch_profile_main_path.py [--batch 16] [--iters 5]
        [--config default|sd-ofix] [--detector hessian|dog]

Runs hessgpu_tpu_torch.detect_batch on seeded 640x480 textures under
torch.profiler, with the default SiftConfig() (orientations, descriptors) or
with SiftConfig(compute_descriptors=False, fixed_orientation=True) (sd-ofix),
through the eager route (a captured graph's replay emits no
record_function span), and prints one JSON object: wall time per batch,
device-busy time per batch (the summed duration of the device work), the
device's idle share, device
time by kernel name (the port's own kernels apart from PyTorch's), the device
time inside each pipeline span (BUILD_PYRAMID ... COMPUTE_DESCRIPTORS, OTHER,
TOTAL: hessgpu_tpu_torch.utils.timing.device_profile, the accounting that
HessianSift.device_stage_report and chip_smoke.py use too) and the host
time inside each span, and the launches per batch of every kernel name, so that two trees' launch counts can be told
apart kernel by kernel.
Also the wall time with the profiler off, so the instrumentation's cost
shows.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--config", choices=["default", "sd-ofix"],
                    default="default")
    ap.add_argument("--detector", choices=["hessian", "dog"],
                    default="hessian")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from hessgpu_tpu_torch import SiftConfig, detect_batch
    from hessgpu_tpu_torch.sfm.synthetic import texture_frame
    from hessgpu_tpu_torch.utils.graphs import disable_graphs
    from hessgpu_tpu_torch.utils.timing import device_profile

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    cfg = SiftConfig(detector=args.detector)
    if args.config == "sd-ofix":
        cfg = SiftConfig(detector=args.detector, compute_descriptors=False,
                         fixed_orientation=True)
    imgs = torch.from_numpy(np.stack(
        [texture_frame(seed) for seed in range(args.batch)])).cuda()

    def one():
        t0 = time.perf_counter()
        detect_batch(imgs, cfg)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    with disable_graphs():
        for _ in range(3):
            one()
        off = [one() for _ in range(args.iters)]
        prof = device_profile(detect_batch, imgs, cfg, runs=args.iters)

    own = ("blur_kernel", "chain_kernel", "downsample2",
           "detect_kernel", "orientation_kernel", "descriptor_kernel")
    own_ms = sum(ms for k, (ms, _) in prof["by_kernel"].items()
                 if any(o in k for o in own))
    wall_on = statistics.median(prof["wall_ms"])
    print(json.dumps({
        "card": smi, "config": args.config, "detector": args.detector,
        "batch": args.batch, "iters": args.iters,
        "wall_ms_per_batch_profiler_off": statistics.median(off),
        "wall_ms_per_batch_profiler_on": wall_on,
        "device_busy_ms_per_batch": prof["busy_ms"],
        "device_idle_share": 1.0 - prof["busy_ms"] / wall_on,
        "own_kernels_ms_per_batch": own_ms,
        "pytorch_kernels_ms_per_batch": prof["busy_ms"] - own_ms,
        "kernel_launches_per_batch": prof["launches"],
        "stages_ms_per_batch": prof["stages"],
        "host_ms_per_stage_per_batch": prof["host_stages"],
        "top_kernels_ms_per_batch": [
            [k[:90], ms] for k, (ms, _) in list(prof["by_kernel"].items())[:14]],
        "launches_by_kernel_per_batch": {
            k[:90]: n for k, (_, n) in sorted(
                prof["by_kernel"].items(), key=lambda kv: (-kv[1][1], kv[0]))},
    }, indent=1))


if __name__ == "__main__":
    main()
