#!/usr/bin/env python3
"""Where the time goes on the port's main path (needs one CUDA device).

    python3 scripts/torch_profile_main_path.py [--batch 16] [--iters 5]
        [--config default|sd-ofix] [--detector hessian|dog]

Runs hessgpu_tpu_torch.detect_batch on seeded 640x480 textures under
torch.profiler, with the default SiftConfig() (orientations, descriptors) or
with SiftConfig(compute_descriptors=False, fixed_orientation=True) (sd-ofix),
and prints one JSON object: wall time per batch, device-busy time per batch
(sum of all kernel durations), the device's idle share, device time by kernel
name (the port's own kernels apart from PyTorch's), and per pipeline span
(BUILD_PYRAMID, DETECT_KEYPOINTS, GENERATE_FEATURE_LIST, FEATURES_REDUCTION,
COMPUTE_ORIENTATIONS, MULTI_ORIENTATIONS, COMPUTE_DESCRIPTORS) the host time
inside it and the stretch of the device timeline it covers, gaps included;
and the launches per batch of every kernel name, so that two trees' launch
counts can be told apart kernel by kernel.
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
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from hessgpu_tpu_torch import SiftConfig, detect_batch
    from hessgpu_tpu_torch.sfm.synthetic import texture_frame

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

    for _ in range(3):
        one()
    off = [one() for _ in range(args.iters)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        on = [one() for _ in range(args.iters)]

    own = ("blur_kernel", "chain_kernel", "downsample2",
           "detect_kernel", "orientation_kernel", "descriptor_kernel")
    span_names = ("BUILD_PYRAMID", "DETECT_KEYPOINTS",
                  "GENERATE_FEATURE_LIST", "FEATURES_REDUCTION",
                  "COMPUTE_ORIENTATIONS", "MULTI_ORIENTATIONS",
                  "COMPUTE_DESCRIPTORS")
    by_kernel, spans, launches = {}, {}, {}
    busy_us = 0.0
    for ev in prof.key_averages():
        dev_us = float(getattr(ev, "self_device_time_total", 0.0))
        if ev.key in span_names:
            # the span is reported twice, once from each side
            sp = spans.setdefault(ev.key, {"cpu_ms_per_batch": 0.0,
                                           "device_span_ms_per_batch": 0.0})
            sp["cpu_ms_per_batch"] = max(
                sp["cpu_ms_per_batch"], ev.cpu_time_total / 1e3 / args.iters)
            sp["device_span_ms_per_batch"] = max(
                sp["device_span_ms_per_batch"],
                float(getattr(ev, "device_time_total", 0.0))
                / 1e3 / args.iters)
            continue
        if str(ev.device_type).endswith("CUDA") and dev_us > 0:
            busy_us += dev_us
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + dev_us
            launches[ev.key[:90]] = launches.get(ev.key[:90], 0) + ev.count
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    own_us = sum(v for k, v in top if any(o in k for o in own))
    wall_on = statistics.median(on)
    print(json.dumps({
        "card": smi, "config": args.config, "detector": args.detector,
        "batch": args.batch, "iters": args.iters,
        "wall_ms_per_batch_profiler_off": statistics.median(off),
        "wall_ms_per_batch_profiler_on": wall_on,
        "device_busy_ms_per_batch": busy_us / 1e3 / args.iters,
        "device_idle_share": 1.0 - busy_us / 1e3 / args.iters / wall_on,
        "own_kernels_ms_per_batch": own_us / 1e3 / args.iters,
        "pytorch_kernels_ms_per_batch": (busy_us - own_us) / 1e3 / args.iters,
        "kernel_launches_per_batch":
            sum(ev.count for ev in prof.key_averages()
                if str(ev.device_type).endswith("CUDA")) / args.iters,
        "spans": spans,
        "top_kernels_ms_per_batch": [
            [k[:90], v / 1e3 / args.iters] for k, v in top[:14]],
        "launches_by_kernel_per_batch": {
            k: n / args.iters for k, n in sorted(
                launches.items(), key=lambda kv: (-kv[1], kv[0]))},
    }, indent=1))


if __name__ == "__main__":
    main()
