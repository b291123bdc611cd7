"""The readings that the limits of `correct` are set from, on the card, at a
cell's own size: the program's numbers over many seeds (the lower
readings) and the control's (the upper readings), in one process.

    python3 benchmark/control.py --workload <name> --seeds 11 12 ... \
        [--control-seeds 11 12 13] [--out control_<name>.jsonl]

For each seed: the frames of the cell's ring, every ring entry through the
program's captured detect_batch, the reference (float32) on the same
frames, and for a control seed the reference with its Gaussian planes in
bfloat16 put in the program's place. Each line gives the comparison's
numbers of the program and of the control against the reference. The
benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))

from benchlib import compare, manifest  # noqa: E402
from benchlib.frames import blob_frames  # noqa: E402
from benchlib.program import Program  # noqa: E402


def readings(cell, seeds, control_seeds, device, root, emit):
    import torch
    cfg, tr = cell.config, cell.traffic
    sift = {**cfg.get("sift", {}), **tr.get("sift", {})}
    B, R = int(tr["batch"]), int(tr["ring_requests"])
    H, W = int(cfg["height"]), int(cfg["width"])
    ref = manifest.reference(cfg["reference"], root)
    settings = ref.Settings.from_fields(sift)
    program = Program(root, sift, device)
    for seed in seeds:
        frames = blob_frames(R * B, H, W, float(cfg["frames"]["density"]),
                             seed, device).reshape(R, B, H, W)
        got = [compare.to_host(program(frames[s])) for s in range(R)]
        t0 = time.perf_counter()
        want = [compare.to_host(ref.run(frames[s], settings)[0])
                for s in range(R)]
        ref_s = time.perf_counter() - t0
        line = dict(workload=cell.name, seed=seed, reference_s=ref_s,
                    program=compare.compare(list(zip(got, want))))
        if seed in control_seeds:
            ctl = [compare.to_host(ref.run(frames[s], settings,
                                           plane_dtype=torch.bfloat16)[0])
                   for s in range(R)]
            line["control"] = compare.compare(list(zip(ctl, want)))
            if settings.compute_descriptors:
                # a witness beside the control: the reference's one matrix
                # product (the descriptor's cell sums) in TF32
                tf = [compare.to_host(ref.run(frames[s], settings,
                                              tf32=True)[0])
                      for s in range(R)]
                line["tf32"] = compare.compare(list(zip(tf, want)))
        emit(line)
        del frames


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 3
    root = BENCH_DIR.parent
    cell = manifest.cell(args.workload, root)
    out = open(args.out, "a") if args.out else None

    def emit(line):
        s = json.dumps(line)
        print(s, flush=True)
        if out:
            out.write(s + "\n")
            out.flush()

    try:
        readings(cell, args.seeds, set(args.control_seeds), "cuda", root,
                 emit)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
