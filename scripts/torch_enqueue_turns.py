#!/usr/bin/env python3
"""The host's time in detect_batch, this tree against another tree of this
repository, call by call in one process on one GPU, tracing off: what the
trees' code costs a request on the host around the graph launch.

    git archive <commit> | tar -x -C _parent      # _parent/ is git-ignored
    python3 scripts/torch_enqueue_turns.py _parent [--calls 10000] \
        [--cell tum640.describe.b16]

The other tree's package is loaded beside this one under another name, so
that both run in one process and the calls alternate (this, other, other,
this, ...): the host's drifts fall on both alike. Each call is a closed-loop
request of the cell's shape (the benchmark's frames), waited for with an
event; the enqueue is the host's time to the call's return. Prints one JSON
object: each side's median, mean and quartiles in microseconds, and the
median of the paired differences (this less other).
"""

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

from torch_trace_main_path import card_name, cell_ring


def load_other(tree: Path):
    """The package of `tree` under the name hessgpu_tpu_torch_other."""
    name = "hessgpu_tpu_torch_other"
    pkg = tree / "hessgpu_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--calls", type=int, default=10000)
    ap.add_argument("--cell", default="tum640.describe.b16")
    ap.add_argument("--seed", type=int, default=2147480011)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import hessgpu_tpu_torch as this
    other = load_other(Path(args.other).resolve())
    torch.set_num_threads(1)
    dev = torch.device("cuda")
    fields, _, ring = cell_ring(args.cell, args.seed, dev)
    R = len(ring)
    sides = {"this": (this.detect_batch, this.SiftConfig(**fields)),
             "other": (other.detect_batch, other.SiftConfig(**fields))}
    ev = torch.cuda.Event()
    enq = {"this": [], "other": []}
    for i in range(args.calls + 2 * R):
        order = ("this", "other") if i % 4 in (0, 3) else ("other", "this")
        for side in order:
            fn, cfg = sides[side]
            t0 = time.perf_counter()
            fn(ring[i % R], cfg, device=dev)
            t1 = time.perf_counter()
            ev.record()
            ev.synchronize()
            if i >= 2 * R:                 # the captures and a warm pass
                enq[side].append(1e6 * (t1 - t0))
    diff = [a - b for a, b in zip(enq["this"], enq["other"])]
    out = {side: dict(median=statistics.median(v), mean=statistics.mean(v),
                      quartiles=statistics.quantiles(v, n=4))
           for side, v in enq.items()}
    print(json.dumps(dict(card=card_name(), cell=args.cell, calls=args.calls,
                          enqueue_us=out,
                          this_less_other_us_median=statistics.median(diff),
                          this_less_other_us_mean=statistics.mean(diff),
                          this_less_other_us_quartiles=statistics.quantiles(
                              diff, n=4)), indent=1))


if __name__ == "__main__":
    main()
