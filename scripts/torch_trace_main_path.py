#!/usr/bin/env python3
"""The port's own tracer (hessgpu_tpu_torch/utils/timing.py) on the graph
route of a benchmark cell (needs one CUDA device).

    python3 scripts/torch_trace_main_path.py --cell tum640.describe.b16 \
        [--requests 200] [--window 2000] [--out path.json]

The cell's configuration, traffic and frames are the benchmark's
(benchmark/benchlib/manifest.py, benchmark/benchlib/frames.py):
`detect_batch` closed loop, one request in flight, over the ring of
distinct batches. Every reading of the trace goes through take_trace() and
benchmark/benchlib/program_spans.py. Segments, in order:

- A, tracing off: `window` requests; wall and enqueue (host time to the
  call's return) per request.
- H, host spans alone (tracing(stages=False), the untraced graph):
  `requests` requests; the host's split of a request (entry python =
  self time of batch.detect_batch + graphs.lookup, graph launch, graph io =
  graphs.copy_in + graphs.clone_out) and its wall.
- B, tracing on (a pass over the ring first, which captures the traced
  graph): `requests` requests, no profiler. Per frame, the device ms of each
  TIMINGS_* stage; the host's split on the traced graph; the wall a
  request with tracing on.
- C, tracing on under torch.profiler (CUDA activity, as the benchmark's
  traced segment): the device's idle gaps, each labelled by the program's
  innermost span that holds its midpoint, or `outside`; the profiler's
  device time per frame beside the stages' sum of the same requests and
  segment B's; each graphs.launch span against its cudaGraphLaunch.
- D, device time of a call, untraced against traced: blocks of `replays`
  calls in the order off, on, on, off, each call timed by CUDA events
  around it (copy in, replay, clones) with the card kept busy by a sleep
  while the host enqueues it (chip_smoke.py's BUSY_CYCLES), so no host gap
  falls between the events; each block after one untimed call (at 24 MP
  the two graphs do not both fit the pipeline cache, so a block may
  capture first); the traced calls' own TOTAL beside.
- E (--stage-report): HessianSift.device_stage_report of the cell's first
  frame (what `hess -time` writes) against the same events around traced
  run_pipeline_jit calls of that frame, and each call's own TOTAL over its
  event time.

Prints one JSON object (and writes it to --out).
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "benchmark")]

from benchlib import manifest, program_spans as ps  # noqa: E402


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def cell_ring(name: str, seed: int, device):
    """(the cell's sift fields, its traffic, its ring of request batches on
    `device`) as the benchmark makes them."""
    from benchlib.frames import blob_frames
    c = manifest.cell(name)
    fields = {**c.config.get("sift", {}), **c.traffic.get("sift", {})}
    B, R = int(c.traffic["batch"]), int(c.traffic["ring_requests"])
    H, W = int(c.config["height"]), int(c.config["width"])
    frames = blob_frames(R * B, H, W, float(c.config["frames"]["density"]),
                         seed, device)
    return fields, c.traffic, list(frames.reshape(R, B, H, W).unbind(0))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="tum640.describe.b16")
    ap.add_argument("--seed", type=int, default=2147480001)
    ap.add_argument("--requests", type=int, default=None,
                    help="segments H, B and C (default: trace_requests)")
    ap.add_argument("--window", type=int, default=2000)
    ap.add_argument("--replays", type=int, default=100)
    ap.add_argument("--stage-report", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from hessgpu_tpu_torch import SiftConfig, detect_batch
    from hessgpu_tpu_torch import pyramid as tpyr
    from hessgpu_tpu_torch.utils import timing
    from torch.profiler import ProfilerActivity, profile

    torch.set_num_threads(1)
    dev = torch.device("cuda")
    fields, tr, ring = cell_ring(args.cell, args.seed, dev)
    cfg = SiftConfig(**fields)
    R, B = len(ring), ring[0].shape[0]
    n = args.requests or int(tr["trace_requests"])
    ev = torch.cuda.Event()

    def loop(k, start=0):
        wall, enq = [], []
        for i in range(k):
            t0 = time.perf_counter()
            detect_batch(ring[(start + i) % R], cfg, device=dev)
            t1 = time.perf_counter()
            ev.record()
            ev.synchronize()
            wall.append(time.perf_counter() - t0)
            enq.append(t1 - t0)
        return wall, enq

    def host(spans):
        h = ps.host_split(spans)
        h["sum"] = h["entry"] + h["launch"] + h["io"]
        return h

    res = {"cell": args.cell, "card": card_name(), "torch": torch.__version__,
           "cuda": torch.version.cuda, "batch": B, "requests": n}

    loop(R)                                        # captures the graph
    wall, enq = loop(args.window)
    res["A"] = dict(wall_ms=1e3 * statistics.mean(wall),
                    enqueue_ms=1e3 * statistics.mean(enq),
                    p95_ms=1e3 * statistics.quantiles(wall, n=20)[-1])

    timing.take_trace()
    with timing.tracing(stages=False):
        wall, enq = loop(n)
        trace = timing.take_trace()
    res["H"] = dict(wall_ms=1e3 * statistics.mean(wall),
                    enqueue_ms=1e3 * statistics.mean(enq),
                    host_ms=host(trace.spans))

    with timing.tracing():
        loop(R)                                    # captures the traced one
        timing.take_trace()
        wall, enq = loop(n)
        trace = timing.take_trace()
    res["untraced_graph_still_cached"] = any(
        not k[-1] for k in tpyr._PIPELINE_GRAPHS.keys())
    stages, replays = ps.stage_means(trace.stages, B)
    res["B"] = dict(wall_ms=1e3 * statistics.mean(wall),
                    enqueue_ms=1e3 * statistics.mean(enq),
                    replays=replays, stage_ms_per_frame=stages,
                    six_stage_sum_ms_per_frame=sum(stages.get(s, 0.0)
                                                   for s in ps.STAGES),
                    host_ms=host(trace.spans))

    with timing.tracing():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            loop(n)
        trace = timing.take_trace()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    work, launches = [], []
    for e in prof.events():
        a = t0 + int(e.time_range.start * 1000)
        b = t0 + int(e.time_range.end * 1000)
        if str(e.device_type) == "DeviceType.CUDA" and \
                not getattr(e, "is_user_annotation", False):
            work.append((a, b))
        elif e.name.startswith("cudaGraphLaunch"):
            launches.append((a, b))
    top = [s for s in trace.spans if s.name == "batch.detect_batch"]
    w0 = min(s.start_ns for s in top)
    w1 = max([s.end_ns for s in top] + [b for _, b in work])
    by, longest = ps.idle_gaps(work, trace.spans, w0, w1)
    stages_c, _ = ps.stage_means(trace.stages, B)
    device_ms = sum(b - a for a, b in work) / 1e6 / (n * B)
    six = sum(stages_c.get(s, 0.0) for s in ps.STAGES)
    margins = []
    for sp in (s for s in trace.spans if s.name == "graphs.launch"):
        inside = [(a, b) for a, b in launches
                  if sp.start_ns <= a and b <= sp.end_ns]
        if len(inside) == 1:
            margins.append(((inside[0][0] - sp.start_ns) / 1e3,
                            (sp.end_ns - inside[0][1]) / 1e3))
    res["C"] = dict(
        program_idle_gaps_ms=by, longest_gaps_ms=longest,
        window_ms=(w1 - w0) / 1e6,
        busy_ms=sum(b - a for a, b in work) / 1e6,
        profiler_device_ms_per_frame=device_ms,
        stage_ms_per_frame=stages_c, six_stage_sum_ms_per_frame=six,
        # B's stages (CUPTI slows a traced replay's first stage: PERF.md)
        b_six_over_device=res["B"]["six_stage_sum_ms_per_frame"] / device_ms
        if device_ms else None,
        launch_spans=sum(s.name == "graphs.launch" for s in trace.spans),
        launches_enclosed=len(margins),
        launch_margin_us_max=[max(m[0] for m in margins),
                              max(m[1] for m in margins)]
        if margins else None,
        launch_margin_us_median=[statistics.median(m[0] for m in margins),
                                 statistics.median(m[1] for m in margins)]
        if margins else None)
    del prof

    from chip_smoke import BUSY_CYCLES
    a_ev, b_ev = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def timed(call, k):
        call()                          # untimed: a capture where one is due
        ms = []
        for i in range(k):
            torch.cuda._sleep(BUSY_CYCLES)
            a_ev.record()
            call(i)
            b_ev.record()
            b_ev.synchronize()
            ms.append(a_ev.elapsed_time(b_ev))
        return ms

    times = {False: [], True: []}
    totals = []
    for traced in (False, True, True, False):
        with timing.tracing(traced):
            times[traced] += timed(
                lambda i=0: detect_batch(ring[i % R], cfg, device=dev),
                args.replays)
            totals += [s.ms["TOTAL"] for s in timing.take_trace().stages]
    med = {k: statistics.median(v) for k, v in times.items()}
    res["D"] = dict(untraced_call_ms=med[False], traced_call_ms=med[True],
                    traced_over_untraced=med[True] / med[False],
                    quartiles={str(k): statistics.quantiles(v, n=4)
                               for k, v in times.items()},
                    traced_total_ms=statistics.median(totals))

    if args.stage_report:
        from hessgpu_tpu_torch import HessianSift
        img = ring[0][0].cpu().numpy()
        sift = HessianSift(cfg)
        rep = sift.device_stage_report(img)
        arr, plan, c = tpyr.prepare_input(img, sift.config, dev)
        with timing.tracing():
            ev_ms = timed(lambda i=0: tpyr.run_pipeline_jit(arr, plan, c), 20)
            totals = [s.ms["TOTAL"] for s in timing.take_trace().stages]
        res["E"] = dict(report=dict(rep), event_ms=statistics.median(ev_ms),
                        report_total_over_event=rep["TOTAL"]
                        / statistics.median(ev_ms),
                        call_total_over_event=statistics.median(
                            t / e for t, e in zip(totals[1:], ev_ms)))

    print(json.dumps(res, indent=1))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
