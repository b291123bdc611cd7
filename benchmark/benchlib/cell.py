"""One run of one cell: set-up, the measured window, the traced segment,
the comparison with the reference, and the result.

Closed loop, one request in flight: a request is one batch of the traffic
mix, the next entry of a ring of distinct batches held on the device; it
ends when its FeatureTable is complete on the device, which the host learns
from the request's own completion event. The window runs for `seconds`;
every end-to-end metric is taken over all of its requests and all of its
time. With trace=True a traced segment of the traffic's trace_requests
follows the window, under torch.profiler, and the per-layer metrics are
read from it (and, for host-clock spans, from the window).
"""

from __future__ import annotations

import collections
import gc
import random
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from . import compare, manifest, trace
from .frames import blob_frames
from .program import Program

# top-level module names that may not be loaded in the process that
# prints the result: JAX, its libraries and the JAX package (the port's
# name starts with the JAX package's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "hessgpu_tpu")


def forbidden_modules() -> List[str]:
    top = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


class Reservoir:
    """A uniform sample of k items of a stream, drawn from a seeded RNG."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.seen = k, rng, 0
        self.items: list = []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


class Run:
    """What the metric readers read (benchmark/metrics/*.py)."""
    setup_s: float
    window_s: float
    requests: int
    frames: int
    batch: int
    latencies_s: List[float]
    enqueue_s: List[float]
    counters: dict
    trace: Optional[trace.Summary] = None
    traced_frames: int = 0
    kernel_table: Dict[str, List[str]]
    kernel_least_s: Dict[str, float]    # symbol -> least seconds, traced
    peaks: Optional[tuple] = None


def _sync(ev) -> None:
    if ev is not None:
        ev.record()
        ev.synchronize()


def _by_second(latencies: List[float], seconds: float, batch: int):
    """Frames completed in each whole second of the window, each request
    placed at the sum of the latencies up to it (the loop's own time
    between requests, a few microseconds each, left out)."""
    bins = [0] * max(1, int(seconds + 1))
    t = 0.0
    for x in latencies:
        t += x
        bins[min(int(t), len(bins) - 1)] += batch
    return bins


def roofline_context(settings, plan, batch: int, work, reference) -> dict:
    """What the stage counts of benchmark/roofline/ take for one request."""
    s = settings
    taps0 = s.initial_blur_sigma()
    return dict(
        batch=batch, octave_shapes=list(plan.octave_shapes),
        num_levels=s.num_levels, key_levels=len(s.key_levels),
        blur_taps=len(reference.gaussian_taps(taps0, s.filter_width_factor))
        if taps0 > 0 else 0,
        chain_taps=[len(reference.gaussian_taps(g, s.filter_width_factor))
                    if g > 0 else 0 for g in s.incremental_sigmas()],
        valid_cells=list(work.valid_cells),
        fixed_orientation=s.fixed_orientation,
        compute_descriptors=s.compute_descriptors,
        table_rows=work.table_rows, ori_pixels=work.ori_pixels,
        desc_table_rows=work.desc_table_rows, desc_pixels=work.desc_pixels)


def least_seconds(ctx: dict, stages: List[str], peaks: tuple,
                  root: Path) -> float:
    """A kernel's least time for one request: over its launches, the larger
    of bytes over the peak bandwidth and operations over the peak rate,
    the work of the stages it does summed per launch."""
    per_launch: Dict[str, list] = {}
    for stage in stages:
        for key, (nb, nf) in manifest.stage_counter(stage, root)(ctx).items():
            acc = per_launch.setdefault(key, [0, 0])
            acc[0] += nb
            acc[1] += nf
    bw, fl = peaks
    return sum(max(nb / bw, nf / fl) for nb, nf in per_launch.values())


def run_cell(cell: manifest.Cell, seed: int, seconds: float, traced: bool,
             t_start: float, device="cuda", root: Path = manifest.ROOT,
             program_factory: Callable = Program, log=sys.stderr) -> dict:
    """One run; returns the result object (the last line's keys, with
    `checks` last) and, under `extra`, what the earlier lines report."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    cfg, tr = cell.config, cell.traffic
    sift = {**cfg.get("sift", {}), **tr.get("sift", {})}
    B, R = int(tr["batch"]), int(tr["ring_requests"])
    H, W = int(cfg["height"]), int(cfg["width"])

    # ---- set-up, its parts timed on the host clock: from t_start to this
    # call (imports), the program's import and kernels' load or build, the
    # frames (with the device's context), the pass over the ring (with the
    # capture)
    marks = [t_start, time.perf_counter()]
    program = program_factory(root, sift, device)
    marks.append(time.perf_counter())
    frames = blob_frames(R * B, H, W, float(cfg["frames"]["density"]), seed,
                         device)
    ring = list(frames.reshape(R, B, H, W).unbind(0))
    ev = torch.cuda.Event() if on_card else None
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(time.perf_counter())
    for x in ring:                      # the first call captures the graph
        program(x)
        _sync(ev)
    gc.collect()
    marks.append(time.perf_counter())
    setup_s = marks[-1] - t_start
    setup_parts = dict(zip(("imports_s", "program_s", "frames_s", "ring_s"),
                           (b - a for a, b in zip(marks, marks[1:]))))

    # ---- the measured window
    rng = random.Random(seed)
    sample = Reservoir(int(tr["sample_requests"]), rng)
    lat: List[float] = []
    enq: List[float] = []
    failed = 0
    i = 0
    out = None
    w0 = time.perf_counter()
    w1 = w0
    while True:
        t0 = time.perf_counter()
        if t0 - w0 >= seconds:
            break
        slot = i % R
        try:
            out = program(ring[slot])
            t1 = time.perf_counter()
            _sync(ev)
        except RuntimeError as e:
            failed += 1
            print(f"request {i} failed: {e}", file=log)
            i += 1
            continue
        w1 = time.perf_counter()
        lat.append(w1 - t0)
        enq.append(t1 - t0)
        sample.offer((slot, out))
        i += 1
    del out
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    run = Run()
    run.setup_s, run.window_s = setup_s, w1 - w0
    run.requests, run.batch = len(lat), B
    run.frames = len(lat) * B
    run.latencies_s, run.enqueue_s = lat, enq
    run.counters = program.counters() if on_card else {}
    run.kernel_table = manifest.kernel_table(root)
    run.kernel_least_s = {}
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    run.peaks = manifest.peaks(kind, root) if on_card else None

    # ---- the traced segment
    traced_slots: collections.Counter = collections.Counter()
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function
        # on the card the device's activity alone (and the runtime calls
        # that come with it): recording every host operator as well would
        # add its own cost to the host's share of each request
        acts = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
        n_trace = int(tr["trace_requests"])
        out = None
        with profile(activities=acts) as prof:
            for j in range(n_trace):
                slot = (i + j) % R
                with record_function(trace.REQUEST_SPAN):
                    with record_function(trace.HOST_SPANS[0]):
                        out = program(ring[slot])
                    with record_function(trace.HOST_SPANS[1]):
                        _sync(ev)
                traced_slots[slot] += 1
        del out
        run.trace = trace.reduce(prof.events(), n_trace)
        run.traced_frames = n_trace * B
        del prof

    # ---- the reference, once the program's state is freed
    got = [(slot, compare.to_host(t)) for slot, t in sample.items]
    sample.items.clear()
    program.release()
    del program
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = manifest.reference(cfg["reference"], root)
    settings = ref.Settings.from_fields(sift)
    plan = ref.make_plan(H, W, settings)
    need = sorted({s for s, _ in got} | set(traced_slots))
    want, works = {}, {}
    for s in need:
        table, work = ref.run(ring[s], settings)
        want[s] = compare.to_host(table)
        works[s] = work
        del table
    del ring, frames
    numbers = compare.compare([(g, want[s]) for s, g in got])
    correct, checks = compare.judge(numbers, cell.limits)
    correct = correct and failed == 0 and len(lat) > 0

    if traced and run.peaks is not None:
        for sym, stages in run.kernel_table.items():
            run.kernel_least_s[sym] = sum(
                n * least_seconds(roofline_context(settings, plan, B,
                                                   works[s], ref),
                                  stages, run.peaks, root)
                for s, n in traced_slots.items())

    # ---- metrics
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = manifest.metric_reader(m["name"], root)(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": i, "failed": failed,
              "metrics": metrics, "device": dev}
    extra = {"counters": run.counters, "setup_parts": setup_parts,
             "numbers": numbers,
             "requests": run.requests, "window_s": run.window_s,
             "enqueue_mean_ms": 1e3 * sum(enq) / max(len(enq), 1),
             "latency_mean_ms": 1e3 * sum(lat) / max(len(lat), 1),
             "frames_by_second": _by_second(lat, seconds, B)}
    if traced:
        s = run.trace
        dev["busy_s"], dev["window_s"] = s.busy_s, s.window_s
        ops = sorted(s.by_kernel.items(), key=lambda kv: -kv[1][0])
        result["breakdown"] = {
            "device_ops": [[n[:160], v[0]] for n, v in ops[:10]],
            "idle_gaps": [[k, v] for k, v in sorted(
                s.idle_by_host.items(), key=lambda kv: -kv[1])][:10]}
        extra["kernels"] = {
            sym: {"device_s": sum(v[0] for n, v in s.by_kernel.items()
                                  if trace.symbol(n) == sym),
                  "launches": sum(v[1] for n, v in s.by_kernel.items()
                                  if trace.symbol(n) == sym),
                  "least_s": run.kernel_least_s.get(sym)}
            for sym in run.kernel_table}
        extra["longest_gaps"] = s.gaps
        extra["host_launches"] = s.host_launches
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    result["extra"] = extra
    return result
