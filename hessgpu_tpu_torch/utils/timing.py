"""Stage timing instrumentation (counterpart of hessgpu_tpu/utils/timing.py).

Equivalent of the reference's ClockTimer/_timing[] buckets
(GlobalUtil.cpp:301-405, config.h:17-31). A stage with a fence closes only
after torch.cuda.synchronize of the fence's device, where the JAX package
calls block_until_ready.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict
from typing import Dict

import torch


def synchronize(device) -> None:
    """Wait for the work queued on a CUDA device (a tensor's, or a device);
    nothing to wait for on the CPU."""
    if isinstance(device, torch.Tensor):
        device = device.device
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StageTimer:
    """Accumulates wall-clock per named stage; last-run and running mean."""

    def __init__(self):
        self.last: "OrderedDict[str, float]" = OrderedDict()
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, fence=None):
        """fence: a tensor or device whose queued work the stage waits for
        before it reads the clock."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                synchronize(fence)
            dt = (time.perf_counter() - t0) * 1000.0
            self.last[name] = dt
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def mean(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return self.totals.get(name, 0.0) / c if c else 0.0

    def report(self) -> str:
        lines = [f"{k:<24s} {v:9.2f} ms (mean {self.mean(k):9.2f} ms)"
                 for k, v in self.last.items()]
        return "\n".join(lines)

    def csv(self) -> str:
        """Per-stage CSV like hess -time (hessgpucmd.cpp:49-67)."""
        keys = list(self.last.keys())
        head = ",".join(keys)
        vals = ",".join(f"{self.last[k]:.3f}" for k in keys)
        return head + "\n" + vals + "\n"


# ---------------------------------------------------------------------------
# per-stage DEVICE time (reference TIMINGS_* buckets, config.h:17-31)
# ---------------------------------------------------------------------------

# reference bucket names; LOAD_IMAGE / DOWNLOAD_KEYPOINTS are host-side
# (StageTimer covers them), GENERATE_VBO has no counterpart
REFERENCE_BUCKETS = (
    "BUILD_PYRAMID", "DETECT_KEYPOINTS", "GENERATE_FEATURE_LIST",
    "COMPUTE_ORIENTATIONS", "MULTI_ORIENTATIONS", "COMPUTE_DESCRIPTORS",
    "FEATURES_REDUCTION", "OTHER", "TOTAL",
)
_CALL_SPAN = "hessgpu_stage_breakdown_call"


def _fill_other(buckets) -> None:
    """OTHER = TOTAL less what the named stages hold."""
    inside = sum(v for b, v in buckets.items() if b not in ("OTHER", "TOTAL"))
    buckets["OTHER"] = max(buckets["TOTAL"] - inside, 0.0)


# the CUDA runtime and driver calls that put work on the device, as the
# profiler names them
_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cudaMemcpy",
                 "cudaMemset")


def device_profile(fn, *args, device="cuda", runs: int = 5):
    """One warm-up call of fn(*args), then `runs` calls under torch.profiler.
    A dict, every number per call:

    - `stages`: OrderedDict bucket -> ms, in REFERENCE_BUCKETS order.
      pyramid.py opens a record_function span named after its bucket around
      every stage. On a CUDA device a bucket is the summed duration of the
      device work (kernels, copies) that runs inside its spans on the device
      timeline, where the profiler places each span from the first to the
      last work launched in it; the host's gaps are not in it. (The kernels
      launched through ctypes have no PyTorch operator to be attributed to,
      so the spans' host-side device totals would miss them.) On the CPU a
      bucket is the spans' CPU time. TOTAL is the same quantity over the
      whole call, OTHER what lies in no bucket's span (input and coordinate
      conversion). A stage that never ran reads 0.
    - `busy_ms`: the device work of the call (stages["TOTAL"] on a card,
      0 on the CPU), and `launches`: how many pieces of work it ran.
    - `host_launches`: the host's calls that put work on the device (the
      CUDA runtime's kernel, graph, copy and fill launches; a graph's
      replay is one), 0 on the CPU.
    - `by_kernel`: {name: [ms, launches]} of that work, largest first.
    - `host_stages`: the same buckets in the spans' CPU time (on the CPU,
      `stages` itself).
    - `wall_ms`: the host's time of each call, the profiler on."""
    from torch.profiler import ProfilerActivity, profile, record_function

    device = torch.device(device)
    on_card = device.type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    fn(*args)
    synchronize(device)
    wall = []
    with profile(activities=activities) as prof:
        for _ in range(runs):
            t0 = time.perf_counter()
            with record_function(_CALL_SPAN):
                fn(*args)
            synchronize(device)
            wall.append((time.perf_counter() - t0) * 1000.0)

    spans = set(REFERENCE_BUCKETS) | {_CALL_SPAN}
    host = OrderedDict((b, 0.0) for b in REFERENCE_BUCKETS)
    host_launches = 0.0
    for ev in prof.events():
        if str(ev.device_type) != "DeviceType.CPU":
            continue
        if ev.name in spans:
            key = "TOTAL" if ev.name == _CALL_SPAN else ev.name
            host[key] += ev.cpu_time_total / 1e3 / runs
        elif ev.name.startswith(_LAUNCH_CALLS):
            host_launches += 1.0 / runs
    _fill_other(host)
    buckets = host
    by_kernel: Dict[str, list] = {}
    if on_card:
        # everything the device ran in the profiled window is the calls'
        buckets = OrderedDict((b, 0.0) for b in REFERENCE_BUCKETS)
        windows, work = [], []
        for ev in prof.events():
            if str(ev.device_type) != "DeviceType.CUDA":
                continue
            tr = ev.time_range
            if ev.name in spans:
                windows.append((tr.start, tr.end, ev.name))
            elif not getattr(ev, "is_user_annotation", False):
                work.append((tr.start, tr.end - tr.start, ev.name))
        for start, us, name in work:
            buckets["TOTAL"] += us / 1e3 / runs
            k = by_kernel.setdefault(name, [0.0, 0.0])
            k[0] += us / 1e3 / runs
            k[1] += 1.0 / runs
            for a, b, span in windows:
                if span in buckets and a <= start <= b:
                    buckets[span] += us / 1e3 / runs
        _fill_other(buckets)
    return dict(
        stages=buckets, host_stages=host,
        busy_ms=buckets["TOTAL"] if on_card else 0.0,
        launches=sum(n for _, n in by_kernel.values()),
        host_launches=host_launches,
        by_kernel=dict(sorted(by_kernel.items(), key=lambda kv: -kv[1][0])),
        wall_ms=wall)


def device_stage_breakdown(fn, *args, device="cuda", runs: int = 5):
    """Per-stage milliseconds of one pipeline call fn(*args), averaged over
    `runs` calls: device_profile(...)["stages"]."""
    return device_profile(fn, *args, device=device, runs=runs)["stages"]


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A torch.profiler trace of the block, written to
    log_dir/trace.json (a chrome trace: chrome://tracing or Perfetto).
    Host activity, and the device's kernels and copies when CUDA is
    available. Yields log_dir."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
