"""The reduction of a torch.profiler trace to what the per-layer metrics
read: device busy time, device time by kernel, the host's launch calls, and
the device's idle gaps by what the host was doing.

Arithmetic frozen from the program's utils/timing.device_profile (the
CUDA runtime calls that put work on the device; device work = every
kernel, copy and fill on the device timeline), so that a change to the
program cannot move the yardstick.
"""

from __future__ import annotations

import bisect
import itertools

from typing import Dict, List, NamedTuple, Tuple

# the CUDA runtime and driver calls that put work on the device, as the
# profiler names them (a graph's replay is one)
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cudaMemcpy",
                "cudaMemset")

# the benchmark's own host spans, innermost first where they nest
REQUEST_SPAN = "bench.request"
HOST_SPANS = ("bench.enqueue", "bench.wait")
HOST_LABEL = "host"


class Summary(NamedTuple):
    window_s: float                  # first request's start to last's end
    busy_s: float                    # union of device work in the window
    requests: int
    by_kernel: Dict[str, List[float]]   # name -> [seconds, launches]
    host_launches: int
    idle_by_host: Dict[str, float]   # idle seconds by the host's span
    gaps: List[Tuple[str, float]]    # the longest idle gaps, longest first


def symbol(name: str) -> str:
    """A kernel's symbol as the kernel table names it: the device name
    without its return type, namespaces, template arguments and parameter
    list ("(anonymous namespace)::chain_kernel(float const*, ...)" ->
    "chain_kernel")."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in ("(", "<"):
        name = name.split(stop, 1)[0]
    return name.strip().rsplit("::", 1)[-1]


def union_seconds(intervals: List[Tuple[float, float]]) -> Tuple[
        float, List[Tuple[float, float]]]:
    """(total covered length, merged intervals) of [start, end) intervals."""
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return sum(b - a for a, b in merged), merged


def reduce(events, requests: int, max_gaps: int = 10) -> Summary:
    """events: torch.profiler's prof.events() (FunctionEvents, times in
    microseconds on one timeline for host and device) of a segment of
    `requests` requests. The window is the benchmark's request spans where
    the trace holds them, else the first runtime call to the last device
    work. An idle gap is labelled by the host span, or else the runtime
    call, that holds its midpoint ("host" where none does)."""
    spans_req, labels, work, launch_at, runtime = [], [], [], [], []
    for ev in events:
        dev = str(ev.device_type)
        tr = ev.time_range
        if dev == "DeviceType.CPU":
            if ev.name == REQUEST_SPAN:
                spans_req.append((tr.start, tr.end))
            elif ev.name in HOST_SPANS:
                labels.append((tr.start, tr.end, ev.name))
            elif ev.name.startswith(("cuda", "cu")):
                runtime.append((tr.start, tr.end, ev.name))
                if ev.name.startswith(LAUNCH_CALLS):
                    launch_at.append(tr.start)
        elif dev == "DeviceType.CUDA" and \
                not getattr(ev, "is_user_annotation", False) \
                and ev.name != REQUEST_SPAN and ev.name not in HOST_SPANS:
            work.append((tr.start, tr.end, ev.name))
    if spans_req:
        w0 = min(a for a, _ in spans_req)
        w1 = max(b for _, b in spans_req)
    elif runtime or work:
        w0 = min([a for a, _, _ in runtime] + [a for a, _, _ in work])
        w1 = max([b for _, b, _ in runtime] + [b for _, b, _ in work])
    else:
        raise ValueError("the trace holds neither a span nor device work")
    if not labels:
        labels = runtime
    launches = sum(1 for t in launch_at if w0 <= t <= w1)
    inside = [(max(a, w0), min(b, w1), n) for a, b, n in work
              if b > w0 and a < w1]
    by_kernel: Dict[str, List[float]] = {}
    for a, b, n in inside:
        k = by_kernel.setdefault(n, [0.0, 0.0])
        k[0] += (b - a) / 1e6
        k[1] += 1
    busy_us, merged = union_seconds([(a, b) for a, b, _ in inside])
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    spans = sorted(labels)
    ends = list(itertools.accumulate((sp[1] for sp in spans), max))
    starts = [sp[0] for sp in spans]
    idle: Dict[str, float] = {}
    gaps = []
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        label = HOST_LABEL
        # the innermost span holding mid: the latest start whose end is past
        while i >= 0 and ends[i] >= mid:
            if spans[i][1] >= mid:
                label = spans[i][2]
                break
            i -= 1
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
        gaps.append((label, (b - a) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    return Summary(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
                   requests=requests, by_kernel=by_kernel,
                   host_launches=launches, idle_by_host=idle,
                   gaps=gaps[:max_gaps])
