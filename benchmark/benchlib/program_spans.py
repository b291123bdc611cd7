"""Readings of the port's own trace (hessgpu_tpu_torch.utils.timing's
take_trace()): the host spans' self times, the host's split of a request,
the stages' device ms a frame, and the device's idle gaps labelled by the
program's innermost span.

Works on any records with the fields of timing.Span (name, start_ns,
end_ns, id, parent, request) and timing.DeviceStages (source, ms), and
imports nothing of the port. scripts/torch_trace_main_path.py reads its
segments with it; the harness's program segment, when it comes, reads the
same functions from here.
"""

from __future__ import annotations

import bisect
import itertools
from typing import Dict, List, Sequence, Tuple

# the pipeline's stages a per-frame metric reads (TIMINGS_* buckets)
STAGES = ("BUILD_PYRAMID", "DETECT_KEYPOINTS", "GENERATE_FEATURE_LIST",
          "COMPUTE_ORIENTATIONS", "MULTI_ORIENTATIONS", "COMPUTE_DESCRIPTORS")

# span names of each part of the host's split of a request
ENTRY = ("batch.detect_batch", "graphs.lookup")     # self time
LAUNCH = ("graphs.launch",)
IO = ("graphs.copy_in", "graphs.clone_out")
READ = ("graphs.read_stages",)      # tracing's own: a traced replay's read


def self_times(spans) -> Dict[int, int]:
    """{span id: ns} of each span less what its children cover."""
    kids: Dict[int, list] = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    out = {}
    for s in spans:
        covered, end = 0, s.start_ns
        for k in sorted(kids.get(s.id, []), key=lambda k: k.start_ns):
            a, b = max(k.start_ns, end), min(k.end_ns, s.end_ns)
            if b > a:
                covered += b - a
                end = b
        out[s.id] = s.end_ns - s.start_ns - covered
    return out


def host_split(spans) -> Dict[str, float]:
    """Mean ms a request of `entry` (the self time of batch.detect_batch
    and graphs.lookup), `launch` (graphs.launch), `io` (graphs.copy_in and
    graphs.clone_out) and `read` (graphs.read_stages); {} without spans."""
    selft = self_times(spans)
    parts = {"entry": ENTRY, "launch": LAUNCH, "io": IO, "read": READ}
    per: Dict[int, Dict[str, int]] = {}
    for s in spans:
        acc = per.setdefault(s.request, dict.fromkeys(parts, 0))
        for part, names in parts.items():
            if s.name in names:
                acc[part] += (selft[s.id] if part == "entry"
                              else s.end_ns - s.start_ns)
    if not per:
        return {}
    return {k: sum(a[k] for a in per.values()) / len(per) / 1e6
            for k in parts}


def stage_means(stages, batch: int) -> Tuple[Dict[str, float], int]:
    """(mean device ms a frame of each bucket over the graph replays'
    records, the number of replays)."""
    got = [s.ms for s in stages if s.source == "graph"]
    if not got:
        return {}, 0
    keys = list(dict.fromkeys(k for m in got for k in m))
    return {k: sum(m.get(k, 0.0) for m in got) / len(got) / batch
            for k in keys}, len(got)


def innermost_labels(spans, points: Sequence[int]) -> List[str]:
    """The name of the innermost span holding each point (the latest start
    among those that hold it), else "outside"."""
    spans = sorted(spans, key=lambda s: s.start_ns)
    starts = [s.start_ns for s in spans]
    ends = list(itertools.accumulate((s.end_ns for s in spans), max))
    out = []
    for t in points:
        i = bisect.bisect_right(starts, t) - 1
        label = "outside"
        while i >= 0 and ends[i] >= t:
            if spans[i].end_ns >= t:
                label = spans[i].name
                break
            i -= 1
        out.append(label)
    return out


def idle_gaps(work, spans, w0: int, w1: int, longest: int = 10):
    """The device's idle intervals in [w0, w1] (ns) between the merged
    device work intervals `work` [(start, end)], each labelled by
    innermost_labels at its midpoint: ({label: ms}, [(label, ms)] of the
    `longest` longest gaps, longest first)."""
    merged: List[list] = []
    for a, b in sorted(work):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    labels = innermost_labels(spans, [(a + b) // 2 for a, b in gaps])
    by: Dict[str, float] = {}
    for lab, (a, b) in zip(labels, gaps):
        by[lab] = by.get(lab, 0.0) + (b - a) / 1e6
    top = sorted(((lab, (b - a) / 1e6) for lab, (a, b) in zip(labels, gaps)),
                 key=lambda g: -g[1])
    return by, top[:longest]
