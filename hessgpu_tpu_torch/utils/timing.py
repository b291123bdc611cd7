"""Stage timing instrumentation (counterpart of hessgpu_tpu/utils/timing.py)
and the port's tracer.

Equivalent of the reference's ClockTimer/_timing[] buckets
(GlobalUtil.cpp:301-405, config.h:17-31). A stage with a fence closes only
after torch.cuda.synchronize of the fence's device, where the JAX package
calls block_until_ready.

The tracer is off by default; `with tracing():` turns it on for the whole
process. It records host spans at the layer boundaries - the entry
(`batch.detect_batch`, parallel/batch.py) and the compiled layer
(`graphs.lookup`, `graphs.copy_in`, `graphs.launch`, `graphs.clone_out`,
utils/graphs.py) - and the device time of the pipeline's stages (`stage`,
named after the reference's TIMINGS_* buckets), on the card also inside a
replayed CUDA graph: a graph captured with tracing on holds a pair of timed
events around each stage and one around its whole function. take_trace()
returns what was recorded and clears it. tracing(stages=False) records
the host spans alone, and the entry points replay their untraced graphs.

Spans are stamped with time.time_ns(), the clock torch.profiler exports (its
events lie at microseconds after
prof.profiler.kineto_results.trace_start_ns(), Unix-epoch nanoseconds; a
chrome trace's `ts` at microseconds after its `baseTimeNanoseconds`), so the
program's spans and a profiler's device work share one timeline. With
tracing off a span site costs a shared null object's with statement
(span) or a test of None (phases, on the graph layer's hot path).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
import weakref
from collections import OrderedDict
from typing import Dict, List, NamedTuple

import torch
from torch.profiler import record_function


def synchronize(device) -> None:
    """Wait for the work queued on a CUDA device (a tensor's, or a device);
    nothing to wait for on the CPU."""
    if isinstance(device, torch.Tensor):
        device = device.device
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StageTimer:
    """Wall-clock milliseconds per named stage of the last run."""

    def __init__(self):
        self.last: "OrderedDict[str, float]" = OrderedDict()

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
            self.last[name] = (time.perf_counter() - t0) * 1000.0

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
    from torch.profiler import ProfilerActivity, profile

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


# ---------------------------------------------------------------------------
# the tracer: host spans and per-stage device time, off by default
# ---------------------------------------------------------------------------

# spans, and stage records, kept in memory; the oldest dropped first
TRACE_CAPACITY = 65536

_tracing = False
_stage_tracing = False      # _tracing, and the stages' device time with it
_ids = itertools.count(1)
_open = threading.local()   # .stack: this thread's open spans; .thread: its id


class Span(NamedTuple):
    """One host span, its times on time.time_ns() (Unix-epoch ns)."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int     # the enclosing span's id; 0 for a top-level span
    request: int    # the id of the top-level span it lies in
    thread: int     # threading.get_native_id() of the thread it ran on


class DeviceStages(NamedTuple):
    """Device milliseconds by TIMINGS_* bucket of one call: a traced graph's
    replay ("graph": the buckets its stages ran, OTHER and TOTAL, TOTAL its
    whole function) or the stages one request ran eagerly on a card
    ("eager": the buckets alone)."""
    request: int
    source: str
    ms: Dict[str, float]


class Trace(NamedTuple):
    spans: List[Span]
    stages: List[DeviceStages]


_spans: collections.deque = collections.deque(maxlen=TRACE_CAPACITY)
_stages: collections.deque = collections.deque(maxlen=TRACE_CAPACITY)
# (request, bucket, start event, end event) of stages run eagerly on a card
_eager_events: collections.deque = collections.deque(maxlen=TRACE_CAPACITY)
# graphs (utils/graphs._Graph) whose last traced replay is not read yet
_unread_graphs: "weakref.WeakSet" = weakref.WeakSet()
_unread_lock = threading.Lock()


@contextlib.contextmanager
def tracing(enabled: bool = True, stages: bool = True):
    """Record spans and the stages' device time inside the block: one
    setting for the whole process, every thread (as
    graphs.disable_graphs). The caller's setting comes back after it. A
    graph entry point's key holds stage_tracing_enabled(), so with the
    stages traced each key captures a graph of its own that carries the
    stages' timed events, and the untraced graph stays as it was.
    stages=False records the host spans alone: the entry points replay the
    untraced graphs, and stage() opens only its record_function span."""
    global _tracing, _stage_tracing
    prev = _tracing, _stage_tracing
    _tracing, _stage_tracing = enabled, enabled and stages
    try:
        yield
    finally:
        _tracing, _stage_tracing = prev


def tracing_enabled() -> bool:
    return _tracing


def stage_tracing_enabled() -> bool:
    """Whether tracing is on with the stages' device time (tracing())."""
    return _stage_tracing


class _NullSpan:
    """What a span site opens with tracing off: one shared object."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """root=True: a request of its own, whatever span is open."""
    __slots__ = ("name", "root", "id", "parent", "request", "start_ns",
                 "stack")

    def __init__(self, name: str, root: bool = False):
        self.name, self.root = name, root

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        if stack and not self.root:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.parent, self.request = 0, self.id
        stack.append(self)
        self.stack = stack
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.stack.pop()
        # a plain tuple here, the Span in take_trace()
        _spans.append((self.name, self.start_ns, end, self.id, self.parent,
                       self.request, _open.thread))
        return False


def _stack() -> list:
    """This thread's open spans (its id taken at the first)."""
    try:
        return _open.stack
    except AttributeError:
        _open.thread = threading.get_native_id()
        _open.stack = []
        return _open.stack


def span(name: str):
    """A host span around the block while tracing is on, its parent the
    innermost span open on this thread; `with span(...) as s`: s.request is
    the request id (None with tracing off). With tracing off, a shared
    object that does nothing."""
    return _Span(name) if _tracing else _NULL_SPAN


class _Phases:
    """Consecutive host spans on one thread; see phases()."""
    __slots__ = ("start_ns",)

    def __init__(self):
        self.start_ns = time.time_ns()

    def mark(self, name: str) -> int:
        """Record the span `name` from the last mark (or phases()) to now,
        a child of the innermost span open on this thread; its request."""
        end = time.time_ns()
        stack = _stack()
        sid = next(_ids)
        parent, request = ((stack[-1].id, stack[-1].request) if stack
                           else (0, sid))
        _spans.append((name, self.start_ns, end, sid, parent, request,
                       _open.thread))
        self.start_ns = end
        return request


def phases():
    """While tracing is on, a recorder of back-to-back spans: each
    rec.mark(name) records `name` from the previous mark, or from this
    call, to now. None with tracing off, so that a site on a hot path
    costs a test of `rec is not None` (a null span costs a Python call and
    the with statement's two: ~0.6 us, where a request's host budget for
    the tracer is 2 us)."""
    return _Phases() if _tracing else None


def _request() -> int:
    """The request of the innermost span open on this thread, else 0."""
    stack = getattr(_open, "stack", None)
    return stack[-1].request if stack else 0


def timed_event(external: bool = False) -> "torch.cuda.Event":
    """A CUDA event that elapsed_time reads; external=True for one recorded
    into a graph while it is captured (a node of the graph)."""
    return torch.cuda.Event(enable_timing=True, external=external)


class CaptureSink:
    """The timed events of a graph captured with tracing on (utils/graphs.py
    makes one a capture): the stages' (bucket, start, end) in `pairs`. Each
    event is recorded on a side stream forked from the capturing stream at
    that point, so that the graph holds it as a branch off the chain of the
    work: the work after it does not wait for it. (Recorded in the chain
    itself, each event node delays the work after it: on an H100, a 640x480
    B=16 replay took 6.5% more device time than untraced, against 1.6% on
    branches; PERF.md.) join() merges the branch back before the capture
    ends."""

    def __init__(self, device):
        self.pairs: list = []
        self.side = torch.cuda.Stream(device)

    def record(self, event) -> None:
        self.side.wait_stream(torch.cuda.current_stream())
        event.record(self.side)

    def join(self) -> None:
        torch.cuda.current_stream().wait_stream(self.side)


class _Stage:
    """A stage while tracing is on; see stage()."""
    __slots__ = ("name", "device", "fn_span", "host", "events", "sink")

    def __init__(self, name: str, device: torch.device):
        self.name, self.device = name, device

    def __enter__(self):
        self.fn_span = record_function(self.name)
        self.fn_span.__enter__()
        self.host = self.events = self.sink = None
        if self.device.type != "cuda":
            self.host = _Span(self.name)
            self.host.__enter__()
            return self
        from .graphs import _making
        capturing = torch.cuda.is_current_stream_capturing()
        if capturing:
            # a traced graph's capture collects the pairs; an untraced one
            # (or its eager warm-up call) takes none
            self.sink = getattr(_making, "stages", None)
            if self.sink is None:
                return self
            self.events = (timed_event(True), timed_event(True))
            self.sink.record(self.events[0])
        elif not getattr(_making, "graph", False):
            self.events = (timed_event(), timed_event())
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.host is not None:
            self.host.__exit__(*exc)
        elif self.sink is not None:
            self.sink.record(self.events[1])
            self.sink.pairs.append((self.name,) + self.events)
        elif self.events is not None:
            self.events[1].record()
            _eager_events.append((_request(), self.name) + self.events)
        return self.fn_span.__exit__(*exc)


def stage(name: str, device):
    """A pipeline stage named after its TIMINGS_* bucket, on `device`: a
    record_function span (device_profile reads them on the eager route).
    With tracing on besides: on a card a pair of timed events around the
    stage - recorded into the graph being captured, whose replays report
    them (utils/graphs.py), or ordinary events on the eager route, read by
    take_trace() - and on the CPU a host span (tracing(stages=False):
    the record_function span alone)."""
    if not _stage_tracing:
        return record_function(name)
    return _Stage(name, torch.device(device))


def _bucket_order(ms: Dict[str, float]) -> Dict[str, float]:
    known = [b for b in REFERENCE_BUCKETS if b in ms]
    return OrderedDict((b, ms[b]) for b in known
                       + [b for b in ms if b not in REFERENCE_BUCKETS])


def stage_ms(pairs, whole) -> Dict[str, float]:
    """Device ms by bucket from timed event pairs [(bucket, start, end)],
    summed per bucket, and TOTAL from `whole` (start, end) around them;
    OTHER = TOTAL less the buckets. Waits for whole's end event."""
    whole[1].synchronize()
    ms: Dict[str, float] = {}
    for name, a, b in pairs:
        ms[name] = ms.get(name, 0.0) + a.elapsed_time(b)
    ms["TOTAL"] = whole[0].elapsed_time(whole[1])
    _fill_other(ms)
    return _bucket_order(ms)


def record_stages(request: int, source: str, ms: Dict[str, float]) -> None:
    _stages.append(DeviceStages(request, source, ms))


def defer_read(graph) -> None:
    """`graph` (a _Graph) holds a replay whose stages are not read yet:
    take_trace() calls its read_stages() unless its next call did."""
    with _unread_lock:
        _unread_graphs.add(graph)


def _take(q: collections.deque, ours=None) -> list:
    """The entries of q for which ours(entry) holds (every entry without
    it), taken out of q; the rest stay in their order."""
    taken = []
    for _ in range(len(q)):
        e = q.popleft()
        if ours is None or ours(e):
            taken.append(e)
        else:
            q.append(e)
    return taken


def _read_unread() -> None:
    """Record the device time of every traced graph's last replay and of
    the stages run eagerly on a card, not read yet; waits for their last
    events."""
    with _unread_lock:
        graphs = list(_unread_graphs)
        _unread_graphs.clear()
    for g in graphs:
        g.read_stages()
    by_request: Dict[int, Dict[str, float]] = OrderedDict()
    for req, name, a, b in _take(_eager_events):
        b.synchronize()
        ms = by_request.setdefault(req, {})
        ms[name] = ms.get(name, 0.0) + a.elapsed_time(b)
    for req, ms in by_request.items():
        record_stages(req, "eager", _bucket_order(ms))


def take_trace() -> Trace:
    """The spans and stage records kept since the last take_trace(), which
    it clears. The device time of every traced graph's last replay and of
    the stages run eagerly on a card is read first, which waits for their
    last events (with tracing on only: nothing records them otherwise)."""
    _read_unread()
    return Trace([Span(*t) for t in _take(_spans)], _take(_stages))


_BREAKDOWN_SPAN = "timing.replay_stage_breakdown"


def replay_stage_breakdown(fn, *args, runs: int = 5):
    """Per-stage device milliseconds of fn(*args), a graph entry point on a
    card (pyramid.run_pipeline_jit), averaged over `runs` replays of its
    traced graph: a first call with tracing on captures the key's traced
    graph, then each replay's buckets come from the timed events the graph
    holds (OTHER = TOTAL less the buckets, TOTAL the graph's whole
    function). An OrderedDict in REFERENCE_BUCKETS order, 0 for a stage the
    configuration does not run. Each call is a request of its own (a span
    with no parent, whatever span the caller has open); the spans and stage
    records of those requests are taken out of the tracer's buffer, and
    every other record (the caller's, other threads') stays for
    take_trace()."""
    calls = []
    with tracing():
        for _ in range(runs + 1):
            with _Span(_BREAKDOWN_SPAN, root=True) as call:
                fn(*args)
            calls.append(call.request)
    _read_unread()
    ours = set(calls)
    _take(_spans, lambda t: t[5] in ours)      # t[5]: the request
    got = {s.request: s.ms for s in _take(_stages, lambda s: s.request in ours)
           if s.source == "graph"}
    got = [got[r] for r in calls[1:] if r in got]
    if len(got) != runs:
        raise RuntimeError(f"replay_stage_breakdown: {len(got)} traced "
                           f"replays for {runs} calls: fn replays no graph")
    return OrderedDict((b, sum(m.get(b, 0.0) for m in got) / runs)
                       for b in REFERENCE_BUCKETS)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A torch.profiler trace of the block with the program's spans,
    written to log_dir/trace.json (a chrome trace: chrome://tracing or
    Perfetto). Host activity, and the device's kernels and copies when CUDA
    is available. The tracer's host spans are on inside the block, the
    stages' device time off (tracing(stages=False)): the graph entry points
    replay the graphs they replay outside it, and the profiler shows the
    stages' record_function spans. The spans that start inside the block
    are taken out of the tracer's buffer (the rest stay) and written beside
    the profiler's events on the same clock, category "program", with
    their id, parent and request in `args`. Yields log_dir."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.time_ns()
    with tracing(stages=False), profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    spans = [Span(*t) for t in _take(_spans, lambda t: t[1] >= t0)]
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    doc["traceEvents"].extend(
        {"ph": "X", "cat": "program", "name": s.name, "pid": os.getpid(),
         "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"id": s.id, "parent": s.parent, "request": s.request}}
        for s in spans)
    with open(path, "w") as f:
        json.dump(doc, f)
