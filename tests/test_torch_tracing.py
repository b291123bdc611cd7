"""The port's tracer (hessgpu_tpu_torch/utils/timing.py) on the CPU: the
switch, host spans with their parents and request ids, the pipeline's
stages, the shared clock with torch.profiler, and the chrome trace that
profile_trace writes. The graph route's timed events need a card
(tests/test_torch_compiled_gpu.py). Imports nothing of JAX."""

import json
import os
import threading
import time

import pytest
import torch

from hessgpu_tpu_torch import SiftConfig, detect_batch, make_plan
from hessgpu_tpu_torch.sfm.synthetic import texture_frame
from hessgpu_tpu_torch.utils import timing
from hessgpu_tpu_torch.utils.graphs import GraphCache

H, W = 64, 80
CONFIGS = {"default": {},
           "sd-ofix": dict(compute_descriptors=False, fixed_orientation=True)}


@pytest.fixture(scope="module")
def frames():
    return torch.from_numpy(texture_frame(0, H, W)[None])


@pytest.fixture(scope="module")
def traced(frames):
    """(table, trace) of one traced detect_batch a configuration, made at
    its first use."""
    made = {}

    def get(name):
        if name not in made:
            made[name] = _traced_detect(frames, SiftConfig(**CONFIGS[name]))
        return made[name]
    return get


@pytest.fixture(autouse=True)
def empty_trace():
    timing.take_trace()
    yield
    timing.take_trace()


def _traced_detect(frames, cfg):
    with timing.tracing():
        table = detect_batch(frames, cfg, device="cpu")
    return table, timing.take_trace()


def test_tracing_is_off_by_default_and_records_nothing(frames):
    assert not timing.tracing_enabled()
    assert timing.span("a") is timing.span("b")       # one shared object
    with timing.span("a") as s:
        assert s is None
    detect_batch(frames, SiftConfig(**CONFIGS["sd-ofix"]), device="cpu")
    trace = timing.take_trace()
    assert trace.spans == [] and trace.stages == []


def test_the_switch_nests_and_restores():
    with timing.tracing():
        assert timing.tracing_enabled() and timing.stage_tracing_enabled()
        with timing.tracing(False):
            assert not timing.tracing_enabled()
            assert not timing.stage_tracing_enabled()
        with timing.tracing(stages=False):
            assert timing.tracing_enabled()
            assert not timing.stage_tracing_enabled()
        assert timing.tracing_enabled() and timing.stage_tracing_enabled()
    assert not timing.tracing_enabled()
    assert not timing.stage_tracing_enabled()


def test_host_spans_alone_leave_the_stages_out(frames):
    with timing.tracing(stages=False):
        detect_batch(frames, SiftConfig(**CONFIGS["sd-ofix"]), device="cpu")
    trace = timing.take_trace()
    assert [s.name for s in trace.spans] == ["batch.detect_batch"]
    assert trace.stages == []


def test_tables_are_bit_equal_with_tracing_on_and_off(frames, traced):
    off = detect_batch(frames, SiftConfig(), device="cpu")
    on, _ = traced("default")
    assert int(off.count().sum()) > 0
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_a_traced_detect_batch_is_one_request_of_its_stages(traced, name):
    cfg = SiftConfig(**CONFIGS[name])
    _, trace = traced(name)
    top = [s for s in trace.spans if s.name == "batch.detect_batch"]
    assert len(top) == 1 and top[0].parent == 0
    assert {s.request for s in trace.spans} == {top[0].id}
    rest = [s for s in trace.spans if s is not top[0]]
    assert rest and all(s.parent == top[0].id for s in rest)
    assert all(top[0].start_ns <= s.start_ns <= s.end_ns <= top[0].end_ns
               for s in rest)
    n_oct = make_plan(H, W, cfg).num_octaves
    want = {"BUILD_PYRAMID": 1, "DETECT_KEYPOINTS": n_oct,
            "GENERATE_FEATURE_LIST": n_oct + 1}
    if not cfg.fixed_orientation:
        want.update(COMPUTE_ORIENTATIONS=1, MULTI_ORIENTATIONS=1)
    if cfg.compute_descriptors:
        want["COMPUTE_DESCRIPTORS"] = 1
    got = {}
    for s in rest:
        got[s.name] = got.get(s.name, 0) + 1
    assert got == want
    assert trace.stages == []           # device stages: on a card only


def test_take_trace_clears_the_buffer():
    with timing.tracing():
        with timing.span("a"):
            pass
    assert [s.name for s in timing.take_trace().spans] == ["a"]
    again = timing.take_trace()
    assert again.spans == [] and again.stages == []


def test_the_buffer_is_bounded(monkeypatch):
    import collections
    monkeypatch.setattr(timing, "_spans", collections.deque(maxlen=3))
    with timing.tracing():
        for i in range(5):
            with timing.span(f"s{i}"):
                pass
    assert [s.name for s in timing.take_trace().spans] == ["s2", "s3", "s4"]


def test_a_span_closes_when_its_block_raises():
    with timing.tracing():
        with pytest.raises(ValueError, match="CUDA tensor"):
            with timing.span("outer"):
                GraphCache(1)(("k",), lambda x: x, torch.zeros(3))
        with timing.span("after") as after:
            pass
    spans = timing.take_trace().spans
    assert [s.name for s in spans] == ["outer", "after"]
    assert after.parent == 0 and spans[1].request == spans[1].id


def test_phases_are_back_to_back_children_of_the_open_span():
    assert timing.phases() is None                  # tracing off
    with timing.tracing():
        with timing.span("outer") as outer:
            rec = timing.phases()
            time.sleep(0.002)
            assert rec.mark("a") == outer.request
            time.sleep(0.002)
            rec.mark("b")
        rec = timing.phases()
        rec.mark("alone")
    a, b, top, alone = timing.take_trace().spans
    assert (a.name, b.name, top.name) == ("a", "b", "outer")
    assert a.parent == b.parent == outer.id
    assert a.request == b.request == outer.request
    assert outer.start_ns <= a.start_ns < a.end_ns == b.start_ns
    assert b.end_ns <= top.end_ns and a.end_ns - a.start_ns >= 2_000_000
    assert alone.parent == 0 and alone.request == alone.id


def test_threads_keep_their_own_requests():
    seen = {}

    def work(tag):
        with timing.span(f"outer.{tag}") as outer:
            time.sleep(0.01)
            with timing.span(f"inner.{tag}"):
                time.sleep(0.01)
        seen[tag] = outer.request

    with timing.tracing():
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    spans = {s.name: s for s in timing.take_trace().spans}
    for tag in "ab":
        outer, inner = spans[f"outer.{tag}"], spans[f"inner.{tag}"]
        assert inner.parent == outer.id and outer.parent == 0
        assert inner.request == outer.request == seen[tag] == outer.id
        assert inner.thread == outer.thread
    assert seen["a"] != seen["b"]


class _FakeEvent:
    def __init__(self, t_ms):
        self.t_ms, self.waited = t_ms, False

    def elapsed_time(self, end):
        return end.t_ms - self.t_ms

    def synchronize(self):
        self.waited = True


def test_stage_ms_sums_pairs_per_bucket_and_fills_other():
    e = [_FakeEvent(t) for t in (0.0, 0.25, 1.0, 1.5, 1.75, 2.5, 3.0)]
    pairs = [("DETECT_KEYPOINTS", e[1], e[2]),
             ("GENERATE_FEATURE_LIST", e[2], e[3]),
             ("DETECT_KEYPOINTS", e[3], e[4]),
             ("GENERATE_FEATURE_LIST", e[4], e[5])]
    ms = timing.stage_ms(pairs, (e[0], e[6]))
    assert e[6].waited
    assert list(ms) == ["DETECT_KEYPOINTS", "GENERATE_FEATURE_LIST",
                        "OTHER", "TOTAL"]
    assert ms["DETECT_KEYPOINTS"] == 1.0
    assert ms["GENERATE_FEATURE_LIST"] == 1.25
    assert ms["TOTAL"] == 3.0 and ms["OTHER"] == 0.75


def test_take_trace_reads_the_graphs_left_unread():
    class Graph:
        reads = 0

        def read_stages(self):
            self.reads += 1
            timing.record_stages(7, "graph", {"TOTAL": 1.0, "OTHER": 1.0})

    g = Graph()
    timing.defer_read(g)
    timing.defer_read(g)                # one entry a graph
    trace = timing.take_trace()
    assert g.reads == 1
    assert trace.stages == [timing.DeviceStages(7, "graph",
                                                {"TOTAL": 1.0, "OTHER": 1.0})]
    assert timing.take_trace().stages == [] and g.reads == 1


def test_replay_stage_breakdown_needs_a_graph():
    with pytest.raises(RuntimeError, match="replays no graph"):
        timing.replay_stage_breakdown(lambda x: x + 1, torch.zeros(3),
                                      runs=1)
    assert not timing.tracing_enabled()


def test_replay_stage_breakdown_reads_its_own_requests_alone():
    """Records of other requests - the caller's spans, another thread's
    stages, a graph left unread - are neither counted nor dropped; each
    call is a request of its own under the caller's open span."""
    class Graph:
        """A traced graph's entry point: a replay records its stages at
        the next call or when read."""
        calls, unread = 0, None

        def read_stages(self):
            if self.unread is not None:
                timing.record_stages(self.unread, "graph", self.ms)
                self.unread = None

        def __call__(self, x):
            self.read_stages()
            self.calls += 1
            with timing.span("graphs.launch") as launch:
                self.ms = {"BUILD_PYRAMID": float(self.calls), "OTHER": 0.5,
                           "TOTAL": self.calls + 0.5}
            self.unread = launch.request
            timing.defer_read(self)
            return x

    class Foreign:
        def read_stages(self):
            timing.record_stages(-2, "graph", {"TOTAL": 9.0})

    g, other = Graph(), Foreign()       # held: the tracer keeps weak refs
    with timing.tracing(stages=False), timing.span("caller") as caller:
        with timing.span("caller.before"):
            pass
        timing.record_stages(-1, "graph", {"TOTAL": 7.0})
        timing.defer_read(other)
        rep = timing.replay_stage_breakdown(g, torch.zeros(3), runs=3)
        assert timing.tracing_enabled()
        assert not timing.stage_tracing_enabled()
    assert g.calls == 4
    assert tuple(rep) == timing.REFERENCE_BUCKETS
    assert rep["BUILD_PYRAMID"] == 3.0        # calls 2-4; the first dropped
    assert rep["OTHER"] == 0.5 and rep["TOTAL"] == 3.5
    assert rep["DETECT_KEYPOINTS"] == 0.0
    trace = timing.take_trace()
    assert [s.name for s in trace.spans] == ["caller.before", "caller"]
    assert {s.request for s in trace.spans} == {caller.request}
    assert sorted(st.request for st in trace.stages) == [-2, -1]


def test_spans_share_the_profilers_clock():
    """Each span encloses the profiler's event of the op it wraps (one
    clock); the closest of five lies within 100 us on either side (the
    profiler's own cost of an op, and the scheduler's, apart)."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(4_000_000)                  # a cumsum of ~5 ms
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x.cumsum(0)                             # the profiler's first op
        with timing.tracing():
            for _ in range(5):
                with timing.span("around"):
                    x.cumsum(0)
    spans = timing.take_trace().spans
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ops = [e.time_range for e in prof.events() if e.name == "aten::cumsum"]
    assert len(spans) == 5 and len(ops) == 6
    before, after = [], []
    for sp, op in zip(spans, ops[1:]):
        start, end = t0 + op.start * 1000, t0 + op.end * 1000
        assert sp.start_ns <= start <= end <= sp.end_ns
        before.append(start - sp.start_ns)
        after.append(sp.end_ns - end)
    assert min(before) <= 100_000 and min(after) <= 100_000


def test_profile_trace_writes_the_program_spans(tmp_path):
    with timing.tracing():
        with timing.span("kept"):
            pass
        with timing.profile_trace(str(tmp_path / "trace")) as d:
            assert not timing.stage_tracing_enabled()
            with timing.span("outer"):
                torch.ones(8).cumsum(0)
        assert timing.stage_tracing_enabled()
    assert [s.name for s in timing.take_trace().spans] == ["kept"]
    with open(os.path.join(d, "trace.json")) as f:
        doc = json.load(f)
    program = [e for e in doc["traceEvents"] if e.get("cat") == "program"]
    assert [e["name"] for e in program] == ["outer"]
    (cumsum,) = [e for e in doc["traceEvents"]
                 if e.get("name") == "aten::cumsum"]
    span = program[0]
    assert span["ts"] <= cumsum["ts"]
    assert cumsum["ts"] + cumsum["dur"] <= span["ts"] + span["dur"]
    assert span["args"]["parent"] == 0
    assert span["args"]["request"] == span["args"]["id"]
