"""The readings of the port's own trace (benchlib/program_spans.py) on
planted spans and stage records: self times, the host's split of a request,
the stages a frame, and idle gaps labelled by the innermost span."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from benchlib import program_spans as ps  # noqa: E402


def sp(name, start, end, id, parent=0, request=None):
    """A span at microseconds start..end."""
    return SimpleNamespace(name=name, start_ns=start * 1000,
                           end_ns=end * 1000, id=id, parent=parent,
                           request=request or id)


def request(r, t):
    """One traced detect_batch of 100 us starting at t: lookup 10,
    copy in 5, launch 30, clones 15, the rest (40) the entry's own."""
    return [sp("batch.detect_batch", t, t + 100, r, 0, r),
            sp("graphs.lookup", t + 10, t + 20, r + 1, r, r),
            sp("graphs.copy_in", t + 30, t + 35, r + 2, r, r),
            sp("graphs.launch", t + 35, t + 65, r + 3, r, r),
            sp("graphs.clone_out", t + 65, t + 80, r + 4, r, r)]


def test_self_time_is_the_span_less_its_children():
    spans = request(1, 0) + [sp("graphs.read_stages", 12, 15, 9, 2, 1)]
    st = ps.self_times(spans)
    assert st[1] == 40_000 and st[2] == 7_000 and st[4] == 30_000


def test_overlapping_children_are_covered_once():
    spans = [sp("p", 0, 100, 1), sp("a", 10, 50, 2, 1, 1),
             sp("b", 40, 60, 3, 1, 1), sp("c", 90, 120, 4, 1, 1)]
    assert ps.self_times(spans)[1] == 100_000 - 50_000 - 10_000


def test_the_host_split_is_a_mean_a_request():
    spans = request(1, 0) + request(10, 200)
    spans[3] = sp("graphs.launch", 35, 75, 4, 1, 1)    # 40 us, not 30
    spans[4] = sp("graphs.clone_out", 75, 80, 5, 1, 1)
    h = ps.host_split(spans)
    assert h["entry"] == pytest.approx(0.050)          # 40 + 10 us
    assert h["launch"] == pytest.approx(0.035)
    assert h["io"] == pytest.approx(0.015)              # (10 + 20) / 2 us
    assert h["read"] == 0
    assert ps.host_split([]) == {}


def test_stage_means_are_per_frame_over_graph_replays():
    stages = [SimpleNamespace(source="graph", ms={"BUILD_PYRAMID": 0.4,
                                                  "TOTAL": 1.6}),
              SimpleNamespace(source="graph", ms={"BUILD_PYRAMID": 0.8,
                                                  "TOTAL": 2.4}),
              SimpleNamespace(source="eager", ms={"BUILD_PYRAMID": 9.0})]
    ms, n = ps.stage_means(stages, batch=4)
    assert n == 2
    assert ms == pytest.approx({"BUILD_PYRAMID": 0.15, "TOTAL": 0.5})
    assert ps.stage_means([], 4) == ({}, 0)


def test_a_point_takes_the_innermost_span_that_holds_it():
    spans = request(1, 0)
    pts = [t * 1000 for t in (5, 15, 25, 50, 70, 90, 150)]
    assert ps.innermost_labels(spans, pts) == [
        "batch.detect_batch", "graphs.lookup", "batch.detect_batch",
        "graphs.launch", "graphs.clone_out", "batch.detect_batch",
        "outside"]


def test_a_long_span_before_keeps_holding_a_later_point():
    spans = [sp("outer", 0, 100, 1), sp("short", 10, 20, 2, 1, 1),
             sp("other", 30, 40, 3)]
    assert ps.innermost_labels(spans, [50_000, 35_000]) == ["outer", "other"]


def test_idle_gaps_are_labelled_and_ranked():
    spans = request(1, 0) + request(10, 200)
    us = 1000
    work = [(50 * us, 120 * us), (110 * us, 190 * us),   # merged: 50-190
            (240 * us, 260 * us)]
    by, longest = ps.idle_gaps(work, spans, 0, 320 * us, longest=2)
    # gaps 0-50 (midpoint 25: no child), 190-240 (215: the lookup),
    # 260-320 (290: after the clones)
    assert by == pytest.approx({"batch.detect_batch": 0.11,
                                "graphs.lookup": 0.05})
    assert longest == [("batch.detect_batch", pytest.approx(0.06)),
                       ("batch.detect_batch", pytest.approx(0.05))]
