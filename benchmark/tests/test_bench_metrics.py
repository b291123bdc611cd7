"""The metric arithmetic on synthetic timings and traces: the rate is every
frame over all of the window's time, the 95th percentile is over every
request, the trace's busy time is the union of the device's work."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from benchlib import manifest, trace  # noqa: E402
from benchlib.cell import Reservoir, _by_second, least_seconds  # noqa: E402


def read(name, run):
    return manifest.metric_reader(name)(run)


def stalled_run():
    """1000 requests of 2 ms and one stall of 500 ms, batch 16."""
    lat = [0.002] * 1000
    lat[500] = 0.5
    return SimpleNamespace(latencies_s=lat, enqueue_s=[0.0004] * 1001,
                           window_s=sum(lat), requests=len(lat),
                           frames=16 * len(lat), batch=16, setup_s=12.5,
                           trace=None, counters={}, traced_frames=0,
                           kernel_table={}, kernel_least_s={}, peaks=None)


def test_rate_is_all_frames_over_all_time():
    run = stalled_run()
    got = read("frames_per_s", run)
    assert got == pytest.approx(16 * 1000 / (0.002 * 999 + 0.5))
    # not the mean of per-request rates, which the stall barely moves
    assert got < 0.85 * np.mean([16 / x for x in run.latencies_s])


def test_p95_is_over_every_request():
    run = stalled_run()
    run.latencies_s = [0.002] * 900 + [0.010] * 100
    assert read("request_p95_ms", run) == pytest.approx(10.0)
    run.latencies_s = [0.002] * 960 + [0.5] * 40
    assert read("request_p95_ms", run) == pytest.approx(2.0)
    run.latencies_s = [0.002] * 940 + [0.5] * 60
    assert read("request_p95_ms", run) == pytest.approx(500.0)


def test_setup_and_enqueue():
    run = stalled_run()
    assert read("setup_s", run) == 12.5
    assert read("enqueue_ms", run) == pytest.approx(0.4)
    run.enqueue_s = []
    assert read("enqueue_ms", run) is None


def test_window_bins():
    assert _by_second([0.4, 0.4, 0.4, 0.9], 2.0, 16) == [32, 16, 16]


def test_reservoir_is_uniform_and_seeded():
    import random
    counts = np.zeros(50)
    for seed in range(2000):
        r = Reservoir(5, random.Random(seed))
        for i in range(50):
            r.offer(i)
        counts[r.items] += 1
    assert counts.sum() == 10000 and counts.min() > 120 and counts.max() < 290
    a, b = Reservoir(3, random.Random(7)), Reservoir(3, random.Random(7))
    for i in range(100):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items


class Ev(SimpleNamespace):
    pass


def ev(name, start, end, dev="DeviceType.CUDA"):
    return Ev(name=name, device_type=dev,
              time_range=SimpleNamespace(start=start, end=end),
              is_user_annotation=False)


def fake_trace():
    """Two requests of 1000 us: per request a graph launch on the host at
    +10, kernels 100-400 (two overlapping) and 500-900, the host waiting
    from +300 to the end."""
    evs = []
    for r in (0, 1000):
        evs += [ev("cudaGraphLaunch", r + 10, r + 60, "DeviceType.CPU"),
                ev("cudaEventSynchronize", r + 300, r + 1000,
                   "DeviceType.CPU"),
                ev("(anonymous namespace)::chain_kernel(float const*)",
                   r + 100, r + 300),
                ev("void at::native::scan<int>(int*)", r + 200, r + 400),
                ev("(anonymous namespace)::detect_kernel(float const*)",
                   r + 500, r + 900)]
    return evs


def test_trace_reduction():
    s = trace.reduce(fake_trace(), requests=2)
    assert s.window_s == pytest.approx(1990e-6)          # 10 .. 2000
    assert s.busy_s == pytest.approx(2 * 700e-6)
    assert s.host_launches == 2
    assert s.by_kernel["void at::native::scan<int>(int*)"] == \
        pytest.approx([400e-6, 2])
    # idle: 10-100 (in the launch until 60, then none), 400-500 and
    # 900-1100 and so on; labelled by the runtime call holding the midpoint
    assert sum(s.idle_by_host.values()) == pytest.approx(1990e-6 - 1400e-6)
    assert s.idle_by_host["cudaEventSynchronize"] == pytest.approx(
        (100 + 200 + 100 + 100) * 1e-6)
    assert s.idle_by_host["cudaGraphLaunch"] == pytest.approx(90e-6)
    assert trace.symbol("(anonymous namespace)::detect_kernel(float*)") == \
        "detect_kernel"
    assert trace.symbol("void at::native::vectorized_elementwise_kernel<4, "
                        "at::native::FillFunctor<float> >(int)") == \
        "vectorized_elementwise_kernel"


def traced_run():
    s = trace.reduce(fake_trace(), requests=2)
    return SimpleNamespace(trace=s, traced_frames=32, requests=10,
                           window_s=10 * 1000e-6,
                           kernel_table={"chain_kernel": ["octave_chain"],
                                         "detect_kernel": ["detect_octave"]},
                           kernel_least_s={"chain_kernel": 100e-6,
                                           "detect_kernel": 200e-6},
                           peaks=(3.35e12, 67e12))


def test_device_metrics_from_the_trace():
    run = traced_run()
    assert read("kernel_ms_per_frame", run) == pytest.approx(
        (400e-6 + 800e-6) / 32 * 1e3)
    assert read("torch_ops_ms_per_frame", run) == pytest.approx(
        400e-6 / 32 * 1e3)
    assert read("kernel_roofline", run) == pytest.approx(
        100.0 * 300e-6 / 1200e-6)
    # busy 700 us a request against the untraced window's 1000 us
    assert read("device_idle_share", run) == pytest.approx(30.0)
    assert read("host_launches_per_request", run) == pytest.approx(1.0)
    run.peaks = None
    assert read("kernel_roofline", run) is None


def test_readers_find_nothing_without_a_trace():
    run = stalled_run()
    for name in ("host_launches_per_request", "torch_ops_ms_per_frame",
                 "kernel_ms_per_frame", "kernel_roofline",
                 "device_idle_share", "capture_s"):
        assert read(name, run) is None, name


def test_least_seconds_of_a_fused_kernel():
    """A kernel doing two stages is bounded launch by launch by their summed
    work, never above the sum of their own bounds."""
    ctx = dict(batch=2, octave_shapes=[(8, 8), (4, 4)], num_levels=5,
               chain_taps=[5, 5, 7, 9])
    peaks = (1.0, 1e9)                          # bytes bind
    got = least_seconds(ctx, ["octave_chain", "decimate"], peaks,
                        manifest.ROOT)
    want = (4 * 128 * 5 + 4 * 32) + (4 * 32 * 5)     # octave 0 + 1
    assert got == pytest.approx(want)
