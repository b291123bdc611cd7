"""The compiled-program layer on the card: captured CUDA graphs against the
eager route they capture. A CUDA graph has no CPU counterpart, so these
tests need one NVIDIA GPU and nvcc; everywhere else they skip. They import
nothing of JAX:

    python -m pytest tests/test_torch_compiled_gpu.py -q --noconftest

Whether there is a card is decided inside the `card` fixture, never at
import. A replay launches the kernels and PyTorch operations of the eager
call, in the same order, on the same inputs, so every result is compared
bit for bit.
"""

import statistics
import threading

import numpy as np
import pytest
import torch

from hessgpu_tpu_torch import HessianSift, SiftConfig, detect_batch, make_plan
from hessgpu_tpu_torch import pyramid as tpyr
from hessgpu_tpu_torch.convert import ba_from_numpy
from hessgpu_tpu_torch.sfm import ba as tba
from hessgpu_tpu_torch.sfm.synthetic import texture_frame
from hessgpu_tpu_torch.utils.graphs import GraphCache, disable_graphs

pytestmark = pytest.mark.gpu

CONFIGS = {"default": {},
           "sd-ofix": dict(compute_descriptors=False, fixed_orientation=True),
           "dog": dict(detector="dog")}


def _eager_launches(cfg, h, w):
    """The kernel launches of one eager detect_batch call (the pins of
    test_torch_cuda_kernels.py), without the kernels launched no time."""
    n_oct = make_plan(h, w, cfg).num_octaves
    per_keypoint = int(not cfg.fixed_orientation)
    counts = {"blur": 1, "octave_chain": n_oct, "detect_octave": n_oct,
              "orientation": per_keypoint,
              "descriptor": int(cfg.compute_descriptors),
              "row_counts": n_oct, "level_scan": 1, "table_scatter": 1}
    return {k: n for k, n in counts.items() if n}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: a CUDA graph has no CPU "
                    "counterpart")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def frames(card):
    """texture_frame(0..31) at 480x640 on the card."""
    return torch.from_numpy(np.stack(
        [texture_frame(s, 480, 640) for s in range(32)])).to(card)


def _same(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def _tables_equal(a, b):
    return all(_same(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("batch", [16, 1])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_replay_equals_eager(card, frames, name, batch):
    cfg = SiftConfig(**CONFIGS[name])
    imgs = frames[:batch]
    with disable_graphs():
        eager = detect_batch(imgs, cfg)
    first = detect_batch(imgs, cfg)          # captures
    again = detect_batch(imgs, cfg)          # replays
    assert _tables_equal(first, eager) and _tables_equal(again, eager)
    assert int(eager.count().sum()) > 0
    # the graph the calls replayed holds the eager route's kernel launches
    st = tpyr._PIPELINE_GRAPHS.stats()[-1]
    assert st.key[0][1] == tpyr._CfgKey(cfg)
    assert st.key[1][0][0] == tuple(imgs.shape)
    assert st.launches == _eager_launches(cfg, *imgs.shape[1:])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_new_inputs_give_new_results_without_aliasing(card, frames, name):
    cfg = SiftConfig(**CONFIGS[name])
    a = detect_batch(frames[:16], cfg)
    kept = [t.clone() for t in a]
    b = detect_batch(frames[16:], cfg)
    with disable_graphs():
        want_b = detect_batch(frames[16:], cfg)
    assert _tables_equal(b, want_b)
    assert _tables_equal(a, kept), "a later replay changed an earlier result"
    assert not _same(a.x, b.x)
    assert all(x.data_ptr() != y.data_ptr() for x, y in zip(a, b))


def test_hessian_sift_run_replays(card, frames):
    img = frames[0].cpu().numpy()
    sift = HessianSift(SiftConfig())
    with disable_graphs():
        want = sift.run(img)
    for _ in range(2):
        got = sift.run(img)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("path", ["hessian_sift_run", "detect_batch"])
def test_threads_sharing_a_graph_keep_their_own_results(card, frames, path):
    """Two threads (as the feature server's clients) call the entry point at
    once with different frames of one size, so they share one graph: each
    gets its own frames' result, call after call."""
    cfg = SiftConfig()
    if path == "hessian_sift_run":
        inputs = [frames[i].cpu().numpy() for i in (0, 1)]
        runs = [HessianSift(cfg).run, HessianSift(cfg).run]
        equal = lambda a, b: all(np.array_equal(a[k], b[k]) for k in a)
    else:
        inputs = [frames[:16], frames[16:]]
        runs = [lambda x: detect_batch(x, cfg)] * 2
        equal = _tables_equal
    with disable_graphs():
        want = [run(x) for run, x in zip(runs, inputs)]
    runs[0](inputs[0])                        # captured before the threads
    captures = tpyr._PIPELINE_GRAPHS.captures
    wrong, errors = [0, 0], []
    start = threading.Barrier(2)

    def client(i):
        try:
            start.wait()
            for _ in range(40):
                if not equal(runs[i](inputs[i]), want[i]):
                    wrong[i] += 1
        except Exception as e:                # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and wrong == [0, 0]
    assert tpyr._PIPELINE_GRAPHS.captures == captures


def test_threads_capture_one_at_a_time(card, frames):
    """Two threads meet new keys at once: both captures succeed, and each
    result equals the eager route's."""
    tpyr.run_pipeline_jit.clear_cache()
    cfgs = [SiftConfig(), SiftConfig(**CONFIGS["sd-ofix"])]
    with disable_graphs():
        want = [detect_batch(frames[:4], c) for c in cfgs]
    got, errors = [None, None], []
    start = threading.Barrier(2)

    def client(i):
        try:
            start.wait()
            got[i] = detect_batch(frames[:4], cfgs[i])
        except Exception as e:                # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert all(_tables_equal(g, w) for g, w in zip(got, want))
    assert len(tpyr._PIPELINE_GRAPHS) == 2


def _ba(card, cams=16, pts=512, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.uniform(-1, 1, (pts, 3)).astype(np.float32)
    X[:, 2] += 5.0
    t = np.zeros((cams, 3), np.float32)
    t[:, 0] = np.linspace(-1, 1, cams)
    R = np.tile(np.eye(3, dtype=np.float32), (cams, 1, 1))
    intr = np.tile(np.array([500.0, 320.0, 240.0], np.float32), (cams, 1))
    cam_idx = np.repeat(np.arange(cams), pts)
    pt_idx = np.tile(np.arange(pts), cams)
    Xc = X[pt_idx] + t[cam_idx]
    uv = Xc[:, :2] / Xc[:, 2:] * 500.0 + np.array([320.0, 240.0])
    return ba_from_numpy(
        device=card, R=R, t=t + rng.normal(0, 0.02, t.shape),
        X=X + rng.normal(0, 0.02, X.shape), intr=intr, cam_idx=cam_idx,
        pt_idx=pt_idx, uv=uv + rng.normal(0, 0.3, uv.shape),
        weight=np.ones(len(uv), np.float32))


def _lm_steps(state, prob, n=3):
    lam = torch.tensor(1e-3, device=state.R.device)
    out = []
    for _ in range(n):
        state, lam, c0, c1, acc = tba.lm_step(state, prob, lam)
        out.append((state, lam, c0, c1, acc))
    return out


def test_three_lm_step_replays_equal_eager(card):
    state, prob = _ba(card)
    with disable_graphs():
        eager = _lm_steps(state, prob)
    replayed = _lm_steps(state, prob)
    again = _lm_steps(state, prob)
    for e, r, r2 in zip(eager, replayed, again):
        for x, y, z in zip(e[0] + e[1:], r[0] + r[1:], r2[0] + r2[1:]):
            assert _same(x, y) and _same(y, z)


def test_the_cache_bound_and_clear_on_the_card(card):
    cache = GraphCache(max_bytes=1 << 40)
    fn = lambda x: (x * 2 + 1, x.sum())                  # noqa: E731
    xs = [torch.arange(n, dtype=torch.float32, device=card)
          for n in (4, 5, 6)]
    for i, x in enumerate(xs):
        y, s = cache(("f",), fn, x)
        assert _same(y, x * 2 + 1) and _same(s, x.sum())
        if i == 0:
            # room for two graphs of this size (each a small pool segment)
            one = cache.stats()[0].pool_reserved_bytes
            assert one > 0
            cache.max_bytes = int(2.5 * one)
    assert len(cache) == 2 and cache.captures == 3
    assert cache.reserved_bytes() <= cache.max_bytes
    assert [k[1][0][0] for k in cache.keys()] == [(5,), (6,)]
    cache(("f",), fn, xs[1])                              # hit: newest now
    cache(("f",), fn, xs[0])                              # recaptured
    assert cache.captures == 4
    assert [k[1][0][0] for k in cache.keys()] == [(5,), (4,)]
    assert all(st.replays >= 1 for st in cache.stats())
    with pytest.raises(ValueError, match="CUDA tensor"):
        cache(("f",), fn, xs[0].cpu())
    before = torch.cuda.memory_allocated(card)
    cache.clear()
    assert len(cache) == 0
    assert torch.cuda.memory_allocated(card) < before


def test_clear_cache_frees_the_pipeline_graphs(card, frames):
    tpyr.run_pipeline_jit.clear_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(card)
    detect_batch(frames[:16], SiftConfig())
    assert len(tpyr._PIPELINE_GRAPHS) == 1
    held = torch.cuda.memory_allocated(card)
    assert held > before
    tpyr.run_pipeline_jit.clear_cache()
    assert len(tpyr._PIPELINE_GRAPHS) == 0
    assert torch.cuda.memory_allocated(card) < held


# ---------------------------------------------------------------------------
# tracing on the graph route (utils/timing.py)
# ---------------------------------------------------------------------------

from hessgpu_tpu_torch.utils import timing  # noqa: E402

STAGES = {"default": ("BUILD_PYRAMID", "DETECT_KEYPOINTS",
                      "GENERATE_FEATURE_LIST", "COMPUTE_ORIENTATIONS",
                      "MULTI_ORIENTATIONS", "COMPUTE_DESCRIPTORS"),
          "sd-ofix": ("BUILD_PYRAMID", "DETECT_KEYPOINTS",
                      "GENERATE_FEATURE_LIST")}


@pytest.mark.parametrize("name", sorted(STAGES))
def test_a_traced_replay_reports_every_bucket(card, frames, name):
    cfg = SiftConfig(**CONFIGS[name])
    want = detect_batch(frames[:16], cfg)
    timing.take_trace()
    with timing.tracing():
        detect_batch(frames[:16], cfg)           # captures the traced graph
        timing.take_trace()
        got = [detect_batch(frames[:16], cfg) for _ in range(3)]
        trace = timing.take_trace()
    for table in got:
        assert _tables_equal(table, want)
    top = [s.id for s in trace.spans if s.name == "batch.detect_batch"]
    assert len(top) == 3 and len(trace.stages) == 3
    assert [st.request for st in trace.stages] == top
    for st in trace.stages:
        assert st.source == "graph"
        assert tuple(st.ms) == STAGES[name] + ("OTHER", "TOTAL")
        assert all(st.ms[b] > 0 for b in STAGES[name])
        assert st.ms["OTHER"] >= 0
        assert sum(st.ms.values()) - st.ms["TOTAL"] == pytest.approx(
            st.ms["TOTAL"], rel=1e-6)


def test_an_eager_traced_call_reports_its_stages(card, frames):
    cfg = SiftConfig()
    timing.take_trace()
    with disable_graphs(), timing.tracing():
        detect_batch(frames[:16], cfg)
        trace = timing.take_trace()
    (top,) = [s for s in trace.spans if s.name == "batch.detect_batch"]
    (st,) = trace.stages
    assert st.source == "eager" and st.request == top.id
    assert tuple(st.ms) == STAGES["default"]
    assert all(v > 0 for v in st.ms.values())


def test_tracing_captures_a_key_of_its_own(card, frames):
    cfg = SiftConfig()
    tpyr.run_pipeline_jit.clear_cache()
    captures = tpyr._PIPELINE_GRAPHS.captures
    want = detect_batch(frames[:16], cfg)
    (plain,) = tpyr._PIPELINE_GRAPHS.stats()
    assert plain.key[-1] is False
    with timing.tracing():
        detect_batch(frames[:16], cfg)
    assert tpyr._PIPELINE_GRAPHS.captures == captures + 2
    assert [k[-1] for k in tpyr._PIPELINE_GRAPHS.keys()] == [False, True]
    timing.take_trace()
    again = detect_batch(frames[:16], cfg)     # tracing off: the first graph
    assert _tables_equal(again, want)
    assert tpyr._PIPELINE_GRAPHS.captures == captures + 2
    st = {s.key[-1]: s for s in tpyr._PIPELINE_GRAPHS.stats()}
    assert st[False].replays == 2 and st[True].replays == 1
    assert st[False].launches == st[True].launches == plain.launches
    assert timing.take_trace() == timing.Trace([], [])


def test_device_stage_report_reads_the_replayed_graph(card, frames):
    sift = HessianSift(SiftConfig())
    rep = sift.device_stage_report(frames[0].cpu().numpy())
    assert tuple(rep) == timing.REFERENCE_BUCKETS
    assert all(rep[b] > 0 for b in STAGES["default"])
    assert rep["FEATURES_REDUCTION"] == 0
    assert sum(rep.values()) - rep["TOTAL"] == pytest.approx(rep["TOTAL"],
                                                             rel=1e-6)
    assert any(k[-1] for k in tpyr._PIPELINE_GRAPHS.keys())
    assert not timing.tracing_enabled()


def test_profile_trace_replays_the_untraced_graph(card, frames, tmp_path):
    import json
    import os
    cfg = SiftConfig()
    tpyr.run_pipeline_jit.clear_cache()
    want = detect_batch(frames[:16], cfg)
    captures = tpyr._PIPELINE_GRAPHS.captures
    with timing.profile_trace(str(tmp_path / "trace")) as d:
        got = detect_batch(frames[:16], cfg)
    assert _tables_equal(got, want)
    assert tpyr._PIPELINE_GRAPHS.captures == captures
    assert [k[-1] for k in tpyr._PIPELINE_GRAPHS.keys()] == [False]
    with open(os.path.join(d, "trace.json")) as f:
        doc = json.load(f)
    names = [e["name"] for e in doc["traceEvents"]
             if e.get("cat") == "program"]
    assert names.count("batch.detect_batch") == 1
    assert names.count("graphs.launch") == 1
    assert timing.take_trace() == timing.Trace([], [])


def test_each_launch_span_encloses_its_graph_launch(card, frames):
    """The program's spans and the profiler's runtime events on one clock:
    each graphs.launch span holds its cudaGraphLaunch, the median margin on
    either side within 20 us (a single one also holds the host's
    scheduling)."""
    from torch.profiler import ProfilerActivity, profile
    cfg = SiftConfig()
    with timing.tracing():
        detect_batch(frames[:16], cfg)
        torch.cuda.synchronize()
        timing.take_trace()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                detect_batch(frames[:16], cfg)
                torch.cuda.synchronize()
        spans = [s for s in timing.take_trace().spans
                 if s.name == "graphs.launch"]
    t0 = prof.profiler.kineto_results.trace_start_ns()
    calls = sorted((t0 + e.time_range.start * 1000,
                    t0 + e.time_range.end * 1000) for e in prof.events()
                   if e.name.startswith("cudaGraphLaunch"))
    assert len(spans) == len(calls) == 10
    for sp, (a, b) in zip(spans, calls):
        assert sp.start_ns <= a <= b <= sp.end_ns
    assert statistics.median(a - sp.start_ns
                             for sp, (a, _) in zip(spans, calls)) <= 20_000
    assert statistics.median(sp.end_ns - b
                             for sp, (_, b) in zip(spans, calls)) <= 20_000


# ---------------------------------------------------------------------------
# the re-entry program, the matcher, the RANSAC cores, the pose-graph step
# ---------------------------------------------------------------------------

from hessgpu_tpu_torch import describe as tdesc  # noqa: E402
from hessgpu_tpu_torch import describe_keypoints, describe_rectangles  # noqa
from hessgpu_tpu_torch import detect_and_describe, to_numpy_trimmed  # noqa
from hessgpu_tpu_torch import matcher as tm  # noqa: E402
from hessgpu_tpu_torch.sfm import posegraph as tpg  # noqa: E402
from hessgpu_tpu_torch.sfm import twoview as ttv  # noqa: E402


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return _same(a, b)
    return np.array_equal(a, b)


@pytest.fixture(scope="module")
def reentry(card):
    """texture_frame(0) at 480x640, its own features (x, y, sigma, theta),
    and frame 1's."""
    out = []
    for s in (0, 1):
        img = texture_frame(s, 480, 640)
        f = to_numpy_trimmed(detect_and_describe(img, SiftConfig())[0])
        out.append((img, np.stack([f["x"], f["y"], f["sigma"], f["theta"]],
                                  axis=1)))
    return out


@pytest.mark.parametrize("given_theta", [True, False])
def test_reentry_replay_equals_eager(card, reentry, given_theta):
    img, keys = reentry[0]
    k = keys if given_theta else keys[:, :3]
    describe_keypoints.clear_cache()
    with disable_graphs():
        want = describe_keypoints(img, k, has_orientation=given_theta)
    for _ in range(3):
        assert _equal(describe_keypoints(img, k, has_orientation=given_theta),
                      want)
    st = tdesc._DESCRIBE_GRAPHS.stats()
    assert len(st) == 1 and st[0].replays == 3
    cfg = SiftConfig()
    n_oct = make_plan(480, 640, cfg).num_octaves
    assert st[0].launches == {
        "blur": 1, "octave_chain": n_oct, "detect_octave": n_oct,
        "descriptor": 1, **({} if given_theta else {"orientation": 1})}
    # the replay's first n slots of the bucket equal an unpadded eager run
    arr, plan, cfg = tdesc.prepare_input(img, cfg, card)
    kt = keys[:, 3] if given_theta else np.zeros(len(keys), np.float32)
    with disable_graphs():
        theta, desc = tdesc._describe_padded(
            arr, plan, cfg, keys[:, 0], keys[:, 1], keys[:, 2], kt,
            given_theta, len(keys))
    np.testing.assert_array_equal(want["desc"], desc)
    if not given_theta:
        np.testing.assert_array_equal(
            want["theta"], np.mod(tdesc.TWO_PI - theta, tdesc.TWO_PI))


def test_reentry_new_inputs_without_aliasing(card, reentry):
    (img0, k0), (img1, k1) = reentry
    n = min(len(k0), len(k1))
    k0, k1 = k0[:n], k1[:n]           # one bucket: one graph for both
    a = describe_keypoints(img0, k0)
    kept = {k: v.copy() for k, v in a.items()}
    b = describe_keypoints(img1, k1)
    with disable_graphs():
        want_b = describe_keypoints(img1, k1)
    assert _equal(b, want_b) and _equal(a, kept)
    assert not np.array_equal(a["desc"], b["desc"])


def test_rectangles_replay_equals_eager(card, reentry):
    img = reentry[0][0]
    rects = np.array([[100, 100, 40, 60], [300, 200, 80, 80],
                      [10, 20, 20, 30]], np.float32)
    with disable_graphs():
        want = describe_rectangles(img, rects)
    for _ in range(3):
        assert _equal(describe_rectangles(img, rects), want)


def test_threads_describing_through_one_graph(card, reentry):
    """Two threads (the server's clients) describe their own frames'
    keypoints, cut to one bucket, through one re-entry graph."""
    (img0, k0), (img1, k1) = reentry
    n = min(len(k0), len(k1))
    inputs = [(img0, k0[:n]), (img1, k1[:n])]
    with disable_graphs():
        want = [describe_keypoints(*x) for x in inputs]
    describe_keypoints(*inputs[0])            # captured before the threads
    captures = tdesc._DESCRIBE_GRAPHS.captures
    wrong, errors = [0, 0], []
    start = threading.Barrier(2)

    def client(i):
        try:
            start.wait()
            for _ in range(40):
                if not _equal(describe_keypoints(*inputs[i]), want[i]):
                    wrong[i] += 1
        except Exception as e:                # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors and wrong == [0, 0]
    assert tdesc._DESCRIBE_GRAPHS.captures == captures


def _match_inputs(card, seed, n1=2048, n2=2048):
    g = torch.Generator().manual_seed(seed)
    d1 = torch.randint(0, 64, (n1, 128), generator=g, dtype=torch.uint8)
    d2 = torch.randint(0, 64, (n2, 128), generator=g, dtype=torch.uint8)
    d2[: n2 // 2] = d1[: n2 // 2]             # half of them match
    loc1 = torch.rand(n1, 2, generator=g) * 600
    loc2 = torch.rand(n2, 2, generator=g) * 600
    loc2[: n2 // 2] = loc1[: n2 // 2] + 1.0
    return [x.to(card) for x in (d1, d2, loc1, loc2)]


def _second_call_replays(cache, call):
    """call() through a capture_at=2 cache: eager, captured, replayed; each
    returned."""
    eager0, cap0 = cache.eager_calls, cache.captures
    first = call()
    assert (cache.eager_calls, cache.captures) == (eager0 + 1, cap0)
    second = call()
    assert cache.captures == cap0 + 1
    return [first, second, call()]


def _first_call_replays(cache, call):
    """call() through a cache that captures a key at its first call:
    captured, replayed, replayed; each returned."""
    eager0, cap0 = cache.eager_calls, cache.captures
    first = call()
    assert (cache.eager_calls, cache.captures) == (eager0, cap0 + 1)
    return [first, call(), call()]


@pytest.mark.parametrize("mutual", [True, False])
def test_match_replay_equals_eager(card, mutual):
    """At sizes off the bucket (2000 x 1900 in a 2048 x 2048 graph), so the
    padded rows and columns are exercised."""
    d1, d2, loc1, loc2 = _match_inputs(card, 0, 2000, 1900)
    v1 = torch.ones(len(d1), dtype=torch.bool, device=card)
    v2 = torch.ones(len(d2), dtype=torch.bool, device=card)
    H, F = torch.eye(3, device=card), torch.eye(3, device=card)
    tm._match_core.clear_cache()
    with disable_graphs():
        gate = tm._guided_gate(loc1, loc2, H, 4.0, F, 1e20)
        want = tm._match_core(d1, d2, v1, v2, 0.7, 0.8, mutual)
        want_g = tm._match_core(d1, d2, v1, v2, 0.7, 0.8, mutual, gate)
    assert 0 < int((want >= 0).sum()) and 0 < int(gate.sum()) < gate.numel()
    for got in _first_call_replays(tm._MATCH_GRAPHS, lambda: tm._guided_gate(
            loc1, loc2, H, 4.0, F, 1e20)):
        assert _same(got, gate)
    for got in _first_call_replays(tm._MATCH_GRAPHS, lambda: tm._match_core(
            d1, d2, v1, v2, 0.7, 0.8, mutual)):
        assert _same(got, want)
    for got in _first_call_replays(tm._MATCH_GRAPHS, lambda: tm._match_core(
            d1, d2, v1, v2, 0.7, 0.8, mutual, gate)):
        assert _same(got, want_g)
    # thresholds are inputs, not frozen into the graph
    with disable_graphs():
        want2 = tm._match_core(d1, d2, v1, v2, 0.3, 0.6, mutual)
    got2 = tm._match_core(d1, d2, v1, v2, 0.3, 0.6, mutual)
    assert _same(got2, want2) and not _same(want2, want)
    st = tm._MATCH_GRAPHS.stats()
    assert len(st) == 3 and all(s.eager_calls == 0 and s.capture_at == 1
                                and s.key[1][0][0][0] == 2048
                                for s in st)


def test_sizes_in_one_bucket_share_its_graph(card):
    """Sizes padded to one bucket replay one graph, called in turns with
    other buckets' graphs, and each gives its own eager result."""
    tm._match_core.clear_cache()
    cap0 = tm._MATCH_GRAPHS.captures
    sizes = [(600, 500), (610, 505), (590, 620), (2048, 2048)]
    inputs = []
    for i, (n1, n2) in enumerate(sizes):
        d1, d2, _, _ = _match_inputs(card, 10 + i, n1, n2)
        v1 = torch.ones(n1, dtype=torch.bool, device=card)
        v2 = torch.ones(n2, dtype=torch.bool, device=card)
        inputs.append((d1, d2, v1, v2))
    with disable_graphs():
        want = [tm._match_core(*x, 0.7, 0.8) for x in inputs]
    for _ in range(3):
        for x, w in zip(inputs, want):
            assert _same(tm._match_core(*x, 0.7, 0.8), w)
    # (1024, 512) twice, (1024, 1024), (2048, 2048)
    st = tm._MATCH_GRAPHS.stats()
    assert len(st) == 3 and tm._MATCH_GRAPHS.captures - cap0 == 3
    assert sorted(s.replays for s in st) == [3, 3, 6]


def test_match_new_inputs_without_aliasing(card):
    a_in, b_in = _match_inputs(card, 1), _match_inputs(card, 2)
    ones = torch.ones(2048, dtype=torch.bool, device=card)
    call = lambda d: tm._match_core(d[0], d[1], ones, ones, 0.7, 0.8)  # noqa
    call(a_in)
    a = call(a_in)                            # replayed
    kept = a.clone()
    b = call(b_in)
    with disable_graphs():
        want_b = call(b_in)
    assert _same(b, want_b) and _same(a, kept)
    assert a.data_ptr() != b.data_ptr()


def _ransac_scene(card, seed, n=300):
    rng = np.random.RandomState(seed)
    X = rng.uniform(-1, 1, (n, 3))
    X[:, 2] += 5.0
    Kn = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    a = 0.1
    R2 = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                   [-np.sin(a), 0, np.cos(a)]])

    def project(R, tt):
        xc = X @ R.T + tt
        return xc[:, :2] / xc[:, 2:] * 500.0 + [320.0, 240.0]

    p1 = project(np.eye(3), np.zeros(3)) + rng.normal(0, 0.3, (n, 2))
    p2 = project(R2, np.array([-0.5, 0.0, 0.0])) + rng.normal(0, 0.3, (n, 2))
    p2[: n // 10] += rng.uniform(20, 60, (n // 10, 2))
    g = torch.Generator().manual_seed(seed)
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=card)  # noqa
    return dict(X=f32(X), p1=f32(p1), p2=f32(p2), K=f32(Kn),
                valid=torch.ones(n, dtype=torch.bool, device=card),
                fidx=torch.randint(0, n, (512, 8), generator=g).to(card),
                pidx=torch.randint(0, n, (256, 6), generator=g).to(card))


def test_ransac_fundamental_replay_equals_eager(card):
    s = _ransac_scene(card, 0)
    args = (s["fidx"], s["p1"], s["p2"], s["valid"])
    ttv.ransac_fundamental_from_samples.clear_cache()
    with disable_graphs():
        want = ttv.ransac_fundamental_from_samples(*args)
    assert int(want.num_inliers) >= 250
    for got in _second_call_replays(
            ttv._RANSAC_F_GRAPHS,
            lambda: ttv.ransac_fundamental_from_samples(*args)):
        assert _equal(tuple(got), tuple(want))
    st = ttv._RANSAC_F_GRAPHS.stats()[0]
    # one graph: both eight-point solves' kernels inside it
    assert st.launches == {"null_vector": 2, "svd3": 2}
    other = _ransac_scene(card, 1)
    args2 = (other["fidx"], other["p1"], other["p2"], other["valid"])
    kept = [x.clone() for x in want]
    got2 = ttv.ransac_fundamental_from_samples(*args2)
    with disable_graphs():
        assert _equal(tuple(got2),
                      tuple(ttv.ransac_fundamental_from_samples(*args2)))
    assert _equal(kept, list(want))


def test_ransac_pnp_replay_equals_eager(card):
    s = _ransac_scene(card, 0)
    args = (s["pidx"], s["X"], s["p2"], s["valid"], s["K"])
    ttv.ransac_pnp_from_samples.clear_cache()
    with disable_graphs():
        want = ttv.ransac_pnp_from_samples(*args)
    assert int(want.num_inliers) >= 100
    for _ in range(3):
        assert _equal(tuple(ttv.ransac_pnp_from_samples(*args)), tuple(want))
    st = ttv._PNP_GRAPHS.stats()
    assert len(st) == 1 and st[0].launches == {"null_vector": 1, "svd3": 1}
    other = _ransac_scene(card, 1)
    args2 = (other["pidx"], other["X"], other["p2"], other["valid"],
             other["K"])
    got2 = ttv.ransac_pnp_from_samples(*args2)
    with disable_graphs():
        assert _equal(tuple(got2), tuple(ttv.ransac_pnp_from_samples(*args2)))
    assert len(ttv._PNP_GRAPHS) == 1


def test_pose_graph_replay_equals_eager(card):
    """A 12-camera loop with odometry and two loop closures, every pose but
    the gauge drifted (as tests/test_torch_sfm_posegraph.py's), so that the
    steps move it."""
    from hessgpu_tpu_torch.sfm.ba import so3_exp
    C = 12
    rng = np.random.RandomState(42)
    rot = lambda w: so3_exp(torch.tensor(w, dtype=torch.float32)[None]
                            )[0].double().numpy()                  # noqa
    Rs = np.stack([rot([0.0, 0.3 * c, 0.0]) for c in range(C)])
    ts = np.stack([[np.cos(0.3 * c), 0.1 * c % 0.5, np.sin(0.3 * c)]
                   for c in range(C)])
    edges = [(c, c + 1) for c in range(C - 1)] + [(0, C - 1), (0, C // 2)]
    ei, ej = (np.array(e) for e in zip(*edges))
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=card)  # noqa
    graph = tpg.PoseGraph(
        edge_i=torch.as_tensor(ei, device=card),
        edge_j=torch.as_tensor(ej, device=card),
        R_ij=f32(np.stack([Rs[j] @ Rs[i].T for i, j in edges])),
        t_ij=f32(np.stack([ts[j] - Rs[j] @ Rs[i].T @ ts[i]
                           for i, j in edges])),
        weight=f32(np.ones(len(edges))))
    Rp, tp = Rs.copy(), ts.copy()
    for c in range(1, C):
        Rp[c] = rot(0.05 * rng.randn(3)) @ Rp[c]
        tp[c] = tp[c] + 0.1 * rng.randn(3)
    R0, t0 = f32(Rp), f32(tp)
    tpg.optimize_pose_graph.clear_cache()
    with disable_graphs():
        want = tpg.optimize_pose_graph(R0, t0, graph)
    assert float((want[1] - t0).abs().max()) > 1e-2
    for _ in range(2):
        assert _equal(tpg.optimize_pose_graph(R0, t0, graph), want)
    st = tpg._STEP_GRAPHS.stats()
    assert len(st) == 1 and st[0].replays == 40
