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
              "descriptor": int(cfg.compute_descriptors)}
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
