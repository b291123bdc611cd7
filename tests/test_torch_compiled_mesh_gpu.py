"""The mesh boundaries of the compiled-program layer on the card: each of the
JAX package's five jit(shard_map) programs captured as one CUDA graph on an
in-process mesh (detect_batch over a mesh, the row-sharded detect +
describe with its table assembly, the keypoints alone, the sharded LM step,
match_sharded) against the eager route it captures. A CUDA graph has no CPU
counterpart, so these tests need one NVIDIA GPU and nvcc; everywhere else
they skip. They import nothing of JAX:

    python -m pytest tests/test_torch_compiled_mesh_gpu.py -q --noconftest

A replay launches the kernels and PyTorch operations of the eager call, in
the same order, on the same inputs, so every result is compared bit for
bit.
"""

import threading

import numpy as np
import pytest
import torch

from hessgpu_tpu_torch import SiftConfig, detect_batch
from hessgpu_tpu_torch.convert import ba_from_numpy
from hessgpu_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
from hessgpu_tpu_torch.parallel import batch as tbatch
from hessgpu_tpu_torch.parallel import distributed as td
from hessgpu_tpu_torch.parallel import spatial as tsp
from hessgpu_tpu_torch.parallel.distributed import local_mesh
from hessgpu_tpu_torch.sfm import distributed_ba as tdba
from hessgpu_tpu_torch.sfm.synthetic import texture_frame
from hessgpu_tpu_torch.utils.graphs import disable_graphs

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: a CUDA graph has no CPU "
                    "counterpart")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def frames(card):
    """texture_frame(0..7) at 480x640 on the card."""
    return torch.from_numpy(np.stack(
        [texture_frame(s, 480, 640) for s in range(8)])).to(card)


@pytest.fixture(scope="module")
def images(card):
    """Two 1024x1536 textures on the card (4 bands of 256 rows)."""
    return [torch.from_numpy(texture_frame(s, 1024, 1536)).to(card)
            for s in (3, 4)]


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype and \
            torch.equal(a, b)
    return a == b


def _clone(out):
    if isinstance(out, dict):
        return {k: _clone(v) for k, v in out.items()}
    if isinstance(out, tuple):
        return type(out)(*map(_clone, out)) if hasattr(out, "_fields") \
            else tuple(map(_clone, out))
    if isinstance(out, list):
        return list(map(_clone, out))
    return out.clone() if isinstance(out, torch.Tensor) else out


def _ba(card, seed):
    rng = np.random.RandomState(seed)
    cams, pts = 8, 256
    X = rng.uniform(-1, 1, (pts, 3)).astype(np.float32) + [0, 0, 5]
    t = np.zeros((cams, 3), np.float32)
    t[:, 0] = np.linspace(-1, 1, cams)
    cam_idx = np.repeat(np.arange(cams), pts)
    pt_idx = np.tile(np.arange(pts), cams)
    Xc = X[pt_idx] + t[cam_idx]
    uv = Xc[:, :2] / Xc[:, 2:] * 500.0 + [320.0, 240.0]
    st, pr = ba_from_numpy(
        R=np.tile(np.eye(3, dtype=np.float32), (cams, 1, 1)),
        t=t + rng.normal(0, 0.02, t.shape).astype(np.float32),
        X=(X + rng.normal(0, 0.02, X.shape)).astype(np.float32),
        intr=np.tile(np.float32([500, 320, 240]), (cams, 1)),
        cam_idx=cam_idx, pt_idx=pt_idx,
        uv=(uv + rng.normal(0, 0.3, uv.shape)).astype(np.float32),
        weight=np.ones(len(uv), np.float32), device=card)
    return st, pr


def _match_inputs(card, seed, n=4096):
    """Seeded u8 descriptors, d2 = d1 rolled by 5 + 4 * seed rows (the
    planted matches), and locations that H (a 2-pixel shift) maps onto
    each other's."""
    rng = np.random.RandomState(seed)
    d = np.abs(rng.randn(n, 128)).astype(np.float32)
    d1 = np.clip(d / np.linalg.norm(d, axis=1, keepdims=True) * 512, 0,
                 255).astype(np.uint8)
    d2 = np.roll(d1, 5 + 4 * seed, axis=0)
    loc1 = rng.uniform(0, 2000, (n, 2)).astype(np.float32)
    loc2 = np.roll(loc1, 5 + 4 * seed, axis=0) + 2.0
    return [torch.from_numpy(a).to(card) for a in (d1, d2, loc1, loc2)]


def _boundaries(card, frames, images):
    """name -> (cache, call(inputs), inputs, other inputs)."""
    cfg = SiftConfig()
    H = np.eye(3, dtype=np.float32)
    H[:2, 2] = 2.0
    lam = torch.tensor(1e-3, device=card)
    steps = {n: tdba.make_sharded_lm_step(local_mesh(n)) for n in (2, 8)}

    def lm(n):
        return lambda a: steps[n](a[0], lam, tdba.pad_problem(a[1], n))

    return {
        "batch_n2": (tbatch._MESH_BATCH_GRAPHS,
                     lambda x: detect_batch(x, cfg, mesh=local_mesh(2)),
                     frames[:4], frames[4:]),
        "spatial_n2": (tsp._SPATIAL_GRAPHS,
                       lambda x: tsp.sharded_detect_and_describe(
                           x, cfg, local_mesh(2), with_aux=True),
                       images[0], images[1]),
        "spatial_n4": (tsp._SPATIAL_GRAPHS,
                       lambda x: tsp.sharded_detect_and_describe(
                           x, cfg, local_mesh(4), with_aux=True),
                       images[0], images[1]),
        "keypoints_n4": (tsp._SPATIAL_GRAPHS,
                         lambda x: tsp.sharded_detect_keypoints(
                             x, cfg, local_mesh(4)),
                         images[0], images[1]),
        "lm_step_n2": (tdba._SHARDED_LM_GRAPHS, lm(2), _ba(card, 0),
                       _ba(card, 1)),
        "lm_step_n8": (tdba._SHARDED_LM_GRAPHS, lm(8), _ba(card, 0),
                       _ba(card, 1)),
        "match_n2": (td._MATCH_SHARDED_GRAPHS,
                     lambda a: td.match_sharded(a[0], a[1], local_mesh(2)),
                     _match_inputs(card, 0), _match_inputs(card, 1)),
        "match_guided_none": (
            td._MATCH_SHARDED_GRAPHS,
            lambda a: td.match_sharded(a[0], a[1], loc1=a[2], loc2=a[3],
                                       H=H, hdistmax=16.0),
            _match_inputs(card, 0), _match_inputs(card, 1)),
    }


NAMES = ["batch_n2", "spatial_n2", "spatial_n4", "keypoints_n4",
         "lm_step_n2", "lm_step_n8", "match_n2", "match_guided_none"]


@pytest.fixture(scope="module")
def boundaries(card, frames, images):
    return _boundaries(card, frames, images)


@pytest.mark.parametrize("name", NAMES)
def test_replay_equals_eager(card, boundaries, name):
    """The key's capture (the first call, or the second where the shapes
    follow the data) and two replays, each bit-equal to the eager route;
    the cache holds one graph more."""
    cache, call, x, _ = boundaries[name]
    cache.clear()
    with disable_graphs():
        want = call(x)
    captures, replays = cache.captures, cache.replays
    for _ in range(cache.capture_at + 2):
        assert _equal(call(x), want)
    assert cache.captures == captures + 1 and len(cache) == 1
    assert cache.replays == replays + 3


@pytest.mark.parametrize("name", NAMES)
def test_new_inputs_without_aliasing(card, boundaries, name):
    cache, call, x, y = boundaries[name]
    for _ in range(cache.capture_at):        # the key captured
        call(x)
    a = call(x)
    kept = _clone(a)
    b = call(y)
    with disable_graphs():
        want_b = call(y)
    assert _equal(b, want_b)
    assert _equal(a, kept), "a later replay changed an earlier result"
    assert not _equal(a, b)


def test_spatial_graph_holds_the_eager_launches(card, images):
    """The launches the spatial graph records at its capture equal the
    eager call's (the pins of chip_smoke.py EXPECTED_SPATIAL at this
    frame's octaves: the initial blur and 4 level blurs an octave, a
    decimation between octaves, a detect an octave, one orientation and
    one descriptor launch over every level and band)."""
    cfg = SiftConfig()
    tsp._sharded_program.clear_cache()
    for n in (1, 2, 4):
        with disable_graphs():
            reset_launch_counts()
            tsp.sharded_detect_and_describe(images[0], cfg, local_mesh(n))
            torch.cuda.synchronize()
            eager = {k: v for k, v in launch_counts().items() if v}
        tsp.sharded_detect_and_describe(images[0], cfg, local_mesh(n))
        st = tsp._SPATIAL_GRAPHS.stats()[-1]
        noct = len(tsp._geometry(1024, 1536, cfg, n, True).shapes)
        pins = {"blur": 1 + 4 * noct, "downsample2": noct - 1,
                "detect_octave": noct, "orientation": 1, "descriptor": 1}
        assert st.launches == eager == pins, (n, st.launches, eager)
    # the 1-, 2- and 4-band graphs fit the cache's bound together
    assert len(tsp._SPATIAL_GRAPHS) == 3


def test_batch_graph_holds_every_shards_launches(card, frames):
    cfg = SiftConfig()
    tbatch._sharded_batch_program.clear_cache()
    detect_batch(frames[:4], cfg, mesh=local_mesh(2))
    st = tbatch._MESH_BATCH_GRAPHS.stats()[-1]
    assert st.launches == {"blur": 2, "octave_chain": 10,
                           "detect_octave": 10, "orientation": 2,
                           "descriptor": 2, "row_counts": 10,
                           "level_scan": 2, "table_scatter": 2}


def test_threads_through_one_mesh_graph(card, frames):
    """Two threads (as the feature server's clients) call detect_batch over
    one in-process mesh at once with their own frames: one graph, each
    thread's own result, call after call."""
    cfg = SiftConfig()
    mesh = local_mesh(2)
    inputs = [frames[:4], frames[4:]]
    with disable_graphs():
        wants = [detect_batch(x, cfg, mesh=mesh) for x in inputs]
    detect_batch(inputs[0], cfg, mesh=mesh)
    captures = tbatch._MESH_BATCH_GRAPHS.captures
    wrong, errors = [0, 0], []
    start = threading.Barrier(2)

    def caller(i):
        try:
            start.wait()
            for _ in range(20):
                if not _equal(detect_batch(inputs[i], cfg, mesh=mesh),
                              wants[i]):
                    wrong[i] += 1
        except Exception as e:                      # noqa: BLE001
            errors.append(repr(e))

    ts = [threading.Thread(target=caller, args=(i,)) for i in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert wrong == [0, 0] and not errors, (wrong, errors)
    assert tbatch._MESH_BATCH_GRAPHS.captures == captures


def test_a_nested_graph_cache_call_raises(card):
    """A graph's function that calls a GraphCache (not the eager body)
    raises while the outer graph is made: JAX inlines a nested jit, the
    port's graph functions call the eager bodies."""
    from hessgpu_tpu_torch.utils.graphs import GraphCache

    inner, outer = GraphCache(1 << 24), GraphCache(1 << 24)
    x = torch.ones(8, device=card)
    with pytest.raises(RuntimeError, match="inside another graph's capture"):
        outer(("outer",), lambda t: inner(("inner",), lambda u: u + 1, t),
              x)


def test_clear_cache_frees_the_mesh_graphs(card, boundaries):
    for name in NAMES:
        cache, call, x, _ = boundaries[name]
        for _ in range(cache.capture_at):
            call(x)
    caches = (tbatch._MESH_BATCH_GRAPHS, tsp._SPATIAL_GRAPHS,
              tdba._SHARDED_LM_GRAPHS, td._MATCH_SHARDED_GRAPHS)
    assert all(len(c) for c in caches)
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved()
    for clear in (tbatch._sharded_batch_program.clear_cache,
                  tsp._sharded_program.clear_cache,
                  tdba.make_sharded_lm_step.clear_cache,
                  td.match_sharded.clear_cache):
        clear()
    assert not any(len(c) for c in caches)
    assert torch.cuda.memory_reserved() < before
