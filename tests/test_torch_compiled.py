"""The port's compiled-program layer on the CPU: _CfgKey, the per-plan device
constants, run_pipeline_jit / _batched_pipeline against the eager pipeline
and against the JAX package's own jitted entries, the graph cache's
bookkeeping, and a host-orchestration check that stands in for "capture
would not synchronise" (a CUDA graph capture raises on any host read; here
the calls that would make one are recorded by file).

On the CPU run_pipeline_jit is run_pipeline_batched, so the two are equal
bit for bit. Against the JAX package the port's stated tolerances hold
(tests/test_torch_pipeline_default.py): counts, valid, level and ftype
identical, x, y and sigma within 1e-3 px at octave 0 (scaled by the
octave), thetas identical up to one 2pi/255 quantum on at most 1% of the
features, descriptors within 5e-4. One keypoint of the seed-0 frame (level
5) lies 3.0e-3 px in y from the JAX package's, 1.5 times its octave's
tolerance, in the eager pipeline as in run_pipeline_jit: an ill-conditioned
subpixel solve, which the parity tests allow within 20 times the tolerance
(`loose`). Under the default config it carries two orientations, so two
features.
"""

import dataclasses
import os
import sys
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import hessgpu_tpu_torch
from hessgpu_tpu import pyramid as jpyr
from hessgpu_tpu.config import SiftConfig as JConfig
from hessgpu_tpu.parallel import batch as jbatch
from hessgpu_tpu_torch import HessianSift, SiftConfig, detect_batch, make_plan
from hessgpu_tpu_torch import pyramid as tpyr
from hessgpu_tpu_torch.convert import ba_from_numpy, config_from_dict
from hessgpu_tpu_torch.parallel.batch import _batched_pipeline
from hessgpu_tpu_torch.sfm import ba as tba
from hessgpu_tpu_torch.sfm.synthetic import texture_frame
from hessgpu_tpu_torch.utils.graphs import (GraphCache, disable_graphs,
                                            graphs_enabled)
from hessgpu_tpu_torch.utils.timing import profile_trace

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_pipeline import _np_table, _torch_table
from test_torch_pipeline_default import _assert_features_agree

PKG = os.path.dirname(os.path.abspath(hessgpu_tpu_torch.__file__))
SD_OFIX = dict(compute_descriptors=False, fixed_orientation=True)
CONFIGS = {"default": {}, "sd-ofix": SD_OFIX, "dog": dict(detector="dog")}


def _configs(**kw):
    jc = JConfig(**kw)
    return jc, config_from_dict(dataclasses.asdict(jc))


@pytest.fixture(scope="module")
def frames():
    """Seeded textures, 128x160."""
    return np.stack([texture_frame(s, 128, 160) for s in range(3)])


# ---------------------------------------------------------------------------
# _CfgKey
# ---------------------------------------------------------------------------

def _other_value(field, value):
    if isinstance(value, bool):
        return not value
    if isinstance(value, int):
        return value + 1
    if isinstance(value, float):
        return value + 0.5
    if isinstance(value, str):
        return {"detector": "dog", "conv_mode": "direct"}.get(
            field.name, value + "x")
    if value is None:
        return (640, 480) if field.name == "prealloc_size" else 0.01
    raise AssertionError(f"no other value for {field.name}={value!r}")


def test_equal_configs_give_one_key():
    a, b = tpyr._CfgKey(SiftConfig()), tpyr._CfgKey(SiftConfig())
    assert a == b and hash(a) == hash(b)
    c = tpyr._CfgKey(dataclasses.replace(SiftConfig(), threshold=None))
    assert len({a, b, c}) == 1
    assert a != SiftConfig()


@pytest.mark.parametrize("field", dataclasses.fields(SiftConfig),
                         ids=lambda f: f.name)
def test_a_changed_field_gives_another_key(field):
    cfg = SiftConfig()
    other = dataclasses.replace(
        cfg, **{field.name: _other_value(field, getattr(cfg, field.name))})
    assert tpyr._CfgKey(other) != tpyr._CfgKey(cfg)
    assert len({tpyr._CfgKey(other), tpyr._CfgKey(cfg)}) == 2


# ---------------------------------------------------------------------------
# the per-plan device constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plan_constants_equal_the_per_call_values(name):
    """The values _globalize and detect_from_octaves built on every call
    before they became constants: level ids from the blocked lists' shapes,
    the key levels' sigmas from the scale parameters."""
    cfg = SiftConfig(**CONFIGS[name])
    plan = make_plan(120, 160, cfg)
    p = cfg.scale_params()
    nk = len(p.key_levels)
    lid, base = [], 0
    for o in range(plan.num_octaves):
        lid.append(np.repeat(base + np.arange(nk), plan.level_caps[o * nk]))
        base += nk
    want_lid = torch.as_tensor(np.concatenate(lid), dtype=torch.int32)
    want_sig = torch.tensor([p.key_level_sigma(k) for k in p.key_levels],
                            dtype=torch.float32)
    tpyr.run_pipeline_jit.clear_cache()
    c = tpyr._plan_constants(plan, cfg, "cpu")
    assert torch.equal(c.level_ids, want_lid)
    assert torch.equal(c.key_sigmas, want_sig)
    # built once per key: the same tensors come back, for an equal config too
    again = tpyr._plan_constants(plan, dataclasses.replace(cfg), "cpu")
    assert again.level_ids is c.level_ids and again.key_sigmas is c.key_sigmas
    assert tpyr._make_plan_constants.cache_info().currsize == 1
    tpyr._plan_constants(make_plan(64, 80, cfg), cfg, "cpu")
    assert tpyr._make_plan_constants.cache_info().currsize == 2
    tpyr.run_pipeline_jit.clear_cache()
    assert tpyr._make_plan_constants.cache_info().currsize == 0


def test_plan_constants_drop_the_least_recently_used():
    tpyr.run_pipeline_jit.clear_cache()
    bound = tpyr._make_plan_constants.cache_info().maxsize
    cfg = SiftConfig(**SD_OFIX)
    plans = [make_plan(64, 80 + 16 * i, cfg) for i in range(bound + 1)]
    first = tpyr._plan_constants(plans[0], cfg, "cpu")
    second = tpyr._plan_constants(plans[1], cfg, "cpu")
    assert tpyr._plan_constants(plans[0], cfg, "cpu") is first   # now newest
    for plan in plans[2:]:
        tpyr._plan_constants(plan, cfg, "cpu")
    assert tpyr._make_plan_constants.cache_info().currsize == bound
    assert tpyr._plan_constants(plans[0], cfg, "cpu") is first   # kept
    assert tpyr._plan_constants(plans[1], cfg, "cpu") is not second  # dropped
    tpyr.run_pipeline_jit.clear_cache()


def test_tight_clears_the_cache_when_the_size_changes():
    sift = HessianSift(SiftConfig(**SD_OFIX, tight_pyramid=True),
                       device="cpu")
    tpyr.run_pipeline_jit.clear_cache()
    sift.run(texture_frame(0, 96, 128))
    sift.run(texture_frame(1, 96, 128))
    info = tpyr._make_plan_constants.cache_info()
    assert (info.currsize, info.misses) == (1, 1)
    sift.run(texture_frame(2, 64, 80))
    # cleared, then the new size's built: the 96-row constants are gone
    info = tpyr._make_plan_constants.cache_info()
    assert (info.currsize, info.misses, info.hits) == (1, 1, 0)


# ---------------------------------------------------------------------------
# run_pipeline_jit / _batched_pipeline on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_run_pipeline_jit_is_the_eager_pipeline_on_the_cpu(frames, name):
    cfg = SiftConfig(**CONFIGS[name])
    imgs = torch.from_numpy(frames[:2])
    plan = make_plan(*frames.shape[1:], cfg)
    got, got_aux = tpyr.run_pipeline_jit(imgs, plan, cfg)
    want, want_aux = tpyr.run_pipeline_batched(imgs, plan, cfg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for k in want_aux:
        assert torch.equal(got_aux[k], want_aux[k])
    one, one_aux = tpyr.run_pipeline_jit(imgs[0], plan, cfg)
    ref, ref_aux = tpyr.run_pipeline(imgs[0], plan, cfg)
    for a, b in zip(one, ref):
        assert torch.equal(a, b)
    assert torch.equal(one_aux["level_counts"], ref_aux["level_counts"])
    batch = _batched_pipeline(imgs, plan, cfg)
    for a, b in zip(batch, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["default", "sd-ofix"])
def test_run_pipeline_jit_matches_the_jax_jitted_entry(frames, name):
    jc, tc = _configs(**CONFIGS[name])
    img = frames[0]
    want, jaux = jpyr.run_pipeline_jit(
        jnp.asarray(img), jpyr.make_plan(*img.shape, jc), jpyr._CfgKey(jc))
    got, taux = tpyr.run_pipeline_jit(torch.from_numpy(img),
                                      make_plan(*img.shape, tc), tc)
    _assert_features_agree(_torch_table(got), _np_table(want), min_count=10,
                           loose=2)
    np.testing.assert_array_equal(taux["level_counts"].numpy(),
                                  np.asarray(jaux["level_counts"]))
    assert int(taux["pre_count"]) == int(jaux["pre_count"])


@pytest.mark.parametrize("name", ["default", "sd-ofix"])
def test_batched_pipeline_matches_the_jax_jitted_entry(frames, name):
    jc, tc = _configs(**CONFIGS[name])
    imgs = frames[1:3]
    want = jbatch._batched_pipeline(
        jnp.asarray(imgs), jpyr.make_plan(*imgs.shape[1:], jc),
        jpyr._CfgKey(jc))
    got = _batched_pipeline(torch.from_numpy(imgs),
                            make_plan(*imgs.shape[1:], tc), tc)
    g, w = _torch_table(got), _np_table(want)
    np.testing.assert_array_equal(g["valid"].sum(-1), w["valid"].sum(-1))
    for b in range(len(imgs)):
        _assert_features_agree({k: v[b] for k, v in g.items()},
                               {k: v[b] for k, v in w.items()}, min_count=10)


# ---------------------------------------------------------------------------
# host orchestration: what a capture would refuse
# ---------------------------------------------------------------------------

HOST_CALLS = {torch: ("tensor", "as_tensor", "from_numpy", "nonzero"),
              torch.Tensor: ("item", "tolist", "__bool__", "__int__",
                             "__float__")}


@pytest.fixture
def host_calls(monkeypatch):
    """(name, file relative to the package) of every call of the functions
    that copy from or read back to the host, made while the test runs."""
    calls = []

    def spy(owner, name):
        real = getattr(owner, name)

        def recorded(*a, **kw):
            path = sys._getframe(1).f_code.co_filename
            calls.append((name, os.path.relpath(path, PKG)))
            return real(*a, **kw)
        monkeypatch.setattr(owner, name, recorded)

    for owner, names in HOST_CALLS.items():
        for name in names:
            spy(owner, name)
    return calls


def _watched(calls, files):
    return [c for c in calls
            if c[1] in files or any(c[1].startswith(f) for f in files
                                    if f.endswith("/"))]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_main_path_reads_nothing_from_the_host(frames, name, request):
    """With the constants warm, the main path as the card's graph captures
    it (pyramid, compaction, the batch entry, the kernel wrappers) makes no
    host-to-device copy and no read-back. The plain versions behind the
    wrappers (ops/orientation.py, ops/gather.py) do, and stay off the
    card's path."""
    cfg = SiftConfig(**CONFIGS[name])
    imgs = torch.from_numpy(frames[:2])
    detect_batch(imgs, cfg, device="cpu")           # constants made here
    calls = request.getfixturevalue("host_calls")
    detect_batch(imgs, cfg, device="cpu")
    watched = ("pyramid.py", "ops/compaction.py", "parallel/batch.py",
               "ops/cuda/")
    assert not _watched(calls, watched), calls
    # the spies see those files: prepare_input copies the image in, outside
    # the graph (as the JAX package's prepare_input stays outside its jit)
    tpyr.prepare_input(frames[0], cfg, "cpu")
    assert ("as_tensor", "pyramid.py") in _watched(calls, watched)


def _ba_problem(cams=6, pts=64, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.uniform(-1, 1, (pts, 3)).astype(np.float32)
    X[:, 2] += 5.0
    t = np.zeros((cams, 3), np.float32)
    t[:, 0] = np.linspace(-1, 1, cams)
    R = np.tile(np.eye(3, dtype=np.float32), (cams, 1, 1))
    intr = np.tile(np.array([500.0, 80.0, 60.0], np.float32), (cams, 1))
    cam_idx = np.repeat(np.arange(cams), pts)
    pt_idx = np.tile(np.arange(pts), cams)
    Xc = X[pt_idx] + t[cam_idx]
    uv = Xc[:, :2] / Xc[:, 2:] * 500.0 + np.array([80.0, 60.0])
    return dict(R=R, t=t + rng.normal(0, 0.02, t.shape).astype(np.float32),
                X=X + rng.normal(0, 0.02, X.shape).astype(np.float32),
                intr=intr, cam_idx=cam_idx, pt_idx=pt_idx,
                uv=(uv + rng.normal(0, 0.3, uv.shape)).astype(np.float32),
                weight=np.ones(len(uv), np.float32))


def test_the_lm_step_reads_nothing_from_the_host(host_calls):
    state, prob = ba_from_numpy(device="cpu", **_ba_problem())
    lam = torch.full((), 1e-3)
    del host_calls[:]
    out = tba._lm_step(state, prob, lam, 30, True)
    assert not _watched(host_calls, ("sfm/ba.py",)), host_calls
    # the spies see the file: the RMSE report reads its value back
    tba.reprojection_rmse(state, prob)
    assert ("__float__", "sfm/ba.py") in _watched(host_calls, ("sfm/ba.py",))
    with_graph_entry = tba.lm_step(state, prob, lam)
    for a, b in zip(out[0] + out[1:], with_graph_entry[0]
                    + with_graph_entry[1:]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the graph cache
# ---------------------------------------------------------------------------

def test_the_graph_cache_refuses_cpu_tensors():
    cache = GraphCache(1 << 30)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cache(("k",), lambda x: x + 1, torch.zeros(3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cache(("k",), lambda x, n: x * n, torch.zeros(3), 2)
    assert len(cache) == 0 and cache.captures == 0


def _fake_graph(pool_bytes):
    return SimpleNamespace(stats=SimpleNamespace(
        capture_s=0.5, pool_reserved_bytes=pool_bytes))


def test_the_graph_cache_drops_the_oldest_key_and_clears():
    cache = GraphCache(max_bytes=250)
    for k in ("a", "b", "c"):
        cache._add(k, _fake_graph(100))
    assert cache.keys() == ["b", "c"] and cache.captures == 3
    assert cache.capture_s == 1.5 and cache.reserved_bytes() == 200
    cache._add("d", _fake_graph(150))       # 350 bytes: b goes, then 250
    assert cache.keys() == ["c", "d"] and cache.reserved_bytes() == 250
    cache.clear()
    assert len(cache) == 0 and cache.keys() == []


def test_the_graph_cache_keeps_the_newest_graph_past_its_bound():
    cache = GraphCache(max_bytes=250)
    cache._add("a", _fake_graph(100))
    cache._add("big", _fake_graph(1000))
    assert cache.keys() == ["big"]
    cache._add("c", _fake_graph(100))
    assert cache.keys() == ["c"]


def test_the_entry_points_clear_their_caches():
    tpyr._plan_constants(make_plan(64, 80, SiftConfig()), SiftConfig(), "cpu")
    tpyr.run_pipeline_jit.clear_cache()
    assert tpyr._make_plan_constants.cache_info().currsize == 0
    assert len(tpyr._PIPELINE_GRAPHS) == 0
    tba.lm_step.clear_cache()
    assert len(tba._LM_GRAPHS) == 0


def test_disable_graphs_nests_and_restores():
    assert graphs_enabled()
    with disable_graphs():
        assert not graphs_enabled()
        with disable_graphs(False):
            assert graphs_enabled()
        assert not graphs_enabled()
    assert graphs_enabled()


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace")) as d:
        torch.ones(8).cumsum(0)
    path = os.path.join(d, "trace.json")
    assert os.path.getsize(path) > 0
    with open(path) as f:
        assert '"traceEvents"' in f.read()
