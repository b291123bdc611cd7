"""The compiled-program layer's single-device boundaries past the pipeline,
on the CPU: the keypoint re-entry program (the JAX package's jitted
describe.py _pyramid_gradients, _orient_and_describe_level and
_describe_all_pallas), the matcher (_match_core, _guided_gate), the two
RANSAC cores (ransac_fundamental, ransac_pnp) and the pose-graph step
(posegraph.py's jitted `step`); and the graph cache's second-call capture.
On the card each entry replays a captured CUDA graph
(tests/test_torch_compiled_gpu.py); here it runs its eager body.

Each entry is held (a) to its eager body, bit for bit; (b) to the JAX
package's jitted function on the same seeded inputs, within the tolerances
of ROADMAP "Tolerances the parity tests hold" and of the module's own
parity file:
  * re-entry against describe_keypoints(..., _force_pallas=True), the JAX
    package's one-program path with its Pallas kernels in interpret mode
    (tests/test_torch_describe.py's DoG case): given theta, descriptors
    within 1e-5; computing theta, thetas within 1e-4 rad (the Pallas
    kernels' own agreement with jnp) and descriptors within 1e-4, taken at
    thetas that far apart;
  * _match_core's indices and _guided_gate's mask equal (the dots are exact
    integers; tests/test_torch_matcher.py);
  * the RANSAC cores fed the JAX package's own draws (sfm/prng.py, the
    draws of jax.random.choice inside its jit): inlier masks equal, F
    within 1e-4 relative after scale and sign, PnP R and t within 1e-3
    (tests/test_torch_sfm_twoview.py);
  * optimize_pose_graph on a drifted 12-camera loop (every pose but the
    gauge moves, so no step is the NaN no-op of an exact edge): poses within
    1e-4 (tests/test_torch_sfm_posegraph.py);
(c) free of host reads in the body that the card captures, by the spies of
tests/test_torch_compiled.py plus one on indexing by a 0-d tensor (which
reads the index back in C++). The spies see Python-level calls only: a
library's own read-back inside an op is invisible to them - as
torch.linalg.svd's convergence check, which is why on the card the RANSAC
cores call the kernels of csrc/linalg.cu instead, here held on their plain
versions' route (twoview.PLAIN_JACOBI_ON_CPU), and the LAPACK route is
held to call torch.linalg.svd at the shapes the kernels take;
(d) a re-entry list padded to the JAX package's bucket equals it unpadded,
and so do the matcher's descriptor sets and locations padded to theirs.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hessgpu_tpu_torch as ht
from hessgpu_tpu import matcher as jm
from hessgpu_tpu.config import SiftConfig as JConfig
from hessgpu_tpu.describe import describe_keypoints as jax_describe_keypoints
from hessgpu_tpu.sfm import posegraph as jpg
from hessgpu_tpu.sfm import twoview as jtv
from hessgpu_tpu_torch import describe as tdesc
from hessgpu_tpu_torch import matcher as tm
from hessgpu_tpu_torch.sfm import posegraph as tpg
from hessgpu_tpu_torch.sfm import twoview as ttv
from hessgpu_tpu_torch.sfm.incremental import sample_indices
from hessgpu_tpu_torch.sfm.synthetic import texture_frame
from hessgpu_tpu_torch.utils import graphs
from hessgpu_tpu_torch.ops import linalg
from hessgpu_tpu_torch.utils.graphs import (GraphCache, GraphStats,
                                            disable_graphs, graphs_enabled)

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_compiled import HOST_CALLS, PKG, _watched
from test_torch_matcher import _locations, _scene as _match_scene
from test_torch_sfm_posegraph import _drifted_loop
from test_torch_sfm_twoview import K, N, N_PNP, _canon, _close, _scene

t = torch.from_numpy


@pytest.fixture
def host_reads(monkeypatch):
    """(name, file relative to the package) of every call that copies from
    or reads back to the host, made while the test runs: the calls of
    tests/test_torch_compiled.py's spy, and indexing by a 0-d tensor."""
    calls = []

    def record(name):
        calls.append((name, os.path.relpath(
            sys._getframe(2).f_code.co_filename, PKG)))

    def spy(owner, name):
        real = getattr(owner, name)

        def recorded(*a, **kw):
            record(name)
            return real(*a, **kw)
        monkeypatch.setattr(owner, name, recorded)

    for owner, names in HOST_CALLS.items():
        for name in names:
            spy(owner, name)
    real_getitem = torch.Tensor.__getitem__

    def getitem(self, index):
        parts = index if isinstance(index, tuple) else (index,)
        if any(isinstance(i, torch.Tensor) and i.ndim == 0 for i in parts):
            record("__getitem__ by a 0-d tensor")
        return real_getitem(self, index)
    monkeypatch.setattr(torch.Tensor, "__getitem__", getitem)
    return calls


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype and \
            torch.equal(a, b)
    return np.array_equal(a, b)


# ---------------------------------------------------------------------------
# keypoint re-entry
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frame():
    """A seeded 128x160 texture and at most 64 of its own features (x, y,
    sigma, theta), shuffled out of level order."""
    img = texture_frame(3, 128, 160)
    table, _ = ht.detect_and_describe(img, ht.SiftConfig(), device="cpu")
    f = ht.to_numpy_trimmed(table)
    k = np.stack([f["x"], f["y"], f["sigma"], f["theta"]], axis=1)
    k = k[np.random.RandomState(0).permutation(len(k))][:64]
    assert 20 <= len(k) <= 64 and len(k) != tdesc._bucket(len(k))
    return img, k


def _padded(img, keys, skip_orientation, cap, cfg=None):
    arr, plan, cfg = tdesc.prepare_input(img, cfg or ht.SiftConfig(), "cpu")
    kt = keys[:, 3] if skip_orientation else np.zeros(len(keys), np.float32)
    return tdesc._describe_padded(arr, plan, cfg, keys[:, 0], keys[:, 1],
                                  keys[:, 2], kt, skip_orientation, cap)


@pytest.mark.parametrize("given_theta", [True, False])
def test_reentry_entry_is_its_eager_body(frame, given_theta):
    img, keys = frame
    k = keys if given_theta else keys[:, :3]
    got = ht.describe_keypoints(img, k, device="cpu")
    with disable_graphs():
        assert _equal(ht.describe_keypoints(img, k, device="cpu"), got)
    theta, desc = _padded(img, keys, given_theta, tdesc._bucket(len(keys)))
    n = len(keys)
    np.testing.assert_array_equal(got["desc"], desc[:n])
    if not given_theta:
        np.testing.assert_array_equal(
            got["theta"], np.mod(tdesc.TWO_PI - theta[:n], tdesc.TWO_PI))


@pytest.mark.parametrize("given_theta", [True, False])
def test_a_padded_list_equals_the_unpadded_one(frame, given_theta):
    img, keys = frame
    n = len(keys)
    tight = _padded(img, keys, given_theta, n)
    for cap in (tdesc._bucket(n), 2 * tdesc._bucket(n)):
        theta, desc = _padded(img, keys, given_theta, cap)
        np.testing.assert_array_equal(theta[:n], tight[0])
        np.testing.assert_array_equal(desc[:n], tight[1])
        assert not desc[n:].any()


def test_the_bucket_is_the_jax_packages():
    # hessgpu_tpu/describe.py:297: max(8, 1 << ceil(log2(max(n, 2))))
    for n, cap in ((1, 8), (2, 8), (8, 8), (9, 16), (64, 64), (65, 128),
                   (210, 256)):
        assert tdesc._bucket(n) == cap


@pytest.mark.parametrize("given_theta", [True, False])
def test_reentry_matches_the_jax_one_program_path(frame, given_theta):
    img, keys = frame
    k = keys if given_theta else keys[:, :3]
    want = jax_describe_keypoints(img, k, JConfig(),
                                  has_orientation=given_theta,
                                  _force_pallas=True)
    got = ht.describe_keypoints(img, k, has_orientation=given_theta,
                                device="cpu")
    if given_theta:
        np.testing.assert_array_equal(got["theta"], keys[:, 3])
        np.testing.assert_allclose(got["desc"], want["desc"], rtol=0,
                                   atol=1e-5)
    else:
        dth = np.abs(np.mod(got["theta"] - want["theta"] + np.pi, 2 * np.pi)
                     - np.pi)
        assert dth.max() <= 1e-4, dth.max()
        np.testing.assert_allclose(got["desc"], want["desc"], rtol=0,
                                   atol=1e-4)


def test_rectangles_entry_is_its_eager_body(frame):
    img, _ = frame
    rects = np.array([[10, 12, 30, 40], [60, 40, 50, 50], [100, 70, 24, 36]],
                     np.float32)
    got = ht.describe_rectangles(img, rects, device="cpu")
    with disable_graphs():
        assert _equal(ht.describe_rectangles(img, rects, device="cpu"), got)
    assert np.isfinite(got["desc"]).all() and got["desc"].any()


@pytest.mark.parametrize("given_theta", [True, False])
def test_the_reentry_body_reads_nothing_from_the_host(frame, given_theta,
                                                      request):
    """_describe_all, the body the card captures (the pyramid, the maps, the
    kernel wrappers), makes no host copy and no read-back; its inputs are
    copied in by _describe_padded, outside the graph, as the JAX package
    makes its arrays outside its jit."""
    img, keys = frame
    arr, plan, cfg = tdesc.prepare_input(img, ht.SiftConfig(), "cpu")
    cap = tdesc._bucket(len(keys))
    pad = lambda a, v=0: t(np.pad(a, (0, cap - len(a)),
                                  constant_values=v)[None])
    cols = (pad(keys[:, 0]), pad(keys[:, 1]), pad(keys[:, 2] / 2.0, 1.0),
            pad(keys[:, 3]), pad(np.ones(len(keys), bool), False),
            pad(np.zeros(len(keys), np.int32)))
    calls = request.getfixturevalue("host_reads")
    tdesc._describe_all(arr, *cols, plan, cfg, given_theta, 25, 41)
    watched = ("describe.py", "pyramid.py", "ops/cuda/")
    assert not _watched(calls, watched), calls
    # the spies see the file: the padded columns are copied in there
    _padded(img, keys, given_theta, cap)
    assert ("as_tensor", "describe.py") in _watched(calls, watched)


# ---------------------------------------------------------------------------
# the matcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize("gated", [False, True])
def test_match_core_entry_is_its_body_and_jax(mutual, gated):
    d1, d2 = _match_scene(7)
    rng = np.random.RandomState(2)
    v1, v2 = rng.rand(len(d1)) > 0.05, rng.rand(len(d2)) > 0.05
    gate = rng.rand(len(d1), len(d2)) > 0.05 if gated else None
    args = (t(d1), t(d2), t(v1), t(v2))
    g = None if gate is None else t(gate)
    got = tm._match_core(*args, torch.tensor(0.7), torch.tensor(0.8),
                         mutual_best=mutual, gate=g)
    assert got.dtype == torch.int64 and got.shape == (len(d1),)
    assert torch.equal(got, tm._match_core_eager(*args, 0.7, 0.8, mutual, g))
    assert torch.equal(got, tm._match_core(*args, 0.7, 0.8, mutual, g))
    want = jm._match_core(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1),
                          jnp.asarray(v2), 0.7, 0.8, mutual_best=mutual,
                          gate=None if gate is None else jnp.asarray(gate))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).sum() >= 50


def test_guided_gate_entry_is_its_body_and_jax():
    loc1, loc2, H, F = _locations(5, 200, 180)
    got = tm._guided_gate(t(loc1), t(loc2), t(H), 32.0, t(F), 16.0)
    assert torch.equal(got, tm._guided_gate_eager(
        t(loc1), t(loc2), t(H), 32.0, t(F), 16.0))
    assert torch.equal(got, tm._guided_gate(
        t(loc1), t(loc2), t(H), torch.tensor(32.0), t(F),
        torch.tensor(16.0)))
    want = jm._guided_gate(jnp.asarray(loc1), jnp.asarray(loc2),
                           jnp.asarray(H), 32.0, jnp.asarray(F), 16.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < got.numel()


def test_the_matchers_bucket():
    assert [tm._bucket(n) for n in (0, 1, 2, 7, 8, 9, 300, 512, 513)] == \
        [0, 1, 8, 8, 8, 16, 512, 512, 1024]


@pytest.mark.parametrize("n1,n2", [(1, 130), (130, 1), (2, 3), (70, 200),
                                   (300, 260)])
@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize("gated", [False, True])
def test_a_padded_match_equals_the_unpadded_one(n1, n2, mutual, gated):
    """The card's graph route pads (N1, N2) to the bucket with rows that
    are not valid and keeps the first N1 results: on the same body, they
    equal the unpadded run bit for bit (ties and masked entries
    included)."""
    d1, d2 = (t(d[:n]) for d, n in zip(_match_scene(7), (n1, n2)))
    rng = np.random.RandomState(3)
    v1, v2 = t(rng.rand(n1) > 0.05), t(rng.rand(n2) > 0.05)
    gate = t(rng.rand(n1, n2) > 0.3) if gated else None
    c1, c2 = tm._bucket(n1), tm._bucket(n2)
    want = tm._match_core_eager(d1, d2, v1, v2, 0.7, 0.8, mutual, gate)
    got = tm._match_core_eager(
        tm._padded(d1, (c1, 128), 0), tm._padded(d2, (c2, 128), 0),
        tm._padded(v1, (c1,), False), tm._padded(v2, (c2,), False), 0.7,
        0.8, mutual, None if gate is None else tm._padded(gate, (c1, c2),
                                                          False))
    assert got.shape == (c1,) and torch.equal(got[:n1], want)
    assert (want >= 0).any() or n1 < 3 or n2 < 3


@pytest.mark.parametrize("n1,n2", [(1, 180), (70, 130), (200, 180)])
def test_a_padded_gate_equals_the_unpadded_one(n1, n2):
    loc1, loc2, H, F = _locations(5, 200, 180)
    loc1, loc2 = loc1[:n1], loc2[:n2]
    want = tm._guided_gate_eager(t(loc1), t(loc2), t(H), 32.0, t(F), 16.0)
    got = tm._guided_gate_eager(
        tm._padded(t(loc1), (tm._bucket(n1), 2), 0.0),
        tm._padded(t(loc2), (tm._bucket(n2), 2), 0.0), t(H), 32.0, t(F),
        16.0)
    assert torch.equal(got[:n1, :n2], want)


def test_the_matcher_bodies_read_nothing_from_the_host(host_reads):
    d1, d2 = _match_scene(7)
    loc1, loc2, H, F = _locations(5, len(d1), len(d2))
    ones1, ones2 = torch.ones(len(d1), dtype=torch.bool), \
        torch.ones(len(d2), dtype=torch.bool)
    thr = torch.tensor(0.7), torch.tensor(0.8)
    scal = torch.tensor(32.0), torch.tensor(16.0)
    del host_reads[:]
    gate = tm._guided_gate_eager(t(loc1), t(loc2), t(H), scal[0], t(F),
                                 scal[1])
    tm._match_core_eager(t(d1), t(d2), ones1, ones2, *thr, True, gate)
    tm._match_core_eager(t(d1), t(d2), ones1, ones2, *thr, False)
    assert not _watched(host_reads, ("matcher.py",)), host_reads
    # the spies see the file: SiftMatcher copies the descriptors in
    tm.SiftMatcher(device="cpu").match({"desc": d1}, {"desc": d2})
    assert ("from_numpy", "matcher.py") in _watched(host_reads,
                                                    ("matcher.py",))


# ---------------------------------------------------------------------------
# the RANSAC cores
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module")
def ransac_runs(scene):
    """The JAX package's jitted RANSACs for PRNGKey(3), and the same draws
    made by the port's sample_indices."""
    s = scene
    key = jax.random.PRNGKey(3)
    fres = jtv.ransac_fundamental(key, jnp.asarray(s["p1"]),
                                  jnp.asarray(s["p2"]), jnp.ones(N, bool))
    fidx = sample_indices(3, N, (512, 8), np.full(N, 1.0 / N, np.float32),
                          "cpu")
    X = np.zeros((128, 3), np.float32)
    uv = np.zeros((128, 2), np.float32)
    X[:N_PNP], uv[:N_PNP] = s["pnp_X"], s["uv"]
    valid = np.arange(128) < N_PNP
    pres = jtv.ransac_pnp(key, jnp.asarray(X), jnp.asarray(uv),
                          jnp.asarray(valid), jnp.asarray(K, jnp.float32))
    probs = valid.astype(np.float32)
    pidx = sample_indices(3, 128, (256, 6), probs / probs.sum(), "cpu")
    return dict(fres=fres, fidx=fidx, pres=pres, pidx=pidx, X=X, uv=uv,
                valid=valid)


def test_ransac_fundamental_entry_is_its_body_and_jax(scene, ransac_runs):
    r = ransac_runs
    args = (r["fidx"], t(scene["p1"]), t(scene["p2"]),
            torch.ones(N, dtype=torch.bool))
    got = ttv.ransac_fundamental_from_samples(*args)
    with ttv.full_f32_matmul():
        body = ttv._ransac_fundamental_core(*args, 2.0)
    assert _equal(tuple(got), tuple(body))
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(r["fres"].inliers))
    assert int(got.num_inliers) == int(r["fres"].num_inliers) >= N - 70
    assert _close(_canon(got.F.numpy()), _canon(r["fres"].F))


def test_ransac_pnp_entry_is_its_body_and_jax(ransac_runs):
    r = ransac_runs
    args = (r["pidx"], t(r["X"]), t(r["uv"]), t(r["valid"]),
            t(K.astype(np.float32)))
    got = ttv.ransac_pnp_from_samples(*args)
    with ttv.full_f32_matmul():
        body = ttv._ransac_pnp_core(*args, 8.0)
    assert _equal(tuple(got), tuple(body))
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(r["pres"].inliers))
    assert int(got.num_inliers) == int(r["pres"].num_inliers) >= 70
    np.testing.assert_allclose(got.R.numpy(), np.asarray(r["pres"].R),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(r["pres"].t),
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("route", ["lapack", "jacobi"])
def test_the_ransac_cores_svd_calls(scene, ransac_runs, monkeypatch, route):
    """The decompositions each core makes, in order: the eight-point
    systems, their 3 x 3 SVDs, the refit's system and its 3 x 3; the DLT
    systems and their 3 x 3s. On the CPU's LAPACK route torch.linalg.svd
    at those shapes; on the kernels' route (the plain Jacobi standing in
    for csrc/linalg.cu) null_vector and svd3 at the same shapes and no
    library decomposition."""
    r = ransac_runs
    calls = []

    def spy(owner, name):
        real = getattr(owner, name)

        def recorded(A, *a, **kw):
            calls.append((name, tuple(A.shape)))
            return real(A, *a, **kw)
        monkeypatch.setattr(owner, name, recorded)

    for name in ("svd", "svdvals", "eigh", "eig", "qr"):
        spy(torch.linalg, name)
    spy(linalg, "null_vector_plain")
    spy(linalg, "svd3_plain")
    monkeypatch.setattr(ttv, "PLAIN_JACOBI_ON_CPU", route == "jacobi")
    with ttv.full_f32_matmul():
        ttv._ransac_fundamental_core(
            r["fidx"], t(scene["p1"]), t(scene["p2"]),
            torch.ones(N, dtype=torch.bool), 2.0)
        ttv._ransac_pnp_core(r["pidx"], t(r["X"]), t(r["uv"]),
                             t(r["valid"]), t(K.astype(np.float32)), 8.0)
    shapes = [(512, 8, 9), (512, 3, 3), (N, 9), (3, 3), (256, 12, 12),
              (256, 3, 3)]
    if route == "lapack":
        assert calls == [("svd", sh) for sh in shapes]
    else:
        assert calls == [("null_vector_plain" if len(sh) > 1 and sh[-1] > 3
                          else "svd3_plain", sh) for sh in shapes]


def test_the_ransac_cores_read_nothing_from_the_host(scene, ransac_runs,
                                                     host_reads, monkeypatch):
    """Both cores' bodies, on the LAPACK route and on the kernels' route
    (the plain Jacobi in place of csrc/linalg.cu, whose wrappers launch on
    the card's pointers alone): no upload, read-back or 0-d index."""
    r = ransac_runs
    watched = ("sfm/twoview.py", "ops/linalg.py", "ops/cuda/linalg.py")
    for jacobi in (False, True):
        monkeypatch.setattr(ttv, "PLAIN_JACOBI_ON_CPU", jacobi)
        del host_reads[:]
        with ttv.full_f32_matmul():
            ttv._ransac_fundamental_core(
                r["fidx"], t(scene["p1"]), t(scene["p2"]),
                torch.ones(N, dtype=torch.bool), 2.0)
            ttv._ransac_pnp_core(
                r["pidx"], t(r["X"]), t(r["uv"]), t(r["valid"]),
                t(K.astype(np.float32)), 8.0)
        assert not _watched(host_reads, watched), (jacobi, host_reads)
    # the spies see the file: recover_pose, which stays eager, picks its
    # pose by a 0-d index
    Kt = t(K.astype(np.float32))
    E = ttv.essential_from_fundamental(t(scene["F_true"].astype(np.float32)),
                                       Kt, Kt)
    ttv.recover_pose(E, t(scene["p1"]), t(scene["p2"]), Kt, Kt)
    assert ("__getitem__ by a 0-d tensor", "sfm/twoview.py") in \
        _watched(host_reads, ("sfm/twoview.py",))


# ---------------------------------------------------------------------------
# the pose-graph step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loop():
    return _drifted_loop()


def _graph(lp):
    return tpg.PoseGraph(edge_i=t(lp["ei"]), edge_j=t(lp["ej"]),
                         R_ij=t(lp["Rij"]), t_ij=t(lp["tij"]),
                         weight=t(lp["w"]))


def test_pose_graph_step_is_its_body_and_jax(loop):
    g = _graph(loop)
    R, tt = tpg.optimize_pose_graph(t(loop["Rp"]), t(loop["tp"]), g)
    Rb, tb = t(loop["Rp"]), t(loop["tp"])
    mask = torch.ones((len(Rb), 1))
    mask[0] = 0.0
    with ttv.full_f32_matmul():
        for _ in range(20):
            Rb, tb = tpg._step(Rb, tb, g, mask, 1e-4)
    assert torch.equal(R, Rb) and torch.equal(tt, tb)
    assert (tt - t(loop["tp"])).abs().max() > 1e-2    # the steps moved
    jg = jpg.PoseGraph(edge_i=jnp.asarray(loop["ei"], jnp.int32),
                       edge_j=jnp.asarray(loop["ej"], jnp.int32),
                       R_ij=jnp.asarray(loop["Rij"]),
                       t_ij=jnp.asarray(loop["tij"]),
                       weight=jnp.asarray(loop["w"]))
    jR, jt = jpg.optimize_pose_graph(jnp.asarray(loop["Rp"]),
                                     jnp.asarray(loop["tp"]), jg,
                                     iterations=20)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-4)


def test_the_pose_graph_step_reads_nothing_from_the_host(loop, host_reads):
    g = _graph(loop)
    R, tt = t(loop["Rp"]), t(loop["tp"])
    del host_reads[:]
    tpg.step(R, tt, g, 1e-4, True)
    watched = ("sfm/posegraph.py", "sfm/ba.py")
    assert not _watched(host_reads, watched), host_reads
    tpg.graph_cost(R, tt, g)          # reads its value back: the spies see it
    assert ("__float__", "sfm/posegraph.py") in _watched(host_reads, watched)


# ---------------------------------------------------------------------------
# the graph cache: second-call capture, stats, per-cache switch
# ---------------------------------------------------------------------------

class _FakeGraph:
    def __init__(self, key, capture_at):
        self.stats = GraphStats(key=key, capture_s=0.25, kept_bytes=10,
                                pool_reserved_bytes=100, launches={},
                                inputs=1, outputs=1, replays=0,
                                capture_at=capture_at,
                                eager_calls=capture_at - 1)


def test_a_second_call_cache_captures_a_key_at_its_second_call():
    cache = GraphCache(max_bytes=1000, capture_at=2)
    made = []
    make = lambda k: (lambda: made.append(k) or _FakeGraph(k, 2))  # noqa
    assert cache._get("a", make("a")) is None          # first: eager
    assert cache.eager_calls == 1 and cache.captures == 0 and not made
    g = cache._get("a", make("a"))                     # second: captured
    assert made == ["a"] and cache.captures == 1 and len(cache) == 1
    assert g.stats.capture_at == 2 and g.stats.eager_calls == 1
    assert cache._get("a", make("a")) is g and made == ["a"]   # replayed
    assert cache.replays == 2
    assert cache._get("b", make("b")) is None and cache.eager_calls == 2
    assert cache.capture_s == 0.25 and cache.stats()[0].eager_calls == 1


def test_a_first_call_cache_captures_at_once():
    cache = GraphCache(max_bytes=1000)
    assert cache.capture_at == 1
    g = cache._get("a", lambda: _FakeGraph("a", 1))
    assert g is not None and cache.eager_calls == 0 and cache.captures == 1
    assert g.stats.eager_calls == 0 and g.stats.capture_at == 1
    with pytest.raises(ValueError, match="capture_at"):
        GraphCache(1, capture_at=3)


def test_a_dropped_key_starts_over_and_the_seen_keys_are_bounded(
        monkeypatch):
    monkeypatch.setattr(graphs, "SEEN_KEYS", 3)
    cache = GraphCache(max_bytes=150, capture_at=2)
    make = lambda k: (lambda: _FakeGraph(k, 2))              # noqa: E731
    for k in "ab":
        cache._get(k, make(k))
        cache._get(k, make(k))
    assert cache.keys() == ["b"]          # a's pool dropped past the bound
    assert cache._get("a", make("a")) is None          # eager again
    for k in "cdef":
        cache._get(k, make(k))
    assert list(cache._seen) == ["d", "e", "f"]        # a and c forgotten
    assert cache._get("a", make("a")) is None
    cache.clear()
    assert len(cache) == 0 and not cache._seen
    assert cache._get("d", make("d")) is None          # forgotten by clear


def test_the_ransac_cores_are_one_program_each(scene, ransac_runs,
                                               monkeypatch):
    """A core is a plain function: no generator, nothing yielded for an
    eager call between graphs. Its kernels' route gives the LAPACK route's
    result on these inliers."""
    r = ransac_runs
    args = (r["fidx"], t(scene["p1"]), t(scene["p2"]),
            torch.ones(N, dtype=torch.bool), 2.0)
    with ttv.full_f32_matmul():
        lapack = ttv._ransac_fundamental_core(*args)
        monkeypatch.setattr(ttv, "PLAIN_JACOBI_ON_CPU", True)
        jacobi = ttv._ransac_fundamental_core(*args)
    assert isinstance(lapack, ttv.TwoViewResult)
    assert torch.equal(lapack.inliers, jacobi.inliers)
    assert not hasattr(graphs, "Eager") and not hasattr(graphs,
                                                        "run_eagerly")


def test_disable_graphs_for_some_caches():
    a, b = GraphCache(1), GraphCache(1)
    with disable_graphs(caches=[a]):
        assert not graphs_enabled(a) and graphs_enabled(b) and \
            graphs_enabled()
        with disable_graphs():
            assert not graphs_enabled(b)
        with disable_graphs(False, caches=[a]):
            assert graphs_enabled(a)
        assert not graphs_enabled(a)
    assert graphs_enabled(a) and graphs_enabled(b)


def test_the_new_entry_points_clear_their_caches():
    for fn, cache in ((ht.describe_keypoints, tdesc._DESCRIBE_GRAPHS),
                      (tm._match_core, tm._MATCH_GRAPHS),
                      (ttv.ransac_fundamental_from_samples,
                       ttv._RANSAC_F_GRAPHS),
                      (ttv.ransac_pnp_from_samples, ttv._PNP_GRAPHS),
                      (tpg.optimize_pose_graph, tpg._STEP_GRAPHS)):
        cache._seen["k"] = None
        fn.clear_cache()
        assert len(cache) == 0 and not cache._seen
    # the fundamental RANSAC's N is not padded: it captures a key at its
    # second call; the bucketed boundaries at the first
    assert ttv._RANSAC_F_GRAPHS.capture_at == 2
    for c in (tdesc._DESCRIBE_GRAPHS, tm._MATCH_GRAPHS, ttv._PNP_GRAPHS,
              tpg._STEP_GRAPHS):
        assert c.capture_at == 1
