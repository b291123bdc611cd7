"""The port's map-scale matcher (hessgpu_tpu_torch/parallel/distributed.py)
on the CPU against the JAX package's match_sharded on the 1-device and the
8-device virtual CPU mesh (tests/conftest.py), and against its one-device
matcher (_match_core). The dots are integers, exact in float32, and every
merge is an exact max, so the results are equal, index for index, whatever
the tiles: plain and mutual, guided by H, F or both, N1 and N2 not
multiples of the tiles, tiny row and column tiles, tied maxima, and two
gloo ranks against one device.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.multiprocessing as mp

from hessgpu_tpu.matcher import _match_core as jax_core, quantize_descriptors
from hessgpu_tpu.parallel.distributed import (device_mesh as jax_mesh,
                                              match_sharded as jax_sharded)
from hessgpu_tpu_torch.parallel import distributed as td
from _torch_dist_worker import rank_main
from _torch_graph_route import graph_route  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401


def _descs(rng, n):
    d = np.abs(rng.randn(n, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return quantize_descriptors(d)


def _problem(seed, n1, n2, guided=False):
    """Seeded u8 descriptors with planted correspondences (d2[k + 3] =
    d1[k] for the first third of d1) and, guided, locations whose planted
    pairs sit 1.1x + 3 apart."""
    rng = np.random.RandomState(seed)
    d1, d2 = _descs(rng, n1), _descs(rng, n2)
    k = min(n1 // 3, n2 - 3)
    d2[3:3 + k] = d1[:k]
    if not guided:
        return d1, d2, {}
    loc1 = rng.rand(n1, 2).astype(np.float32) * 400
    loc2 = rng.rand(n2, 2).astype(np.float32) * 400
    loc2[3:3 + k] = loc1[:k] * 1.1 + 3.0
    H = np.diag([1.1, 1.1, 1.0]).astype(np.float32)
    H[:2, 2] = 3.0
    e = rng.randn(3)                       # F = [e]x H holds every H pair
    F = (np.array([[0, -e[2], e[1]], [e[2], 0, -e[0]], [-e[1], e[0], 0]])
         @ H).astype(np.float32)
    return d1, d2, dict(loc1=loc1, loc2=loc2, H=H, F=F)


def _jax(d1, d2, mesh_size, **kw):
    kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    return np.asarray(jax_sharded(jnp.asarray(d1), jnp.asarray(d2),
                                  jax_mesh("batch", mesh_size), **kw))


def _port(d1, d2, **kw):
    out = td.match_sharded(d1, d2, device="cpu", **kw)
    assert out.dtype == torch.int64 and out.shape == (len(d1),)
    return out.numpy()


def _core(d1, d2, mutual_best=True):
    return np.asarray(jax_core(jnp.asarray(d1), jnp.asarray(d2),
                               jnp.ones(len(d1), bool),
                               jnp.ones(len(d2), bool), 0.7, 0.8,
                               mutual_best=mutual_best))


@functools.lru_cache(maxsize=None)
def _jax_plain(mesh_size, mutual, n1, n2, n2_tile):
    """The JAX package's result on a plain case, run once per process."""
    d1, d2, _ = _problem(n1 + n2, n1, n2)
    return _jax(d1, d2, mesh_size, mutual_best=mutual, n2_tile=n2_tile)


def _guided_kw(n2_tile, use_h, use_f):
    d1, d2, g = _problem(7, 61, 90, guided=True)
    return d1, d2, dict(loc1=g["loc1"], loc2=g["loc2"], n2_tile=n2_tile,
                        H=g["H"] if use_h else None,
                        F=g["F"] if use_f else None)


@functools.lru_cache(maxsize=None)
def _jax_guided(mesh_size, n2_tile, use_h, use_f):
    """The JAX package's result on a guided case, run once per process."""
    d1, d2, kw = _guided_kw(n2_tile, use_h, use_f)
    return _jax(d1, d2, mesh_size, **kw)


@pytest.mark.parametrize("mesh_size", [1, 8])
@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize("n1, n2, n2_tile", [
    (64, 80, None),      # untiled
    (61, 150, 64),       # N1 not a multiple of the mesh, N2 of the tile
    (632, 100, 16),      # the JAX row tiling engaged, 7 column tiles
])
def test_plain_matches_jax(mesh_size, mutual, n1, n2, n2_tile):
    d1, d2, _ = _problem(n1 + n2, n1, n2)
    want = _jax_plain(mesh_size, mutual, n1, n2, n2_tile)
    got = _port(d1, d2, mutual_best=mutual, n2_tile=n2_tile)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _core(d1, d2, mutual))
    k = min(n1 // 3, n2 - 3)
    assert (got[:k] == 3 + np.arange(k)).mean() > 0.9


@pytest.mark.parametrize("mesh_size", [1, 8])
@pytest.mark.parametrize("n2_tile", [None, 32])
@pytest.mark.parametrize("use_h, use_f", [(True, False), (False, True),
                                          (True, True)],
                         ids=["H", "F", "H+F"])
def test_guided_matches_jax(mesh_size, n2_tile, use_h, use_f):
    d1, d2, kw = _guided_kw(n2_tile, use_h, use_f)
    want = _jax_guided(mesh_size, n2_tile, use_h, use_f)
    got = _port(d1, d2, **kw)
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() >= 5


@pytest.mark.parametrize("mesh_size", [1, 8])
@pytest.mark.parametrize("case", ["plain", "rows", "guided"])
def test_the_captured_walk_matches_jax(mesh_size, case, graph_route):
    """The function a card captures on an in-process mesh of mesh_size
    shards (the whole tiled walk, its merges, the column gather and the
    mutual check; the tiles in its key), run here by the graph_route
    fixture, against the JAX package's program on as many devices."""
    if case == "guided":
        d1, d2, kw = _guided_kw(32, True, True)
        want = _jax_guided(mesh_size, 32, True, True)
    else:
        mutual = case == "plain"
        d1, d2, _ = _problem(632 + 100, 632, 100)
        kw = dict(mutual_best=mutual, n2_tile=16)
        want = _jax_plain(mesh_size, mutual, 632, 100, 16)
    got = td.match_sharded(d1, d2, td.local_mesh(mesh_size), device="cpu",
                           **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert [c.cache for c in graph_route] == [td._MATCH_SHARDED_GRAPHS]
    assert graph_route[0].key[:3] == (mesh_size, case != "rows",
                                      case == "guided")


@pytest.mark.parametrize("n1_tile", [16, 32, 64])
@pytest.mark.parametrize("n2_tile", [16, 32, 64])
@pytest.mark.parametrize("guided", [False, True])
def test_tiny_tiles_equal_untiled(monkeypatch, n1_tile, n2_tile, guided):
    """Row tiles (the port picks them from memory; set here) and column
    tiles that cut N1 = 203 and N2 = 171 short at their ends."""
    d1, d2, g = _problem(11, 203, 171, guided=guided)
    kw = dict(loc1=g["loc1"], loc2=g["loc2"], H=g["H"]) if guided else {}
    want = _port(d1, d2, **kw)
    monkeypatch.setattr(td, "_row_tile", lambda *a: n1_tile)
    got = _port(d1, d2, n2_tile=n2_tile, **kw)
    np.testing.assert_array_equal(got, want)
    if not guided:
        np.testing.assert_array_equal(got, _core(d1, d2))
    assert (got >= 0).sum() >= 40


@pytest.mark.parametrize("mesh_size", [1, 8])
def test_tied_maxima_reject_as_in_jax(monkeypatch, mesh_size):
    """A column duplicated in another tile, and a row duplicated in another
    row tile and rank: both of the tied sides reject, and the rows and
    columns whose second best is the tie reject too."""
    d1, d2, _ = _problem(5, 40, 48)
    d2[40] = d2[5]                 # rows matching column 5 now tie 5 and 40
    d1[37] = d1[2]                 # column 5 of row 2 ties rows 2 and 37
    monkeypatch.setattr(td, "_row_tile", lambda *a: 16)
    for mutual in (True, False):
        want = _jax(d1, d2, mesh_size, mutual_best=mutual, n2_tile=16)
        got = _port(d1, d2, mutual_best=mutual, n2_tile=16)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _core(d1, d2, mutual))
        assert got[2] == -1 and got[37] == -1
    assert (got[:13] >= 0).sum() >= 8


def test_auto_tiling_and_empty_inputs(monkeypatch):
    """n2_tile=None tiles by 16384 columns past 256 MB of float32 block;
    an empty side gives -1 rows."""
    seen = []
    real = td._row_tile
    monkeypatch.setattr(td, "_row_tile",
                        lambda rows, n2t, *a: seen.append(n2t) or real(
                            rows, n2t, *a))
    d1, d2, _ = _problem(3, 4, 20)
    _port(d1, d2)
    big = np.zeros((16385, 128), np.uint8)
    _port(np.zeros((4097, 128), np.uint8), big)
    assert seen == [20, 16384]
    assert (_port(d1, d2[:0]) == -1).all() and _port(d1[:0], d2).shape == (0,)


def test_mesh_without_a_group():
    td.initialize()                                     # no coordinator: no-op
    assert not torch.distributed.is_initialized()
    mesh = td.device_mesh("rows")
    assert (mesh.axis_name, mesh.size, mesh.rank, mesh.group) \
        == ("rows", 1, 0, None)
    d1, d2, _ = _problem(9, 30, 40)
    np.testing.assert_array_equal(_port(d1, d2, mesh=mesh), _port(d1, d2))
    with pytest.raises(ValueError):
        td.device_mesh("rows", 2)


def test_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d1, d2, _ = _problem(9, 30, 40)
    with pytest.raises(RuntimeError, match="cuda"):
        td.match_sharded(d1, d2)


def test_two_gloo_ranks_equal_one_device(tmp_path):
    """Two processes in one gloo group, rows split 31 / 30: every rank
    returns the full result, equal to the one-device route."""
    d1, d2, g = _problem(13, 61, 150, guided=True)
    cases = {
        "plain": (d1, d2, dict(n2_tile=64)),
        "rows": (d1, d2, dict(mutual_best=False)),
        "guided": (d1, d2, dict(loc1=g["loc1"], loc2=g["loc2"], H=g["H"],
                                F=g["F"], n2_tile=32)),
    }
    init = f"file://{tmp_path / 'rendezvous'}"
    mp.start_processes(rank_main, args=(2, init, cases, str(tmp_path)),
                       nprocs=2, join=True, start_method="spawn")
    for name, (a, b, kw) in cases.items():
        want = _port(a, b, **kw)
        assert (want >= 0).sum() >= 5
        for rank in range(2):
            got = np.load(tmp_path / f"{name}_rank{rank}.npy")
            np.testing.assert_array_equal(got, want, err_msg=name)
