"""The mesh boundaries of the port's compiled-program layer on the CPU: the
JAX package's five jit(shard_map) programs (parallel/batch.py
_build_sharded_batch_fn, parallel/spatial.py _build_sharded_fn and
_assemble_feature_table, sfm/distributed_ba.py's sharded LM step,
parallel/distributed.py match_sharded's program) and their counterparts,
each one GraphCache of its own (utils/graphs.py).

A CUDA graph has no CPU counterpart: the fixture of tests/_torch_graph_route.py
puts the entry points on their graph route here and runs the function a card
would capture eagerly, recording its cache, its key and the host calls it
makes. The cases:

  * the graph route's result equals the eager route's bit for bit (on the
    CPU both run the same torch operations in the same order);
  * the captured function makes no host call (no upload from host memory,
    no read-back, no read of the card's free memory): a capture would raise;
  * the keys: another mesh size, configuration, mode or tile is another
    graph;
  * the eager routes: a process group's mesh (device_mesh without a group
    here), disable_graphs() and disable_graphs(caches=[...]) reach no
    GraphCache.

The parity of each captured function with the JAX package is held in the
files that already compute the JAX results (test_torch_batch_mesh.py,
test_torch_spatial.py, test_torch_spatial_describe.py,
test_torch_distributed_ba.py, test_torch_distributed.py), so that no JAX
sharded program is compiled twice. The card's replays are in
tests/test_torch_compiled_mesh_gpu.py.
"""

import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hessgpu_tpu_torch import SiftConfig, make_plan
from hessgpu_tpu_torch.convert import ba_from_numpy
from hessgpu_tpu_torch.parallel import batch as tbatch
from hessgpu_tpu_torch.parallel import distributed as td
from hessgpu_tpu_torch.parallel import spatial as tsp
from hessgpu_tpu_torch.parallel.distributed import device_mesh, local_mesh
from hessgpu_tpu_torch.sfm import distributed_ba as tdba
from hessgpu_tpu_torch.sfm.synthetic import texture_frame
from hessgpu_tpu_torch.utils.graphs import (GraphCache, disable_graphs,
                                            on_graph_route)

from _torch_graph_route import (PKG, graph_route,  # noqa: F401
                                in_captured_files)
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_compiled import _ba_problem
from test_torch_distributed import _problem as _match_problem

SPATIAL_CFG = dict(threshold=0.001)


def _spatial_image(h=256, w=160):
    return texture_frame(3, h, w)


def _run_batch(n=2, cfg=None, mesh=None):
    frames = np.stack([texture_frame(s, 64, 96) for s in range(4)])
    cfg = cfg or SiftConfig()
    return tbatch.detect_batch(frames, cfg, device="cpu",
                               mesh=mesh or local_mesh(n))


def _run_spatial(n=2, cfg=None, describe=True, mesh=None):
    cfg = cfg or SiftConfig(**SPATIAL_CFG)
    mesh = mesh or local_mesh(n)
    if describe:
        return tsp.sharded_detect_and_describe(_spatial_image(), cfg, mesh,
                                               device="cpu", with_aux=True)
    return tsp.sharded_detect_keypoints(_spatial_image(), cfg, mesh,
                                        device="cpu")


def _run_lm(n=2, cg_iters=30, mesh=None):
    state, prob = ba_from_numpy(device="cpu", **_ba_problem())
    mesh = mesh or local_mesh(n)
    step = tdba.make_sharded_lm_step(mesh, cg_iters=cg_iters)
    return step(state, torch.full((), 1e-3),
                tdba.pad_problem(prob, mesh.size))


def _run_match(n=2, guided=False, mutual=True, n2_tile=64, mesh=None,
               no_mesh=False):
    d1, d2, g = _match_problem(11, 203, 171, guided=guided)
    kw = dict(loc1=g["loc1"], loc2=g["loc2"], H=g["H"], F=g["F"]) \
        if guided else {}
    return td.match_sharded(d1, d2, None if no_mesh else
                            (mesh or local_mesh(n)), mutual_best=mutual,
                            n2_tile=n2_tile, device="cpu", **kw)


BOUNDARIES = {
    "batch": (_run_batch, tbatch._MESH_BATCH_GRAPHS),
    "spatial_describe": (_run_spatial, tsp._SPATIAL_GRAPHS),
    "spatial_keypoints": (lambda **kw: _run_spatial(describe=False, **kw),
                          tsp._SPATIAL_GRAPHS),
    "lm_step": (_run_lm, tdba._SHARDED_LM_GRAPHS),
    "match": (_run_match, td._MATCH_SHARDED_GRAPHS),
    "match_guided": (lambda **kw: _run_match(guided=True, **kw),
                     td._MATCH_SHARDED_GRAPHS),
}


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and \
            a.numpy().tobytes() == b.numpy().tobytes()
    return a == b


@pytest.mark.parametrize("name", sorted(BOUNDARIES))
def test_the_graph_route_equals_the_eager_route(graph_route, name):
    run, cache = BOUNDARIES[name]
    got = run()
    assert [c.cache for c in graph_route] == [cache]
    with disable_graphs():
        want = run()
    assert len(graph_route) == 1
    assert _equal(got, want)


@pytest.mark.parametrize("name", sorted(BOUNDARIES))
def test_the_captured_function_makes_no_host_call(graph_route, name):
    """With the constants warm (a first call made them), the function the
    card captures uploads nothing from host memory, reads nothing back and
    reads no free memory (the row tile) in the captured files."""
    run, _ = BOUNDARIES[name]
    run()
    run()
    assert len(graph_route) == 2
    assert not in_captured_files(graph_route[1].host_calls), \
        graph_route[1].host_calls


def test_the_recorder_sees_host_calls(graph_route):
    """The spies are live inside a captured function: an upload, a
    read-back and a read of the free memory (the row tile) are recorded
    with the file that made them."""
    here = os.path.relpath(__file__, PKG)

    def fn(x):
        y = x + torch.tensor(1.0)
        td._row_tile(8, 8, False, x.device)
        return y * float(y.sum())

    GraphCache(1 << 20)(("k",), fn, torch.zeros(2))
    assert graph_route[0].host_calls == [
        ("tensor", here), ("_row_tile", here), ("__float__", here)]
    assert in_captured_files(graph_route[0].host_calls) == []


@pytest.mark.parametrize("name", ["batch", "spatial_describe",
                                  "spatial_keypoints", "lm_step", "match"])
def test_a_process_group_mesh_takes_the_eager_route(graph_route, name):
    """device_mesh without an initialized group: this process's one device
    as a process group's rank, whose collectives a capture cannot hold."""
    run, _ = BOUNDARIES[name]
    mesh = device_mesh("batch")
    assert not mesh.in_process and mesh.size == 1
    got = run(mesh=mesh)
    assert graph_route == []
    assert _equal(got, run(mesh=local_mesh(1)))
    assert len(graph_route) == 1


@pytest.mark.parametrize("name", sorted(BOUNDARIES))
def test_disable_graphs_takes_the_eager_route(graph_route, name):
    run, cache = BOUNDARIES[name]
    with disable_graphs():
        run()
    with disable_graphs(caches=[cache]):
        run()
    assert graph_route == []
    with disable_graphs(caches=[tsp._SPATIAL_GRAPHS
                                if cache is not tsp._SPATIAL_GRAPHS
                                else td._MATCH_SHARDED_GRAPHS]):
        run()
    assert [c.cache for c in graph_route] == [cache]


def test_the_route_rule():
    """A card's tensor, the cache enabled, and no mesh or an in-process
    one; the CPU's tensors never (without the fixture)."""
    cache, other = td._MATCH_SHARDED_GRAPHS, tsp._SPATIAL_GRAPHS
    card = SimpleNamespace(device=torch.device("cuda", 0))
    assert on_graph_route(cache, card)
    assert on_graph_route(cache, card, local_mesh(4))
    assert not on_graph_route(cache, card, device_mesh("batch"))
    assert not on_graph_route(cache, torch.zeros(1), local_mesh(2))
    with disable_graphs():
        assert not on_graph_route(cache, card, local_mesh(2))
    with disable_graphs(caches=[cache]):
        assert not on_graph_route(cache, card, local_mesh(2))
        assert on_graph_route(other, card, local_mesh(2))


def _keys(graph_route):
    return [c.key for c in graph_route]


def test_batch_keys(graph_route):
    _run_batch(n=2)
    _run_batch(n=4)
    _run_batch(n=2, cfg=SiftConfig(compute_descriptors=False))
    _run_batch(n=2)
    k = _keys(graph_route)
    assert len(set(k[:3])) == 3 and k[3] == k[0]
    plan, ckey, size = k[0]
    assert plan == make_plan(64, 96, SiftConfig()) and size == 2


def test_spatial_keys(graph_route):
    cfg = SiftConfig(**SPATIAL_CFG)
    _run_spatial(n=2, cfg=cfg)
    _run_spatial(n=4, cfg=cfg)
    _run_spatial(n=2, cfg=cfg, describe=False)
    _run_spatial(n=2, cfg=dataclasses.replace(cfg, max_level_features=64))
    _run_spatial(n=2, cfg=dataclasses.replace(cfg))
    k = _keys(graph_route)
    assert len(set(k[:4])) == 4 and k[4] == k[0]
    assert k[0][:2] == (256, 160) and k[0][3:] == (2, True)


def test_lm_step_keys(graph_route):
    _run_lm(n=2)
    _run_lm(n=8)
    _run_lm(n=2, cg_iters=10)
    _run_lm(n=2)
    k = _keys(graph_route)
    assert len(set(k[:3])) == 3 and k[3] == k[0] == (2, 30, True)


def test_match_keys_and_tiles(graph_route, monkeypatch):
    """The tiles are decided on the host and go in the key: another column
    tile, another row tile (read from the device's memory, here set),
    another mode or mesh size is another graph; mesh=None and a one-shard
    in-process mesh are one program."""
    _run_match(n=2, n2_tile=64)
    _run_match(n=2, n2_tile=32)
    _run_match(n=2, mutual=False)
    _run_match(n=2, guided=True)
    _run_match(n=4)
    monkeypatch.setattr(td, "_row_tile", lambda *a: 16)
    want = _run_match(n=2, n2_tile=64)
    _run_match(n=1)
    _run_match(no_mesh=True)
    k = _keys(graph_route)
    assert len(set(k[:6])) == 6 and k[6] == k[7]
    assert k[5] == (2, True, False, 16, 64)
    with disable_graphs():
        assert torch.equal(_run_match(n=2, n2_tile=64), want)


def test_the_row_tile_is_a_power_of_two_below_the_rows(monkeypatch):
    cpu = torch.device("cpu")
    assert td._row_tile(100, 171, False, cpu) == 100
    # 256 MB over 40 bytes a pair of 16384 columns: 409 rows -> 256
    assert td._row_tile(1000, 16384, True, cpu) == 256
    assert td._row_tile(409, 16384, True, cpu) == 409
    assert td._row_tile(410, 16384, True, cpu) == 256
    assert td._row_tile(10 ** 6, 10 ** 9, True, cpu) == 1


def test_clear_cache_entry_points():
    for fn, cache in ((tbatch._sharded_batch_program,
                       tbatch._MESH_BATCH_GRAPHS),
                      (tdba.make_sharded_lm_step, tdba._SHARDED_LM_GRAPHS),
                      (td.match_sharded, td._MATCH_SHARDED_GRAPHS)):
        assert fn.clear_cache == cache.clear
        fn.clear_cache()
        assert len(cache) == 0
    tsp._sharded_program.clear_cache()
    _run_spatial(describe=False)
    assert tsp._spatial_constants.cache_info().currsize == 1
    tsp._sharded_program.clear_cache()
    assert tsp._spatial_constants.cache_info().currsize == 0
    assert len(tsp._SPATIAL_GRAPHS) == 0
    assert td._MATCH_SHARDED_GRAPHS.capture_at == 2
    assert tbatch._MESH_BATCH_GRAPHS.capture_at == 1
