"""A fixture that puts the port's graph entry points on their graph route on
the CPU, where no CUDA graph exists: utils.graphs.on_graph_route accepts CPU
tensors, and every GraphCache runs the function it would capture eagerly, in
place of the capture and the replay, recording each call: the cache, its
key, and the host calls the function made (the calls a capture refuses: an
upload from host memory, a read-back, torch.nonzero, and a read of the
card's free memory). What the function returns is what a replay returns, so
a test holds the captured body itself to the eager route and to the JAX
package.
"""

import os
import sys
from typing import List, NamedTuple

import pytest
import torch

import hessgpu_tpu_torch
from hessgpu_tpu_torch.parallel import distributed as td
from hessgpu_tpu_torch.utils import graphs
from hessgpu_tpu_torch.utils.graphs import GraphCache

PKG = os.path.dirname(os.path.abspath(hessgpu_tpu_torch.__file__))

# the functions that copy from or read back to the host, by owner
HOST_CALLS = {torch: ("tensor", "as_tensor", "from_numpy", "nonzero"),
              torch.Tensor: ("item", "tolist", "__bool__", "__int__",
                             "__float__"),
              torch.cuda: ("mem_get_info",),
              td: ("_row_tile",)}

# the port's files whose code a mesh graph captures (the plain kernel
# versions in ops/*.py run on the CPU only)
CAPTURED_FILES = ("parallel/", "sfm/distributed_ba.py", "sfm/ba.py",
                  "pyramid.py", "matcher.py", "ops/compaction.py",
                  "ops/cuda/")


class GraphCall(NamedTuple):
    cache: GraphCache
    key: tuple
    host_calls: List[tuple]   # (name, file relative to the package)


def in_captured_files(calls, files=CAPTURED_FILES):
    return [c for c in calls
            if any(c[1] == f or (f.endswith("/") and c[1].startswith(f))
                   for f in files)]


@pytest.fixture
def graph_route(monkeypatch):
    """The list of GraphCache calls made while the test runs, each run
    eagerly on the CPU."""
    calls: List[GraphCall] = []
    recording: List[list] = []          # the open call's host calls

    def spy(owner, name):
        real = getattr(owner, name)

        def recorded(*a, **kw):
            if recording:
                path = sys._getframe(1).f_code.co_filename
                recording[-1].append((name, os.path.relpath(path, PKG)))
            return real(*a, **kw)
        monkeypatch.setattr(owner, name, recorded)

    for owner, names in HOST_CALLS.items():
        for name in names:
            spy(owner, name)

    def replay(self, key, fn, *args):
        recording.append([])
        try:
            out = fn(*args)
        finally:
            calls.append(GraphCall(self, key, recording.pop()))
        return out

    monkeypatch.setattr(graphs, "GRAPH_DEVICE_TYPES",
                        frozenset({"cuda", "cpu"}))
    monkeypatch.setattr(GraphCache, "__call__", replay)
    return calls
