"""Captured CUDA graphs, one per static key: the port's counterpart of the
JAX package's jax.jit caches (hessgpu_tpu/pyramid.py run_pipeline_jit,
parallel/batch.py _batched_pipeline, sfm/ba.py lm_step).

A jitted JAX function compiles one program per static argument and input
shape and reuses it; a GraphCache captures one CUDA graph per key and input
shapes, dtypes and device, and replays it. The first call of a key runs the
function once eagerly on a side stream (the kernels' first-use set-up:
shared-memory attributes, cuBLAS handles), then captures one call into a
graph with a private memory pool. Every call, the first included, copies
the caller's tensors into the graph's static inputs, replays the graph on
the current stream, and returns clones of the static outputs: the next
replay overwrites them, and callers keep results across calls as they keep
the JAX package's fresh arrays.

A capture raises on anything that would synchronise with the host (a copy
from pageable memory, .item(), torch.nonzero): nothing gives way to the
eager route. A graph replays the kernels recorded at capture with the
arguments they had then, host values and device addresses alike, so the
function must take every input that changes from call to call as a tensor
argument.

A graph keeps the buffers of its call in its pool for as long as it is
cached, where an eager call returns them to the caching allocator: a cache
is bounded by the bytes its graphs reserve, the least recently used graph
dropped first.

Threads may share a cache (the feature server gives each client a thread):
one call's copy in, replay and clones out are one unit, which another
thread's call of the same graph waits for, on the host and on the card; and
one capture runs at a time in the process, in CUDA's thread-local capture
mode, so that other threads' work goes on meanwhile.

disable_graphs() is the counterpart of jax.disable_jit(): inside it the
entry points that replay graphs run their eager bodies instead. It is one
setting for the whole process, not one per thread.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, NamedTuple

import torch
from torch.utils import _pytree as pytree

from ..ops.cuda import build

_disabled = False

# One capture at a time in the process, and no cache emptied during one.
_capture_lock = threading.Lock()


@contextlib.contextmanager
def disable_graphs(disable: bool = True):
    """Run the graph entry points eagerly inside the block (the counterpart
    of jax.disable_jit); the caller's setting comes back after it."""
    global _disabled
    prev, _disabled = _disabled, disable
    try:
        yield
    finally:
        _disabled = prev


def graphs_enabled() -> bool:
    return not _disabled


class GraphStats(NamedTuple):
    """What one captured graph cost and holds."""
    key: tuple
    capture_s: float          # the eager warm-up call, capture, instantiation
    kept_bytes: int           # memory_allocated the graph holds: its static
    #                           inputs and outputs (live blocks of its pool)
    pool_reserved_bytes: int  # memory_reserved it holds: its static inputs
    #                           and its private pool (what the bound counts)
    launches: Dict[str, int]  # the port's kernel launches recorded per replay
    inputs: int               # tensors copied in per call
    outputs: int              # tensors cloned out per call
    replays: int


class _Graph:
    """One captured call of fn: the graph, its static inputs and outputs.
    Made under _capture_lock. The memory counts are the device's counters
    before and after, so other threads' allocations meanwhile show in
    them."""

    def __init__(self, key, fn: Callable, leaves: List[torch.Tensor], spec):
        self.fn = fn        # and what it holds: tensors the capture read
        dev = leaves[0].device
        t0 = time.perf_counter()
        self.static_in = [t.clone(memory_format=torch.contiguous_format)
                          for t in leaves]
        in_bytes = sum(t.untyped_storage().nbytes() for t in self.static_in)
        args = pytree.tree_unflatten(self.static_in, spec)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*args)                   # first use: kernel and library set-up
        torch.cuda.current_stream(dev).wait_stream(side)
        # the warm-up's cached blocks go back to the card, so that what is
        # reserved from here on is the graph's own pool
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        alloc0 = torch.cuda.memory_allocated(dev)
        reserved0 = torch.cuda.memory_reserved(dev)
        counts0 = build.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            out = fn(*args)
        counts1 = build.launch_counts()
        self.static_out, self.out_spec = pytree.tree_flatten(out)
        if not all(isinstance(t, torch.Tensor) for t in self.static_out):
            raise TypeError("a graph's function must return tensors only")
        torch.cuda.synchronize(dev)
        self._stats = GraphStats(
            key=key, capture_s=time.perf_counter() - t0,
            kept_bytes=in_bytes + torch.cuda.memory_allocated(dev) - alloc0,
            pool_reserved_bytes=in_bytes + torch.cuda.memory_reserved(dev)
            - reserved0,
            launches={k: counts1[k] - counts0[k] for k in counts1
                      if counts1[k] != counts0[k]},
            inputs=len(self.static_in), outputs=len(self.static_out),
            replays=0)
        self.replays = 0
        self._lock = threading.Lock()
        self._done = torch.cuda.Event()     # the last call's clones taken

    @property
    def stats(self) -> GraphStats:
        return self._stats._replace(replays=self.replays)

    def __call__(self, leaves: List[torch.Tensor]):
        with self._lock:
            stream = torch.cuda.current_stream()
            stream.wait_event(self._done)   # a call on another stream
            for s, t in zip(self.static_in, leaves):
                s.copy_(t)
            self.graph.replay()
            out = [t.clone() for t in self.static_out]
            self._done.record(stream)
            self.replays += 1
        return pytree.tree_unflatten(out, self.out_spec)


class GraphCache:
    """Captured graphs by key, the least recently used dropped first while
    the graphs' pool_reserved_bytes sum to more than `max_bytes` (the newest
    graph is kept whatever its size).

    cache(key, fn, *args) returns fn(*args) through the graph of (key, the
    shapes, dtypes and device of the tensors in args). args: tensors, or
    tuples / NamedTuples / dicts of tensors, on one CUDA device; a CPU
    tensor raises. key: hashable, standing for everything else fn depends
    on."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
        self._lock = threading.Lock()
        self.captures = 0          # graphs captured since the cache was made
        self.capture_s = 0.0       # and the seconds those captures took

    def __call__(self, key, fn: Callable, *args):
        leaves, spec = pytree.tree_flatten(args)
        for t in leaves:
            if not isinstance(t, torch.Tensor) or not t.is_cuda:
                raise ValueError(
                    "GraphCache: every argument must be a CUDA tensor, got "
                    + (f"{t.device} tensor" if isinstance(t, torch.Tensor)
                       else type(t).__name__))
        dev = leaves[0].device
        if any(t.device != dev for t in leaves):
            raise ValueError("GraphCache: arguments on more than one device")
        full = (key, tuple((tuple(t.shape), t.dtype) for t in leaves),
                dev.index)
        with torch.cuda.device(dev):
            with self._lock:
                g = self._graphs.get(full)
                if g is None:
                    with _capture_lock:
                        g = self._add(full, _Graph(full, fn, leaves, spec))
                else:
                    self._graphs.move_to_end(full)
            return g(leaves)

    def _add(self, key, graph):
        self._graphs[key] = graph
        self.captures += 1
        self.capture_s += graph.stats.capture_s
        while len(self._graphs) > 1 and self.reserved_bytes() > self.max_bytes:
            self._graphs.popitem(last=False)
        return graph

    def __len__(self) -> int:
        return len(self._graphs)

    def keys(self) -> List[tuple]:
        return list(self._graphs)

    def stats(self) -> List[GraphStats]:
        return [g.stats for g in self._graphs.values()]

    def reserved_bytes(self) -> int:
        """The bytes the cached graphs reserve (their pool_reserved_bytes)."""
        return sum(g.stats.pool_reserved_bytes for g in self._graphs.values())

    def clear(self) -> None:
        """Drop every graph with its static tensors, and return the freed
        pools (and the caching allocator's other free blocks) to the
        device."""
        with self._lock, _capture_lock:
            self._graphs.clear()
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()
