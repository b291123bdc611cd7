"""Captured CUDA graphs, one per static key: the port's counterpart of the
JAX package's jax.jit caches (hessgpu_tpu/pyramid.py run_pipeline_jit,
parallel/batch.py _batched_pipeline, sfm/ba.py lm_step, describe.py
_pyramid_gradients / _orient_and_describe_level / _describe_all_pallas,
matcher.py _match_core / _guided_gate, sfm/twoview.py ransac_fundamental /
ransac_pnp, sfm/posegraph.py's step) and of its jitted shard_map programs
over a mesh (parallel/batch.py _build_sharded_batch_fn, parallel/spatial.py
_build_sharded_fn and _assemble_feature_table, sfm/distributed_ba.py's
sharded LM step, parallel/distributed.py match_sharded's program).

A jitted JAX function compiles one program per static argument and input
shape and reuses it; a GraphCache captures one CUDA graph per key and input
shapes, dtypes and device, and replays it. The first call of a key runs the
function once eagerly on the capture stream (the kernels' first-use set-up:
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

A cache made with capture_at=2 runs a key's first call eagerly, on the
caller's stream, and captures the key at its second call (that first call
was its warm-up): where the shapes follow the data and cannot be padded
(a fundamental RANSAC's N: its draws depend on N), most keys are met once,
and a capture costs more than the call. The keys met once are remembered,
the SEEN_KEYS most recent of them.

A graph keeps the buffers of its call in its pool for as long as it is
cached, where an eager call returns them to the caching allocator: a cache
is bounded by the bytes its graphs reserve, the least recently used graph
dropped first.

Threads may share a cache (the feature server gives each client a thread):
one call's copy in, replay and clones out are one unit, which another
thread's call of the same graph waits for, on the host and on the card;
and one capture runs at a time in the process, in CUDA's thread-local
capture mode, so that other threads' work goes on meanwhile.

A mesh's program is one graph only on an in-process mesh (or none), where
every collective is a torch operation on the one device: a process group's
collectives are host calls (gloo) or NCCL calls, which this layer does not
capture, so its entry points run eagerly there (on_graph_route). A graph's
function calls the eager bodies of the boundaries it holds, never their
GraphCaches: JAX inlines a nested jit, and a GraphCache called inside
another's capture raises.

disable_graphs() is the counterpart of jax.disable_jit(): inside it the
entry points that replay graphs run their eager bodies instead;
disable_graphs(caches=[...]) does so for those caches' entry points only.
It is one setting for the whole process, not one per thread.

Tracing (utils/timing.py): a call records the back-to-back spans
(timing.phases) `graphs.lookup` (the flatten, checks, key and cache
lookup, and a capture where one is due), `graphs.copy_in`, `graphs.launch`
(the replay) and `graphs.clone_out` (the clones and the completion
event). Every key holds timing.stage_tracing_enabled(): a graph captured
with the stages traced records a pair of timed events around its whole
function and around each pipeline stage (timing.stage), and each of its
replays reports the stages' device time (timing.DeviceStages) - read at
the graph's next call, under its lock (the span `graphs.read_stages`), or
by timing.take_trace(), whichever comes first, which waits for the
replay's last event. Tracing's own host cost: the spans, that read, and
the replay of a traced graph, whose event nodes make its launch slower
than the untraced graph's (PERF.md).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, FrozenSet, List, NamedTuple

import torch
from torch.utils import _pytree as pytree

from ..ops.cuda import build
from . import timing

_disabled = False
_disabled_caches: FrozenSet["GraphCache"] = frozenset()

# keys met once that a capture_at=2 cache remembers, the oldest dropped first
SEEN_KEYS = 4096

# One capture at a time in the process, and no cache emptied during one.
_capture_lock = threading.Lock()
# whether this thread is making a graph (its warm-up call and its capture),
# and, while a traced graph is captured, its timing.CaptureSink
_making = threading.local()


@contextlib.contextmanager
def disable_graphs(disable: bool = True, caches=None):
    """Run the graph entry points eagerly inside the block (the counterpart
    of jax.disable_jit); with `caches`, only the entry points of those
    GraphCaches. The caller's setting comes back after it."""
    global _disabled, _disabled_caches
    prev = _disabled, _disabled_caches
    if caches is None:
        _disabled = disable
    elif disable:
        _disabled_caches = _disabled_caches | frozenset(caches)
    else:
        _disabled_caches = _disabled_caches - frozenset(caches)
    try:
        yield
    finally:
        _disabled, _disabled_caches = prev


def graphs_enabled(cache: "GraphCache" = None) -> bool:
    """Whether the entry points replay graphs (those of `cache`, if given)."""
    return not _disabled and cache not in _disabled_caches


# the device types whose work replays captured graphs
GRAPH_DEVICE_TYPES = frozenset({"cuda"})


def on_graph_route(cache: "GraphCache", tensor: torch.Tensor,
                   mesh=None) -> bool:
    """Whether an entry point replays `cache`'s graph for work on `tensor`'s
    device over `mesh`: a card's tensor, the cache enabled, and no mesh or
    an in-process one (mesh.in_process). A process group's mesh runs
    eagerly: its collectives are calls no capture here holds."""
    return (tensor.device.type in GRAPH_DEVICE_TYPES
            and graphs_enabled(cache)
            and (mesh is None or mesh.in_process))


class GraphStats(NamedTuple):
    """What one captured graph cost and holds."""
    key: tuple
    capture_s: float          # the eager warm-up call (if any), capture,
    #                           instantiation
    kept_bytes: int           # memory_allocated the graph holds: its static
    #                           inputs and outputs (live blocks of its pool)
    pool_reserved_bytes: int  # memory_reserved it holds: its static inputs
    #                           and its private pool (what the bound counts)
    launches: Dict[str, int]  # the port's kernel launches recorded per replay
    inputs: int               # tensors copied in per call
    outputs: int              # tensors cloned out per call
    replays: int
    capture_at: int = 1       # the call of its key that captured it
    eager_calls: int = 0      # the key's calls run eagerly before it


# one capture stream per device, as torch.cuda.graph keeps one
_capture_streams: Dict[int, "torch.cuda.Stream"] = {}


def _capture_stream(dev) -> "torch.cuda.Stream":
    if dev.index not in _capture_streams:
        _capture_streams[dev.index] = torch.cuda.Stream(dev)
    return _capture_streams[dev.index]


class _Graph:
    """One captured call of fn: its graph, static inputs and outputs, in a
    private memory pool. Made under _capture_lock. The memory counts are
    the device's counters before and after, so other threads' allocations
    meanwhile show in them. warm_up: whether to call fn once eagerly on the
    capture stream first (first-use set-up: kernel attributes, library
    handles), for a key whose first call this is. traced: whether to record
    timed events around fn and its stages into the graph (the module's
    docstring)."""

    def __init__(self, key, fn: Callable, leaves: List[torch.Tensor], spec,
                 capture_at: int = 1, warm_up: bool = True,
                 traced: bool = False):
        self.fn = fn        # and what it holds: tensors the capture read
        dev = leaves[0].device
        t0 = time.perf_counter()
        self.static_in = [t.clone(memory_format=torch.contiguous_format)
                          for t in leaves]
        in_bytes = sum(t.untyped_storage().nbytes() for t in self.static_in)
        args = pytree.tree_unflatten(self.static_in, spec)
        stream = _capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        self._whole = None
        sink = timing.CaptureSink(dev) if traced else None
        with torch.cuda.stream(stream):
            if warm_up:
                fn(*args)
            # what is reserved from here on is the pool's: a capture
            # allocates from it alone, never from the allocator's cache
            alloc0 = torch.cuda.memory_allocated(dev)
            reserved0 = torch.cuda.memory_reserved(dev)
            counts0 = build.launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            self.graph.capture_begin(torch.cuda.graph_pool_handle(),
                                     capture_error_mode="thread_local")
            try:
                if traced:
                    _making.stages = sink
                    whole = (timing.timed_event(True),
                             timing.timed_event(True))
                    sink.record(whole[0])
                out = fn(*args)
                if traced:
                    sink.record(whole[1])
                    sink.join()
                    self._whole = whole
            finally:
                _making.stages = None
                self.graph.capture_end()
        self._stage_events = sink.pairs if traced else None
        torch.cuda.current_stream(dev).wait_stream(stream)
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
            replays=0, capture_at=capture_at, eager_calls=capture_at - 1)
        self.replays = 0
        self._lock = threading.Lock()
        self._done = torch.cuda.Event()     # the last call's clones taken
        self._unread = None     # the request of a traced replay not read

    @property
    def stats(self) -> GraphStats:
        return self._stats._replace(replays=self.replays)

    def __call__(self, leaves: List[torch.Tensor], rec=None):
        """rec: the call's timing.phases() recorder (None: tracing off)."""
        with self._lock:
            if self._unread is not None:
                self._read_stages()
                if rec is not None:
                    rec.mark("graphs.read_stages")
            stream = torch.cuda.current_stream()
            stream.wait_event(self._done)   # a call on another stream
            for s, t in zip(self.static_in, leaves):
                s.copy_(t)
            if rec is not None:
                rec.mark("graphs.copy_in")
            self.graph.replay()
            if rec is not None:
                request = rec.mark("graphs.launch")
            out = [t.clone() for t in self.static_out]
            self._done.record(stream)
            if rec is not None:
                rec.mark("graphs.clone_out")
                if self._whole is not None:
                    # a traced replay, left to read (the module's docstring)
                    self._unread = request
                    timing.defer_read(self)
            self.replays += 1
        return pytree.tree_unflatten(out, self.out_spec)

    def read_stages(self) -> None:
        """Record the device time of the last replay's stages
        (timing.DeviceStages), if not read yet; waits for its last event."""
        with self._lock:
            if self._unread is not None:
                self._read_stages()

    def _read_stages(self) -> None:
        timing.record_stages(self._unread, "graph", timing.stage_ms(
            self._stage_events, self._whole))
        self._unread = None


class GraphCache:
    """Captured graphs by key, the least recently used dropped first while
    the graphs' pool_reserved_bytes sum to more than `max_bytes` (the newest
    graph is kept whatever its size).

    cache(key, fn, *args) returns fn(*args) through the graph of (key, the
    shapes, dtypes and device of the tensors in args). args: tensors, or
    tuples / NamedTuples / dicts of tensors, on one CUDA device; a CPU
    tensor raises. key: hashable, standing for everything else fn depends
    on.

    capture_at, an internal choice of the entry point by whether its shapes
    follow the data: the call of a key that captures it, 1 or 2. At 2 the
    key's first call runs fn eagerly (and is the capture's warm-up; the
    module's docstring)."""

    def __init__(self, max_bytes: int, capture_at: int = 1):
        if capture_at not in (1, 2):
            raise ValueError(f"capture_at must be 1 or 2, got {capture_at}")
        self.max_bytes = max_bytes
        self.capture_at = capture_at
        self._graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
        self._seen: "OrderedDict[tuple, None]" = OrderedDict()
        self._lock = threading.Lock()
        self.captures = 0          # graphs captured since the cache was made
        self.capture_s = 0.0       # and the seconds those captures took
        self.eager_calls = 0       # first calls of keys run eagerly
        self.replays = 0           # calls that replayed a graph

    def __call__(self, key, fn: Callable, *args):
        rec = timing.phases()
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
        if getattr(_making, "graph", False):
            raise RuntimeError(
                "GraphCache called inside another graph's capture: the "
                "outer function must call the eager body")
        traced = timing.stage_tracing_enabled()
        full = (key, tuple((tuple(t.shape), t.dtype) for t in leaves),
                dev.index, traced)
        with torch.cuda.device(dev):
            g = self._get(full, lambda: _Graph(
                full, fn, leaves, spec, self.capture_at,
                warm_up=self.capture_at == 1, traced=traced))
            if rec is not None:
                rec.mark("graphs.lookup")
            if g is None:
                return fn(*args)
            return g(leaves, rec)

    def _get(self, key, make: Callable):
        """The graph of `key`, made by make() where the key is due its
        capture; None where its call runs eagerly (a key's first call, when
        capture_at is 2)."""
        with self._lock:
            g = self._graphs.get(key)
            if g is not None:
                self._graphs.move_to_end(key)
            elif self.capture_at > 1 and key not in self._seen:
                self._seen[key] = None
                while len(self._seen) > SEEN_KEYS:
                    self._seen.popitem(last=False)
                self.eager_calls += 1
            else:
                self._seen.pop(key, None)
                with _capture_lock:
                    _making.graph = True
                    try:
                        g = self._add(key, make())
                    finally:
                        _making.graph = False
            if g is not None:
                self.replays += 1
            return g

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
            self._seen.clear()
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()
