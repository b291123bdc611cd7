"""Multi-process helpers and map-scale matching (counterpart of
hessgpu_tpu/parallel/distributed.py).

The JAX package spreads work over a device mesh with jax.distributed and
XLA collectives. Here a mesh has one of two routes, chosen by its maker:

  * a process group (device_mesh): each rank of a torch.distributed group
    holds one shard on its own device (nccl between cards, gloo between
    CPU processes or between processes that share a card);
  * in process (local_mesh): all n shards on one device, riding a leading
    axis of size n - the counterpart of the JAX package's virtual CPU
    devices.

Code that runs on a mesh holds its shards as a leading axis of length
len(mesh.shards) (n in process, 1 in a group) and meets the other shards
through three collectives that work on both routes:

  * all_gather(x, mesh): (n, ...) - every shard's block, in shard order;
  * psum(x, mesh): the sum over the shards, in shard order in process;
  * exchange_halo(block, halo, mesh): each shard's rows extended by `halo`
    rows of its ring neighbours, clamped to the edge at the global borders
    (an all_gather of every shard's top and bottom rows, not send/recv).

Besides:

  * initialize(): joins the process group (no-op without a coordinator).
  * match_sharded(): the all-pairs descriptor matcher with image 1's rows
    split over the mesh's shards, walked in (row tile, column tile) blocks,
    so that the (N1, N2) dot matrix never exists whole. mesh=None runs it
    on one device. On the card, on an in-process mesh or none, the whole
    walk is one captured CUDA graph (utils/graphs.py) per (mesh size,
    mode, tiles) and (N1, N2): the counterpart of the JAX package's jitted
    shard_map program. (N1, N2) follow the data and are not padded: a pad
    would add work to a call bound by the device (up to 4x the dots), and a
    map-scale table is often matched once, so a key is captured at its
    second call (GraphCache capture_at=2) and its first runs eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..matcher import (_accept, _best_two, _guided_gate_eager, _scalar,
                       descriptor_dots)
from ..pyramid import resolve_device
from ..utils.graphs import GraphCache, on_graph_route

# The bytes the captured matching walks may reserve, the least recently
# used dropped first (the newest kept whatever its size). A graph's pool is
# its call's peak, up to a quarter of the card's memory (_row_tile): PERF.md
# gives the pools at 16384^2 and 65536^2 (chip_smoke.py's compiled phase).
MATCH_SHARDED_GRAPH_BYTES = 8 << 30
_MATCH_SHARDED_GRAPHS = GraphCache(MATCH_SHARDED_GRAPH_BYTES, capture_at=2)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda") -> None:
    """Join the process group of num_processes ranks as rank process_id
    (no-op without a coordinator). coordinator_address is "host:port", or
    an init URL ("tcp://host:port", "file:///path"). On the card each rank
    takes card process_id % device_count and the group speaks nccl; with
    device="cpu" it speaks gloo."""
    if coordinator_address is None:
        return
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=url, world_size=num_processes,
                            rank=process_id)


@dataclass(frozen=True)
class DeviceMesh:
    """A one-axis mesh of `size` shards.

    Process-group route (in_process False): the shards are the ranks of
    `group` (None: the default group), one device each; `rank` is this
    process's shard. In-process route (in_process True): this process
    holds all the shards, on one device."""
    axis_name: str
    size: int
    rank: int
    group: Optional[dist.ProcessGroup] = None
    in_process: bool = False

    @property
    def shards(self) -> range:
        """The shards this process holds, in order."""
        return range(self.size) if self.in_process \
            else range(self.rank, self.rank + 1)


def device_mesh(axis_name: str = "batch",
                n_devices: Optional[int] = None) -> DeviceMesh:
    """The first n_devices ranks of the initialized group (all of them by
    default); without a group, this process's one device. Every rank of
    the default group must call it, as with torch.distributed.new_group."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} devices needs "
                             "initialize() first")
        return DeviceMesh(axis_name, 1, 0)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n_devices}: the group has {world}")
    group = None if n == world else dist.new_group(list(range(n)))
    return DeviceMesh(axis_name, n, dist.get_rank(), group)


def local_mesh(n: int, axis_name: str = "batch") -> DeviceMesh:
    """An in-process mesh of n shards: every shard in this process, on the
    device its tensors lie on."""
    if n < 1:
        raise ValueError(f"local_mesh: n={n} must be positive")
    return DeviceMesh(axis_name, n, 0, None, in_process=True)


def mesh_shards(mesh: Optional[DeviceMesh]) -> range:
    """The shards this process holds (range(1) without a mesh)."""
    return range(1) if mesh is None else mesh.shards


def all_gather(x: torch.Tensor, mesh: Optional[DeviceMesh]) -> torch.Tensor:
    """x: this process's shards' blocks (len(mesh.shards), ...). Returns
    (mesh.size, ...): every shard's block in shard order."""
    if mesh is None or mesh.in_process or mesh.size == 1:
        return x
    return _all_gather(x[0], mesh)


def psum(x: torch.Tensor, mesh: Optional[DeviceMesh]) -> torch.Tensor:
    """x: (len(mesh.shards), ...). Returns the sum over all the mesh's
    shards, (...), on every shard. In process the shards are added in
    order, x[0] + x[1] + ...; a group's all_reduce adds in its backend's
    order."""
    if mesh is None or mesh.in_process or mesh.size == 1:
        acc = x[0]
        for i in range(1, x.shape[0]):
            acc = acc + x[i]
        return acc
    out = x[0].clone()
    dist.all_reduce(out, group=mesh.group)
    return out


def exchange_halo(block: torch.Tensor, halo: int,
                  mesh: Optional[DeviceMesh]) -> torch.Tensor:
    """Rows of a row-sharded array, extended by the ring neighbours' rows.

    block: (len(mesh.shards), ..., rows, W), shard s holding global rows
    [s * rows, (s + 1) * rows). Returns (len(mesh.shards), ...,
    rows + 2 * halo, W): above each shard's rows the last `halo` rows of
    shard s - 1, below them the first `halo` rows of shard s + 1, and at
    the global borders the edge row repeated (clamp-to-edge, as the
    one-device stencils). Needs halo <= rows: the exchange reaches the
    neighbours only."""
    rows = block.shape[-2]
    if halo == 0:
        return block
    if not 0 < halo <= rows:
        raise ValueError(f"exchange_halo: halo {halo} exceeds the band's "
                         f"{rows} rows")
    n = 1 if mesh is None else mesh.size
    own = mesh_shards(mesh)
    lo, hi = own.start, own.stop
    tops = all_gather(block[..., :halo, :], mesh)
    bots = all_gather(block[..., rows - halo:, :], mesh)
    shape = block.shape[:-2] + (rows + 2 * halo, block.shape[-1])
    out = block.new_empty(shape)
    out[..., halo:halo + rows, :] = block
    first = max(lo, 1)                       # shards with a shard above
    if first < hi:
        out[first - lo:, ..., :halo, :] = bots[first - 1:hi - 1]
    if lo == 0:
        out[0, ..., :halo, :] = block[0, ..., :1, :]
    last = min(hi, n - 1)                    # shards with a shard below
    if lo < last:
        out[:last - lo, ..., rows + halo:, :] = tops[lo + 1:last + 1]
    if hi == n:
        out[-1, ..., rows + halo:, :] = block[-1, ..., rows - 1:, :]
    return out


def _row_tile(rows: int, n2_tile: int, guided: bool,
              device: torch.device) -> int:
    """Rows per block. A block's float32 dots and, in guided mode, the
    gate's temporaries (about 10 floats per pair) take at most a quarter of
    the card's free memory (cudaMemGetInfo's, and the caching allocator's
    unused blocks), or 256 MB on the CPU. A power of two below `rows`, so
    that the tile (a key of the captured walk) holds while free memory
    moves a little."""
    if device.type == "cuda":
        idle = torch.cuda.memory_reserved(device) \
            - torch.cuda.memory_allocated(device)
        budget = (torch.cuda.mem_get_info(device)[0] + idle) // 4
    else:
        budget = 256 << 20
    per_pair = 40 if guided else 8
    tile = budget // (per_pair * n2_tile)
    if tile >= rows:
        return max(1, rows)
    return 1 << max(0, tile.bit_length() - 1)


def _merge_top2(v1, i1, v2, bv, bi, nv) -> None:
    """Fold a block's (max, argmax, second) into the running (v1, i1, v2),
    in place. Blocks come in index order, so a tie keeps the earlier index,
    and the global second is the loser of the two firsts or a second."""
    v2.copy_(torch.maximum(torch.minimum(v1, bv), torch.maximum(v2, nv)))
    i1.copy_(torch.where(bv > v1, bi, i1))
    v1.copy_(torch.maximum(v1, bv))


def _all_gather(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """(mesh.size, *x.shape): x from every rank of a group, in rank
    order."""
    src = x.contiguous()
    if src.dtype == torch.bool:          # gathered as bytes
        src = src.to(torch.uint8)
    out = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(out, src, group=mesh.group)
    return torch.stack(out).to(x.dtype)


def match_sharded(d1, d2, mesh: Optional[DeviceMesh] = None,
                  distmax: float = 0.7, ratiomax: float = 0.8,
                  mutual_best: bool = True, loc1=None, loc2=None,
                  H=None, F=None, hdistmax: float = 32.0,
                  fdistmax: float = 16.0, n2_tile: Optional[int] = None,
                  device="cuda") -> torch.Tensor:
    """Pairwise matching of u8 descriptors d1 (N1, 128) against d2
    (N2, 128), NumPy arrays or tensors: the match index per row of d1 or -1,
    int64 (N1,) on `device`, equal to matcher._match_core's.

    mesh: each shard takes a contiguous ceil(N1 / size) of d1's rows (every
    rank passes all of d1, d2 and the locations); the column statistics are
    combined by all_gather, and every rank returns the full (N1,) result.
    An in-process mesh walks its shards one after another. mesh=None is one
    device.

    Guided mode (reference GetGuidedSiftMatch): loc1 (N1, 2), loc2 (N2, 2)
    and a homography H and/or a fundamental matrix F; pairs outside the gate
    of matcher._guided_gate are dropped before the argmax. A None matrix
    skips its test (identity with a 1e20 threshold, SiftMatchGPU semantics).

    n2_tile: columns per block (map-scale mode). By default all of them,
    or 16384 when a rank's (rows, N2) float32 block would pass 256 MB. Rows
    per block follow from the device's memory. A row keeps an exact running
    top-2 over the column blocks, and a column over the row blocks, so the
    result does not depend on the tiles. A short last block stands in for
    the JAX package's padding.
    device="cuda" without a card raises.

    On the card, with an in-process mesh or none, a key's second call
    captures the walk and later calls replay it (the module's docstring);
    a process group's mesh, the CPU and disable_graphs() run it eagerly.
    match_sharded.clear_cache() frees the graphs.
    """
    dev = resolve_device(device)

    def tensor(a, dtype=None):
        t = a if torch.is_tensor(a) else torch.from_numpy(
            np.ascontiguousarray(a))
        return t.to(dev) if dtype is None else t.to(dev, dtype)

    guided = H is not None or F is not None
    if guided:
        if loc1 is None or loc2 is None:
            raise ValueError("guided match_sharded needs loc1 and loc2")
        if H is None:
            H, hdistmax = np.eye(3, dtype=np.float32), 1.0e20
        if F is None:
            F, fdistmax = np.eye(3, dtype=np.float32), 1.0e20
        H, F = tensor(H, torch.float32), tensor(F, torch.float32)
        loc1, loc2 = tensor(loc1, torch.float32), tensor(loc2, torch.float32)
    d1, d2 = tensor(d1), tensor(d2)
    size = 1 if mesh is None else mesh.size
    if mesh is not None and not 0 <= mesh.rank < size:
        raise ValueError("this process is not a rank of the mesh")
    n1, n2 = d1.shape[0], d2.shape[0]
    if n1 == 0 or n2 == 0:
        return torch.full((n1,), -1, dtype=torch.int64, device=dev)
    nloc = -(-n1 // size)
    if n2_tile is None and nloc * n2 * 4 > 256 * 1024 * 1024:
        n2_tile = 16384
    n2_tile = min(n2_tile or n2, n2)
    # decided on the host, outside any capture: the row tile reads the
    # device's free memory
    n1_tile = _row_tile(nloc, n2_tile, guided, dev)
    args = (d1, d2, _scalar(distmax, d1), _scalar(ratiomax, d1))
    if guided:
        args += (loc1, loc2, H, _scalar(hdistmax, d1), F,
                 _scalar(fdistmax, d1))

    def walk(*a):
        return _match_walk(*a, mesh=mesh, mutual_best=mutual_best,
                           n1_tile=n1_tile, n2_tile=n2_tile)

    if on_graph_route(_MATCH_SHARDED_GRAPHS, d1, mesh):
        return _MATCH_SHARDED_GRAPHS(
            (size, bool(mutual_best), guided, n1_tile, n2_tile), walk, *args)
    return walk(*args)


match_sharded.clear_cache = _MATCH_SHARDED_GRAPHS.clear


def _match_walk(d1, d2, distmax, ratiomax, loc1=None, loc2=None, H=None,
                hdistmax=None, F=None, fdistmax=None, *, mesh, mutual_best,
                n1_tile, n2_tile):
    """match_sharded's program on tensors: the thresholds 0-d float32, H
    and F (3, 3), loc1 / loc2 given in guided mode; the tiles decided by
    the caller. Every rank returns the full (N1,) result."""
    dev = d1.device
    guided = loc1 is not None
    size = 1 if mesh is None else mesh.size
    n1, n2 = d1.shape[0], d2.shape[0]
    nloc = -(-n1 // size)
    f32 = dict(dtype=torch.float32, device=dev)

    def shard_top2(rank):
        """Rows [r0, r1) of d1 against every column: the rows' and the
        columns' running (best, index, second)."""
        r0, r1 = min(n1, rank * nloc), min(n1, (rank + 1) * nloc)
        m = r1 - r0
        rv = torch.full((m,), -np.inf, **f32)
        rn = torch.full((m,), -np.inf, **f32)
        ri = torch.zeros(m, dtype=torch.int64, device=dev)
        cv = torch.full((n2,), -np.inf, **f32)
        cn = torch.full((n2,), -np.inf, **f32)
        ci = torch.zeros(n2, dtype=torch.int64, device=dev)
        for i0 in range(0, m, n1_tile):
            i1 = min(m, i0 + n1_tile)
            a = d1[r0 + i0:r0 + i1]
            for j0 in range(0, n2, n2_tile):
                j1 = min(n2, j0 + n2_tile)
                dots = descriptor_dots(a, d2[j0:j1])
                if guided:
                    gate = _guided_gate_eager(
                        loc1[r0 + i0:r0 + i1], loc2[j0:j1], H, hdistmax, F,
                        fdistmax)
                    dots = dots.masked_fill_(~gate, -1.0)
                    del gate
                bi, bv, nv = _best_two(dots, 1)
                _merge_top2(rv[i0:i1], ri[i0:i1], rn[i0:i1], bv, bi + j0, nv)
                if mutual_best:
                    bi, bv, nv = _best_two(dots, 0)
                    _merge_top2(cv[j0:j1], ci[j0:j1], cn[j0:j1], bv,
                                bi + (r0 + i0), nv)
                del dots
        return r0, r1, rv, ri, rn, cv, ci, cn

    parts = [shard_top2(rank) for rank in mesh_shards(mesh)]
    if mutual_best:
        cv, ci, cn = (torch.stack([p[k] for p in parts]) for k in (5, 6, 7))
        # the best over the shards is the first of equal maxima (the lowest
        # rows); its second is the best of the other shards' firsts and its
        # own second
        all_cv = all_gather(cv, mesh)
        best = all_cv.argmax(0, keepdim=True)
        ci = all_gather(ci, mesh).gather(0, best)[0]
        own = torch.zeros_like(all_cv, dtype=torch.bool).scatter_(
            0, best, True)
        cn = torch.where(own, all_gather(cn, mesh), all_cv).amax(0)
        cv = all_cv.gather(0, best)[0]
        col_match = torch.where(_accept(cv, cn, distmax, ratiomax) & (cv > 0),
                                ci, -1)
    out = torch.full((len(parts), nloc), -1, dtype=torch.int64, device=dev)
    for k, (r0, r1, rv, ri, rn, *_) in enumerate(parts):
        row_match = torch.where(
            _accept(rv, rn, distmax, ratiomax) & (rv > 0), ri, -1)
        if mutual_best:
            rows = torch.arange(r0, r1, device=dev)
            mutual = col_match[row_match.clamp(0, n2 - 1)] == rows
            row_match = torch.where((row_match >= 0) & mutual, row_match, -1)
        out[k, :r1 - r0] = row_match
    return all_gather(out, mesh).reshape(-1)[:n1]
