"""Multi-process helpers and map-scale matching (counterpart of
hessgpu_tpu/parallel/distributed.py).

The JAX package spreads work over a device mesh with jax.distributed and
XLA collectives. Here a mesh is a torch.distributed process group in which
each rank holds one device (nccl between cards, gloo between CPU
processes):

  * initialize(): joins the process group (no-op without a coordinator).
  * device_mesh(): the one-axis mesh of the group's ranks.
  * match_sharded(): the all-pairs descriptor matcher with image 1's rows
    split over the mesh's ranks, walked in (row tile, column tile) blocks,
    so that the (N1, N2) dot matrix never exists whole. mesh=None runs it
    on one device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..matcher import _accept, _best_two, _guided_gate, descriptor_dots
from ..pyramid import resolve_device


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
    """A one-axis mesh: `size` ranks of a process group (None: the default
    group), each holding one device; `rank` is this process's place in it."""
    axis_name: str
    size: int
    rank: int
    group: Optional[dist.ProcessGroup] = None


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


def _row_tile(rows: int, n2_tile: int, guided: bool,
              device: torch.device) -> int:
    """Rows per block. A block's float32 dots and, in guided mode, the
    gate's temporaries (about 10 floats per pair) take at most a quarter of
    the card's free memory, or 256 MB on the CPU."""
    if device.type == "cuda":
        budget = torch.cuda.mem_get_info(device)[0] // 4
    else:
        budget = 256 << 20
    per_pair = 40 if guided else 8
    return max(1, min(rows, budget // (per_pair * n2_tile)))


def _merge_top2(v1, i1, v2, bv, bi, nv) -> None:
    """Fold a block's (max, argmax, second) into the running (v1, i1, v2),
    in place. Blocks come in index order, so a tie keeps the earlier index,
    and the global second is the loser of the two firsts or a second."""
    v2.copy_(torch.maximum(torch.minimum(v1, bv), torch.maximum(v2, nv)))
    i1.copy_(torch.where(bv > v1, bi, i1))
    v1.copy_(torch.maximum(v1, bv))


def _all_gather(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """(mesh.size, *x.shape): x from every rank, in rank order."""
    out = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(out, x.contiguous(), group=mesh.group)
    return torch.stack(out)


def match_sharded(d1, d2, mesh: Optional[DeviceMesh] = None,
                  distmax: float = 0.7, ratiomax: float = 0.8,
                  mutual_best: bool = True, loc1=None, loc2=None,
                  H=None, F=None, hdistmax: float = 32.0,
                  fdistmax: float = 16.0, n2_tile: Optional[int] = None,
                  device="cuda") -> torch.Tensor:
    """Pairwise matching of u8 descriptors d1 (N1, 128) against d2
    (N2, 128), NumPy arrays or tensors: the match index per row of d1 or -1,
    int64 (N1,) on `device`, equal to matcher._match_core's.

    mesh: each rank takes a contiguous ceil(N1 / size) of d1's rows (every
    rank passes all of d1, d2 and the locations); the column statistics are
    combined by all_gather, and every rank returns the full (N1,) result.
    mesh=None is one device.

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
    size, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    if not 0 <= rank < size:
        raise ValueError("this process is not a rank of the mesh")
    n1, n2 = d1.shape[0], d2.shape[0]
    if n1 == 0 or n2 == 0:
        return torch.full((n1,), -1, dtype=torch.int64, device=dev)
    nloc = -(-n1 // size)
    r0, r1 = min(n1, rank * nloc), min(n1, (rank + 1) * nloc)
    m = r1 - r0

    if n2_tile is None and nloc * n2 * 4 > 256 * 1024 * 1024:
        n2_tile = 16384
    n2_tile = min(n2_tile or n2, n2)
    n1_tile = _row_tile(m, n2_tile, guided, dev)

    f32 = dict(dtype=torch.float32, device=dev)
    rv, rn = torch.full((m,), -np.inf, **f32), torch.full((m,), -np.inf, **f32)
    ri = torch.zeros(m, dtype=torch.int64, device=dev)
    cv, cn = torch.full((n2,), -np.inf, **f32), torch.full((n2,), -np.inf,
                                                           **f32)
    ci = torch.zeros(n2, dtype=torch.int64, device=dev)
    for i0 in range(0, m, n1_tile):
        i1 = min(m, i0 + n1_tile)
        a = d1[r0 + i0:r0 + i1]
        for j0 in range(0, n2, n2_tile):
            j1 = min(n2, j0 + n2_tile)
            dots = descriptor_dots(a, d2[j0:j1])
            if guided:
                gate = _guided_gate(loc1[r0 + i0:r0 + i1], loc2[j0:j1], H,
                                    hdistmax, F, fdistmax)
                dots = dots.masked_fill_(~gate, -1.0)
                del gate
            bi, bv, nv = _best_two(dots, 1)
            _merge_top2(rv[i0:i1], ri[i0:i1], rn[i0:i1], bv, bi + j0, nv)
            if mutual_best:
                bi, bv, nv = _best_two(dots, 0)
                _merge_top2(cv[j0:j1], ci[j0:j1], cn[j0:j1], bv,
                            bi + (r0 + i0), nv)
            del dots

    none = torch.tensor(-1, dtype=torch.int64, device=dev)
    row_match = torch.where(_accept(rv, rn, distmax, ratiomax) & (rv > 0),
                            ri, none)
    if mutual_best:
        if size > 1:
            # the best over the ranks is the first of equal maxima (the
            # lowest rows); its second is the best of the other ranks' firsts
            # and its own second
            all_cv = _all_gather(cv, mesh)
            best = all_cv.argmax(0, keepdim=True)
            ci = _all_gather(ci, mesh).gather(0, best)[0]
            own = torch.zeros_like(all_cv, dtype=torch.bool).scatter_(
                0, best, True)
            cn = torch.where(own, _all_gather(cn, mesh), all_cv).amax(0)
            cv = all_cv.gather(0, best)[0]
        col_match = torch.where(_accept(cv, cn, distmax, ratiomax) & (cv > 0),
                                ci, none)
        rows = torch.arange(r0, r1, device=dev)
        mutual = col_match[row_match.clamp(0, n2 - 1)] == rows
        row_match = torch.where((row_match >= 0) & mutual, row_match, none)
    if size > 1:
        padded = torch.full((nloc,), -1, dtype=torch.int64, device=dev)
        padded[:m] = row_match
        row_match = _all_gather(padded, mesh).reshape(-1)[:n1]
    return row_match
