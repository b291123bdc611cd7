"""Batched + multi-device detection (counterpart of
hessgpu_tpu/parallel/batch.py).

One device: the whole batch rides the kernels' batch dimension, through
_batched_pipeline (on the card one captured CUDA graph per plan,
configuration and batch size, pyramid.run_pipeline_jit). A mesh
(parallel/distributed.py) splits the batch into contiguous blocks, one per
shard, each run through the same pipeline - the counterpart of the JAX
package's shard_map over a device mesh, and of the reference's one process
per GPU. On the card an in-process mesh's batch is one captured CUDA graph
per plan, configuration, mesh size and batch shape (_sharded_batch_program,
the counterpart of the JAX package's _build_sharded_batch_fn): every
shard's pipeline and the all_gather of their tables. A process group's
shard replays the one-device graph of B / n, with the all_gather outside
it. Shapes are bucketed: images of one (H, W) bucket batch together.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import SiftConfig
from ..features import FeatureTable
from ..pyramid import (PipelinePlan, _CfgKey, _plan_constants, make_plan,
                       resolve_device, run_pipeline_batched, run_pipeline_jit)
from ..utils.graphs import GraphCache, on_graph_route
from ..utils.timing import span
from .distributed import (DeviceMesh, all_gather, device_mesh, local_mesh,
                          mesh_shards)

# The bytes the captured mesh batches may reserve, the least recently used
# dropped first: a graph's pool holds every shard's buffers of one call, as
# the one-device graph of the whole batch does (pyramid.PIPELINE_GRAPH_BYTES;
# PERF.md gives the pools, chip_smoke.py's compiled phase).
MESH_BATCH_GRAPH_BYTES = 4 << 30
_MESH_BATCH_GRAPHS = GraphCache(MESH_BATCH_GRAPH_BYTES)


def _batched_pipeline(imgs: torch.Tensor, plan: PipelinePlan,
                      cfg: SiftConfig) -> FeatureTable:
    """Full pipeline over a batch of grayscale images (B, H, W): the table of
    run_pipeline_jit, the counterpart of the JAX package's jitted
    _batched_pipeline."""
    return run_pipeline_jit(imgs, plan, cfg)[0]


def _sharded_batch_program(imgs: torch.Tensor, plan: PipelinePlan,
                           cfg: SiftConfig, mesh: DeviceMesh) -> FeatureTable:
    """The batch (B, H, W) over the mesh's shards, B divisible by its size:
    the counterpart of the JAX package's _build_sharded_batch_fn program.
    On an in-process mesh with a card's tensor one graph of _sharded_batch
    per (plan, cfg, mesh size) and batch shape, its shards through the eager
    pipeline (a graph holds no other graph); elsewhere, and inside
    disable_graphs(), _sharded_batch with each shard through
    _batched_pipeline. _sharded_batch_program.clear_cache() frees the
    graphs."""
    run = lambda x: _batched_pipeline(x, plan, cfg)      # noqa: E731
    if not on_graph_route(_MESH_BATCH_GRAPHS, imgs, mesh):
        return _sharded_batch(imgs, mesh, run)
    # made outside the capture, kept by the graph's function
    consts = _plan_constants(plan, cfg, imgs.device)
    eager = lambda x: run_pipeline_batched(x, plan, cfg)[0]  # noqa: E731
    return _MESH_BATCH_GRAPHS(
        (plan, _CfgKey(cfg), mesh.size),
        lambda x, _consts=consts: _sharded_batch(x, mesh, eager), imgs)


_sharded_batch_program.clear_cache = _MESH_BATCH_GRAPHS.clear


def _sharded_batch(imgs: torch.Tensor, mesh: DeviceMesh,
                   run) -> FeatureTable:
    """This process's shards' blocks of the batch, each through run, and
    every shard's table gathered in batch order."""
    bl = imgs.shape[0] // mesh.size
    parts = [run(imgs[s * bl:(s + 1) * bl]) for s in mesh_shards(mesh)]
    return FeatureTable(*(
        all_gather(torch.stack(leaves), mesh).flatten(0, 1)
        for leaves in zip(*parts)))


def detect_batch(images, cfg: Optional[SiftConfig] = None,
                 mesh: Optional[DeviceMesh] = None, device="cuda",
                 plain: bool = False) -> FeatureTable:
    """Detect and describe keypoints in a batch of same-sized grayscale
    images.

    images: (B, H, W) float32 in [0, 1], a NumPy array or a tensor (moved to
    `device` if it lies elsewhere), taken as octave 0's input as given: for
    first_octave != 0 the caller resamples (ops.resize.upsample, or a
    strided slice), as with the JAX package's detect_batch.
    mesh: optional one-axis mesh. Shard s runs frames [s * B / n,
    (s + 1) * B / n) through the pipeline (B must be divisible by the mesh
    size; every rank of a group passes the whole batch), and every rank gets
    the full batched table back in batch order (all_gather). mesh=None runs
    the whole batch as one. On the card an in-process mesh replays one graph
    of every shard (_sharded_batch_program); a process group's mesh replays
    the one-device graph of its shard and gathers eagerly.
    device="cuda" without a card raises.
    plain=True runs the kernels' plain PyTorch versions instead, eagerly (a
    check, not a fallback).
    Returns a batched FeatureTable (leading dim B) on `device`: N slots per
    frame, N = global_feature_cap, or expansion_factor times that when a
    keypoint may get several orientations; desc (B, N, descriptor_dim).
    With tracing on (utils.timing.tracing) the call is the span
    `batch.detect_batch`, the parent of its graph's spans.
    """
    with span("batch.detect_batch"):
        cfg = cfg or SiftConfig()
        device = resolve_device(device)
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(
                np.ascontiguousarray(images, np.float32))
        arr = images.to(device=device, dtype=torch.float32)
        if arr.ndim != 3:
            raise ValueError(f"detect_batch: expected (B, H, W), got "
                             f"{tuple(arr.shape)}")
        b, h, w = arr.shape
        plan = make_plan(h, w, cfg)
        if plain:
            run = lambda x: run_pipeline_batched(x, plan, cfg, plain=True)[0]
        else:
            run = lambda x: _batched_pipeline(x, plan, cfg)
        if mesh is None:
            return run(arr)
        if b % mesh.size:
            raise ValueError(f"detect_batch: batch {b} is not divisible by "
                             f"the mesh's {mesh.size} shards")
        if plain:
            return _sharded_batch(arr, mesh, run)
        return _sharded_batch_program(arr, plan, cfg, mesh)


def data_parallel_mesh(n_devices: Optional[int] = None) -> DeviceMesh:
    """One-axis 'batch' mesh over the initialized process group's first
    n_devices ranks (parallel.distributed.device_mesh); local_mesh(n) is the
    in-process mesh of n shards on one device."""
    return device_mesh("batch", n_devices)


def bucket_images(images: List[np.ndarray], buckets: List[tuple]) -> dict:
    """Group images into static (H, W) buckets (padding up).

    Each image is zero-padded to the smallest bucket that fits it (or kept
    at its own size when none does), so images of a bucket batch together.
    Returns {bucket: (stacked array, list of original indices, list of
    original shapes)}.
    """
    out = {}
    for idx, img in enumerate(images):
        h, w = img.shape[:2]
        fit = None
        for bh, bw in sorted(buckets):
            if h <= bh and w <= bw:
                fit = (bh, bw)
                break
        if fit is None:
            fit = (h, w)
        padded = np.zeros(fit, np.float32)
        padded[:h, :w] = img
        out.setdefault(fit, ([], [], []))
        out[fit][0].append(padded)
        out[fit][1].append(idx)
        out[fit][2].append((h, w))
    return {k: (np.stack(v[0]), v[1], v[2]) for k, v in out.items()}


__all__ = ["detect_batch", "data_parallel_mesh", "local_mesh",
           "bucket_images"]
