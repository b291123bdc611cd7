"""Row-sharded detect + describe: an image split into bands of rows over a
mesh, with halo exchange (counterpart of hessgpu_tpu/parallel/spatial.py).

The reference caps its working dimension at 3200 px and downsamples anything
larger (GlobalUtil.cpp:82, PyramidCU.cpp:153-191). Here an image too tall
for one device is split into row bands, one per shard of a mesh
(parallel/distributed.py: a process group, or n shards in one process on
one device), and each band runs the port's kernels on its rows plus halo
rows fetched from its ring neighbours (exchange_halo, clamp-to-edge at the
global borders):

  * blur per level: the band plus r halo rows, r the filter's radius; the
    rows outside the band are dropped, so every band row is the one-device
    blur's value;
  * downsample2 between octaves;
  * detect_octave on the octave's stack extended by 2 halo rows (the
    response stencil and the 3x3x3 NMS); the halo rows' outputs are dropped
    and global rows 0 and h - 1 masked, as on one device;
  * the detect kernel's gradient maps of the band, extended by `halo` rows
    for the orientation and descriptor windows;
  * one orientation and one descriptor launch over all levels and all
    bands: each band's maps are read in global rows through their row
    origin (ops/gather.LevelMaps).

Octaves stay sharded while each band is even, at least max(32, halo) rows
tall and the octave before was sharded; the later, small octaves are
gathered and computed once (shard 0 reports them). Per shard and level the
list holds max(8, c // n + 8) keypoints (c the one-device level cap); the
global cap and the -topk / -tc1 / -tc2 truncations then apply across the
shards (_global_keep) before the orientation and descriptor work, and the
result is compacted into one FeatureTable like detect_and_describe's.
Membership differs from the one-device run only where a shard's level cap
overflows.

Every octave's shape is the plan's (floor-halved, as on one device; the JAX
package's spatial path keeps ceil-halved odd widths).

On the card an in-process mesh's detect + describe is one captured CUDA
graph (utils/graphs.py) per (H, W, configuration, mesh size, describe):
the sharded pipeline, the level-major gather and the table's assembly -
the counterparts of the JAX package's _build_sharded_fn program and its
jitted _assemble_feature_table. Its host values (the geometry, the
per-shard cap, G) are plain ints that go in the key, and its two
constants (the key levels' sigmas, each level's octave scale) are device
tensors made before the capture (_spatial_constants). A process group's
mesh runs eagerly, and so does every call on the CPU and inside
utils.graphs.disable_graphs(). _sharded_program.clear_cache() frees the
graphs and the constants.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import (SiftConfig, TRUNCATE_KEEP_HIGHEST_LEVELS,
                      TRUNCATE_KEEP_LOWEST_LEVELS, TRUNCATE_TOP_K)
from ..features import FeatureTable
from ..ops import gaussian
from ..ops.compaction import (FeatureList, compact_indices,
                              compact_octave_keypoints)
from ..ops.cuda import conv as kconv
from ..ops.gather import LevelMaps
from ..ops.hessian import hessian_response_and_gradient
from ..ops.keypoint import TYPE_NONE
from ..params import (gaussian_taps, max_features_per_level, octave_shapes,
                      required_octaves)
from ..pyramid import (_CfgKey, _detect_octave, describe_table,
                       orient_table, resolve_device, window_sizes)
from ..utils.graphs import GraphCache, on_graph_route
from .distributed import (DeviceMesh, all_gather, exchange_halo,
                          mesh_shards)

TWO_PI = 2.0 * math.pi
MIN_SHARD_ROWS = 32   # the widest blur (33 taps) reaches 16 rows

# The bytes the captured sharded programs may reserve, the least recently
# used dropped first. A graph's pool holds its call's buffers, about the
# eager call's peak: a 4032x6048 frame's is 5.0-5.1 GB over 1, 2 or 4
# bands (PERF.md, chip_smoke.py's compiled phase), and its three graphs fit
# together.
SPATIAL_GRAPH_BYTES = 16 << 30
_SPATIAL_GRAPHS = GraphCache(SPATIAL_GRAPH_BYTES)


def _image(img, device) -> torch.Tensor:
    dev = resolve_device(device)
    if isinstance(img, np.ndarray):
        img = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    img = img.to(device=dev, dtype=torch.float32)
    if img.ndim != 2:
        raise ValueError(f"expected an (H, W) image, got {tuple(img.shape)}")
    return img


def _bands(img: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This process's bands (len(mesh.shards), H / n, W) of the image."""
    H, W = img.shape
    if H % mesh.size:
        raise ValueError(f"image height {H} is not divisible by the mesh's "
                         f"{mesh.size} shards")
    hl = H // mesh.size
    own = mesh_shards(mesh)
    return img[own.start * hl:own.stop * hl].reshape(len(own), hl, W)


def _gather_rows(bands: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """(k, hl, ...) bands -> the whole (1, n * hl, ...) array."""
    full = all_gather(bands, mesh)
    return full.reshape((1, -1) + tuple(full.shape[2:]))


def _blur_band(block: torch.Tensor, taps, mesh: Optional[DeviceMesh],
               plain: bool) -> torch.Tensor:
    """Separable blur of row bands (k, hl, W): each band with r halo rows,
    the rows outside the band dropped (mesh=None: whole images, the blur's
    own clamp-to-edge)."""
    if not len(taps):
        return block
    blur = kconv.blur_plain if plain else kconv.blur
    if mesh is None:
        return blur(block.contiguous(), taps)
    r = len(taps) // 2
    hl = block.shape[-2]
    return blur(exchange_halo(block, r, mesh), taps)[:, r:r + hl]


def sharded_blur(img, sigma: float, mesh: DeviceMesh,
                 filter_width_factor: float = 4.0, device="cuda",
                 plain: bool = False) -> torch.Tensor:
    """Gaussian blur of a row-sharded image over a one-axis mesh.

    img: (H, W), H divisible by the mesh size (every rank passes all of
    it). Returns the whole blurred (H, W) image on every rank. The halo is
    the filter's radius and may not exceed a band's rows."""
    img = _image(img, device)
    taps = gaussian_taps(sigma, filter_width_factor)
    out = _blur_band(_bands(img, mesh), taps, mesh, plain)
    return _gather_rows(out.contiguous(), mesh)[0]


def sharded_hessian_response(img, sigmas: Sequence[float],
                             norms: Sequence[float], mesh: DeviceMesh,
                             filter_width_factor: float = 4.0,
                             device="cuda", plain: bool = False):
    """Row-sharded scale space of one octave: the Gaussian chain (each
    level's blur with its halo) and the det-of-Hessian response of every
    level (ops.hessian, one halo row). Returns the whole (levels + 1, H, W)
    Gaussian stack and responses on every rank."""
    img = _image(img, device)
    levels = [_bands(img, mesh)]
    for s in sigmas:
        levels.append(_blur_band(
            levels[-1], gaussian_taps(s, filter_width_factor), mesh, plain))
    stack = torch.stack(levels, 1)                      # (k, L, hl, W)
    hl = stack.shape[-2]
    resp, _, _ = hessian_response_and_gradient(
        exchange_halo(stack, 1, mesh), norms, grad_levels=[])
    resp = resp[..., 1:1 + hl, :]
    L, W = stack.shape[1], stack.shape[-1]
    return tuple(all_gather(a.contiguous(), mesh).transpose(0, 1)
                 .reshape(L, -1, W) for a in (stack, resp))


class _Geometry(NamedTuple):
    shapes: List[tuple]
    sharded: List[bool]
    cap: int                 # per shard and level
    full_caps: List[int]     # one device's, per octave
    G: int                   # the global table's capacity
    owin: int
    dwin: int
    halo: int
    single: bool
    MO: int


def _geometry(H: int, W: int, cfg: SiftConfig, n: int,
              describe: bool) -> _Geometry:
    p = cfg.scale_params()
    noct = required_octaves(min(H, W), cfg.min_dim)
    if cfg.num_octaves > 0:
        noct = min(noct, cfg.num_octaves)
    shapes = octave_shapes(H, W, noct)
    owin = dwin = halo = 0
    single, MO = True, 1
    if describe:
        max_sigma = p.key_level_sigma(p.key_levels[-1]) * \
            (p.sigmak if cfg.subpixel else 1.0)
        owin, dwin = window_sizes(cfg, max_sigma)
        # the orientation and descriptor windows must lie in a band and its
        # halo: the widest window's radius plus the subpixel offset
        halo = (max(owin, dwin) - 1) // 2 + 2
        single = cfg.max_orientations <= 1 or cfg.fixed_orientation
        MO = 1 if single else 4
    min_rows = max(MIN_SHARD_ROWS, halo)
    sharded = []
    for (h, _) in shapes:
        # 2n | h keeps every band even for the band-local decimation
        sharded.append(h % (2 * n) == 0 and h // n >= min_rows
                       and (not sharded or sharded[-1]))
    full_caps = [max_features_per_level(h, w, cfg.max_feature_percent,
                                        cfg.max_level_features)
                 for (h, w) in shapes]
    cap = max(max(8, c // n + 8) for c in full_caps)
    G = min(cfg.global_feature_cap, sum(full_caps) * len(p.key_levels))
    return _Geometry(shapes, sharded, cap, full_caps, G, owin, dwin, halo,
                     single, MO)


def _place(t: torch.Tensor, k: int) -> torch.Tensor:
    """A replicated octave's (1, ...) result as the (k, ...) block of this
    process's shards, the first of which is shard 0: shard 0 reports it,
    the others hold zeros."""
    if k == 1:
        return t
    out = t.new_zeros((k,) + tuple(t.shape[1:]))
    out[0] = t[0]
    return out


def _global_keep(valid: torch.Tensor, absr: torch.Tensor, cfg: SiftConfig,
                 mesh: DeviceMesh, G: int) -> torch.Tensor:
    """Cross-shard global cap and truncation mask: the one-device pipeline's
    stages (the first G valid slots in level-major raster order, then
    -topk / -tc1 / -tc2) over every shard's lists. The (shard, level, slot)
    tables are all_gathered - a few KB - so every shard computes the same
    mask and keeps its own part.

    valid, absr: (k, L, cap) this process's shards' lists. Returns (k, L,
    cap) bool."""
    k, L, cap = valid.shape
    n = mesh.size
    # (n, L, cap) -> level-major, shard-major, slot-major: the global
    # raster order within each level (shard s covers the rows below s - 1)
    av = all_gather(valid, mesh).transpose(0, 1).reshape(-1)
    aa = all_gather(absr, mesh).transpose(0, 1).reshape(-1)
    rank = torch.cumsum(av, 0, dtype=torch.int32) - 1
    keep = av & (rank < G)

    kf = cfg.feature_count_threshold
    if kf > 0:
        if cfg.truncate_method == TRUNCATE_TOP_K:
            ab = torch.where(keep, aa, torch.full_like(aa, -math.inf))
            kk = min(kf, ab.shape[0])
            vk = torch.topk(ab, kk).values[-1]
            above = ab > vk
            n_above = above.sum(dtype=torch.int32)
            ties = ab == vk
            tie_rank = torch.cumsum(ties, 0, dtype=torch.int32)
            keep &= above | (ties & (tie_rank <= (kk - n_above)))
        elif cfg.truncate_method in (TRUNCATE_KEEP_LOWEST_LEVELS,
                                     TRUNCATE_KEEP_HIGHEST_LEVELS):
            counts = keep.reshape(L, -1).sum(1, dtype=torch.int64)
            if cfg.truncate_method == TRUNCATE_KEEP_LOWEST_LEVELS:
                keep_level = (torch.cumsum(counts, 0) - counts) < kf
            else:
                suffix = counts.sum() - (torch.cumsum(counts, 0) - counts)
                keepable = suffix <= kf
                first = torch.where(keepable.any(),
                                    keepable.to(torch.int64).argmax(),
                                    torch.full_like(counts[0], L - 1))
                keep_level = torch.arange(L, device=counts.device) >= first
            keep &= keep_level.repeat_interleave(n * cap)
    own = mesh_shards(mesh)
    return keep.reshape(L, n, cap)[:, own.start:own.stop].transpose(0, 1)


class _Table(NamedTuple):
    """A (k, S) keypoint table in the shape orient_table / describe_table
    read."""
    x: torch.Tensor
    y: torch.Tensor
    sigma: torch.Tensor
    theta: torch.Tensor
    valid: torch.Tensor
    level_id: torch.Tensor


class _SpatialConstants(NamedTuple):
    """Device constants of one (octave count, configuration, device)."""
    key_sigmas: torch.Tensor   # f32 (NK,): the key levels' sigmas
    level_scale: torch.Tensor  # f32 (1, L, 1): 2^octave of each level


@functools.lru_cache(maxsize=64)
def _spatial_constants(noct: int, key: _CfgKey,
                       device: torch.device) -> _SpatialConstants:
    """Made at a key's first call and reused after (never inside a graph's
    capture, where a copy from host memory raises); a graph's function
    keeps its own alive."""
    p = key.cfg.scale_params()
    nk = len(p.key_levels)
    return _SpatialConstants(
        key_sigmas=torch.tensor([p.key_level_sigma(kl) for kl in
                                 p.key_levels], dtype=torch.float32,
                                device=device),
        level_scale=torch.tensor(
            [float(1 << (li // nk)) for li in range(noct * nk)],
            device=device)[None, :, None])


def _sharded_impl(img: torch.Tensor, cfg: SiftConfig, mesh: DeviceMesh,
                  geo: _Geometry, consts: _SpatialConstants, describe: bool,
                  plain: bool):
    """The sharded pipeline on an (H, W) image on its device, H divisible
    by the mesh size. Returns (res, counts): res a dict of (k, L, S) leaves
    for this process's shards (S = cap * MO slots per shard and level; desc
    (k, L, S, D) when describing), counts the per-shard keypoints per level
    (n, L) before the global cap."""
    own = mesh_shards(mesh)
    k, first = len(own), own.start == 0
    p = cfg.scale_params()
    nk = len(p.key_levels)
    lds = p.level_ds - p.level_min
    down = kconv.downsample2_plain if plain else kconv.downsample2
    taps_init = gaussian_taps(p.initial_blur_sigma(0), p.filter_width_factor) \
        if p.initial_blur_sigma(0) > 0 else ()
    taps_skip = gaussian_taps(p.octave_restart_sigma(),
                              p.filter_width_factor) \
        if p.octave_restart_sigma() > 0 else ()
    taps_inc = gaussian.chain_taps(p)
    sigmas = consts.key_sigmas

    lists: List[FeatureList] = []
    grads, rots, row0s, steps, heights = [], [], [], [], []
    base = _bands(img, mesh) if geo.sharded[0] else img[None]
    if taps_init:
        base = _blur_band(base, taps_init, mesh if geo.sharded[0] else None,
                          plain)
    stack = None
    for o, (ho, wo) in enumerate(geo.shapes):
        shd = geo.sharded[o]
        if o > 0 and (first or geo.sharded[o - 1]):
            base = down(stack[:, lds])
            if geo.sharded[o - 1] and not shd:
                base = _gather_rows(base, mesh)
            base = base[..., :ho, :wo]
        if not shd and not first:
            # a replicated octave: shard 0 reports it, this process holds
            # no shard 0 (a group's other ranks) and computes nothing
            z = torch.zeros((k, nk, geo.cap), device=img.device)
            lists.append(FeatureList(z, z, z, z, z, z.to(torch.int32),
                                     z.to(torch.bool)))
            for acc in (grads, rots):
                acc.append(torch.zeros((k, nk, 1, wo), device=img.device))
            row0s.append(0), steps.append(0), heights.append(ho)
            continue
        bmesh = mesh if shd else None
        if taps_skip:
            base = _blur_band(base, taps_skip, bmesh, plain)
        levels = [base]
        for taps in taps_inc:
            levels.append(_blur_band(levels[-1], taps, bmesh, plain))
        stack = torch.stack(levels, 1)                   # (k|1, L, hl, wo)
        hl = stack.shape[-2]
        if shd:
            ext = exchange_halo(stack, 2, mesh)
            maps, grad, rot = _detect_octave(ext, cfg, plain)
            grow = (torch.arange(own.start, own.stop, device=img.device)
                    [:, None] * hl + torch.arange(hl, device=img.device))
            row_ok = ((grow > 0) & (grow < ho - 1))[:, None, :, None]
            band = lambda a: a[..., 2:2 + hl, :]
            maps = type(maps)(*(band(a) for a in maps))
            maps = maps._replace(valid=maps.valid & row_ok)
            fl = compact_octave_keypoints(maps, sigmas, p.sigmak, geo.cap,
                                          row_offset=grow[:, :1, None])
            if describe:
                grad = exchange_halo(band(grad), geo.halo, mesh)
                rot = exchange_halo(band(rot), geo.halo, mesh)
            row0s.append(own.start * hl - geo.halo)
            steps.append(hl)
        else:
            maps, grad, rot = _detect_octave(stack, cfg, plain)
            fl = compact_octave_keypoints(maps, sigmas, p.sigmak, geo.cap)
            fl = FeatureList(*(_place(a, k) for a in fl))
            grad, rot = (_place(a, k) for a in (grad, rot))
            row0s.append(0)
            steps.append(0)
        heights.append(ho)
        lists.append(fl)
        if describe:
            grads.append(grad.contiguous())
            rots.append(rot.contiguous())

    cat = lambda f: torch.cat([getattr(fl, f) for fl in lists], 1)
    valid = cat("valid")                                   # (k, L, cap)
    L, cap = valid.shape[1], geo.cap
    counts = all_gather(valid.sum(-1, dtype=torch.int32), mesh)
    oss = consts.level_scale
    offset = 0.0 if cfg.lowe_origin else 0.5
    x, y, sig, resp, ft = (cat(f) for f in ("x", "y", "sigma", "response",
                                            "ftype"))
    if not describe:
        res = dict(x=torch.where(valid, oss * (x - 0.5) + offset, 0.0),
                   y=torch.where(valid, oss * (y - 0.5) + offset, 0.0),
                   sigma=oss * sig, response=resp,
                   ftype=torch.where(valid, ft, TYPE_NONE), valid=valid)
        return res, counts

    valid = valid & _global_keep(valid, resp.abs(), cfg, mesh, geo.G)
    lid = torch.arange(L, dtype=torch.int32, device=img.device) \
        .repeat_interleave(cap).expand(k, L * cap).contiguous()
    flat = lambda a: a.reshape(k, L * cap).contiguous()
    table = _Table(flat(x), flat(y), flat(sig), torch.zeros_like(flat(x)),
                   flat(valid), lid)
    lmaps = LevelMaps(tuple(grads), tuple(rots), tuple(row0s), tuple(steps),
                      tuple(heights))
    MO = geo.MO
    if cfg.fixed_orientation:
        thetas = torch.zeros((k, L * cap, MO), device=img.device)
        tvalid = torch.zeros((k, L * cap, MO), dtype=torch.bool,
                             device=img.device)
        tvalid[..., 0] = True
    else:
        ores = orient_table(table, lmaps, cfg, geo.owin, geo.single, plain)
        thetas, tvalid = ores.thetas[..., :MO], ores.valid[..., :MO]
    vslot = (table.valid[..., None] & tvalid).reshape(k, -1)
    rep = lambda a: a.repeat_interleave(MO, dim=-1)
    th = thetas.reshape(k, -1).contiguous()
    if cfg.compute_descriptors:
        dtab = _Table(rep(table.x), rep(table.y), rep(table.sigma), th,
                      vslot, rep(lid))
        desc = describe_table(dtab, lmaps, cfg, geo.dwin, plain)
    else:
        desc = torch.zeros((k, L * cap * MO, cfg.descriptor_dim),
                           device=img.device)
    ossr = rep(oss.expand(k, L, cap).reshape(k, -1))
    res = dict(
        x=torch.where(vslot, ossr * (rep(table.x) - 0.5) + offset, 0.0),
        y=torch.where(vslot, ossr * (rep(table.y) - 0.5) + offset, 0.0),
        sigma=torch.where(vslot, ossr * rep(table.sigma), 0.0),
        theta=torch.where(vslot, torch.remainder(TWO_PI - th, TWO_PI), 0.0),
        response=torch.where(vslot, rep(flat(resp)), 0.0),
        ftype=torch.where(vslot, rep(flat(ft)), TYPE_NONE),
        valid=vslot, desc=desc)
    res = {key: v.reshape((k, L, cap * MO) + tuple(v.shape[2:]))
           for key, v in res.items()}
    return res, counts


def _level_major(a: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """(k, L, S, ...) per-shard leaves -> (L, n * S, ...) level-major,
    shard-major."""
    full = all_gather(a.contiguous(), mesh)
    return full.transpose(0, 1).flatten(1, 2)


def _sharded_program(img, cfg: SiftConfig, mesh: DeviceMesh,
                     describe: bool, device, plain: bool):
    """The sharded pipeline with its level-major gather and, describing,
    the table's assembly: (out, aux), out the FeatureTable or the
    keypoints' level-major dict. On an in-process mesh with the card's
    image (and plain False) one graph per (H, W, cfg, mesh size, describe);
    elsewhere, and inside disable_graphs(), its eager body."""
    if cfg.first_octave != 0:
        raise ValueError("the row-sharded path takes octave 0 at the "
                         "image's own size: first_octave must be 0")
    img = _image(img, device)
    H, W = img.shape
    n = mesh.size
    if H % n:
        raise ValueError(f"image height {H} is not divisible by the mesh's "
                         f"{n} shards")
    geo = _geometry(H, W, cfg, n, describe)
    key = _CfgKey(cfg)
    consts = _spatial_constants(len(geo.shapes), key, img.device)
    G_out = geo.G if geo.single else \
        int(geo.G * cfg.expansion_factor + 7) // 8 * 8

    def body(x, consts=consts):
        res, counts = _sharded_impl(x, cfg, mesh, geo, consts, describe,
                                    plain)
        res = {name: _level_major(v, mesh) for name, v in res.items()}
        return (_assemble_feature_table(res, G_out) if describe else res,
                counts)

    if not plain and on_graph_route(_SPATIAL_GRAPHS, img, mesh):
        out, counts = _SPATIAL_GRAPHS((H, W, key, n, describe), body, img)
    else:
        out, counts = body(img)
    aux = {"shard_level_counts": counts, "level_cap": geo.cap,
           "full_level_caps": geo.full_caps, "sharded_octaves": geo.sharded}
    return out, aux


def _clear_spatial_cache() -> None:
    _SPATIAL_GRAPHS.clear()
    _spatial_constants.cache_clear()


_sharded_program.clear_cache = _clear_spatial_cache


def sharded_detect_keypoints(img, cfg: SiftConfig, mesh: DeviceMesh,
                             device="cuda", plain: bool = False) -> dict:
    """Multi-octave keypoint detection on a row-sharded image (H divisible
    by the mesh size; every rank passes all of it).

    Returns a dict of (L, n * cap) tensors - x, y, sigma (image frame),
    response, ftype, valid - level-major as on one device, shard-major
    within a level (replicated octaves report on shard 0), the same on
    every rank. On the card an in-process mesh replays one graph of the
    whole call (the module's docstring); a process group's runs eagerly."""
    return _sharded_program(img, cfg, mesh, False, device, plain)[0]


def sharded_detect_and_describe(img, cfg: SiftConfig, mesh: DeviceMesh,
                                device="cuda", plain: bool = False,
                                with_aux: bool = False):
    """Full detect + describe on a row-sharded image: the replacement for
    the reference's -maxd ceiling (GlobalUtil.cpp:82).

    img: (H, W) float32 in [0, 1], H divisible by the mesh size (every rank
    passes all of it). Returns the FeatureTable detect_and_describe gives
    (capacity G, or G * expansion_factor after multi-orientation
    expansion), the same on every rank; equal to the one-device table
    unless a shard's level cap overflows. with_aux adds a dict: the
    per-shard keypoint counts per level (n, L) before the global cap,
    the per-shard level cap, the one-device level caps per octave and
    which octaves were sharded.
    device="cuda" without a card raises; plain=True runs the kernels'
    plain PyTorch versions (a check, not a fallback). On the card an
    in-process mesh replays one graph of the whole call, the table's
    assembly included (the module's docstring); a process group's mesh
    runs eagerly."""
    table, aux = _sharded_program(img, cfg, mesh, True, device, plain)
    return (table, aux) if with_aux else table


def _assemble_feature_table(res: dict, G: int) -> FeatureTable:
    """Compact the (L, S) level-major slot dict into one FeatureTable of G
    slots: the same relative order as the one-device table after the
    multi-orientation expansion."""
    L, S = res["valid"].shape
    G = min(G, L * S)
    src, slot_valid, _ = compact_indices(res["valid"].reshape(-1), G)
    lid = torch.arange(L, dtype=torch.int32, device=src.device) \
        .repeat_interleave(S)

    def take(a, fill=0):
        g = a.reshape(-1)[src]
        return torch.where(slot_valid, g, torch.full_like(g, fill))

    desc = res["desc"].reshape(L * S, -1)[src]
    return FeatureTable(
        x=take(res["x"]), y=take(res["y"]), sigma=take(res["sigma"]),
        theta=take(res["theta"]), response=take(res["response"]),
        level=torch.where(slot_valid, lid[src], 0),
        ftype=take(res["ftype"]), valid=slot_valid,
        desc=torch.where(slot_valid[:, None], desc, 0.0))
