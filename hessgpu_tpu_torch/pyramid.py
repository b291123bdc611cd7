"""Detect + describe pipeline: Gaussian pyramid -> fused detection ->
per-octave compaction -> global table -> orientations -> multi-orientation
expansion -> descriptors -> image coordinates (counterpart of
hessgpu_tpu/pyramid.py).

The batch dimension is written out: every stage takes (B, ...) tensors and
run_pipeline is run_pipeline_batched at B = 1. On CUDA tensors the dense
and the per-keypoint stages run the hand-written kernels (ops/cuda); on CPU
tensors their plain PyTorch versions. On the card the compaction writes the
global table through kernels too (ops/cuda/compact.py); truncation and
orientation expansion are tensor code with static shapes.

Every SiftConfig runs, both detector personalities, the upsampled first
octave (first_octave < 0, DoG) and both pyramid schedules (conv_mode "chain"
and "direct").

run_pipeline_jit is the counterpart of the JAX package's jitted entry: on a
CUDA tensor it replays one captured CUDA graph per (plan, configuration,
batch size, device) (utils/graphs.py), which launches the same kernels in
the same order as run_pipeline_batched, the eager body it captures. The
values the pipeline would copy from the host on every call (the global
table's level ids, the key levels' sigmas) are device constants made once
per (plan, configuration, device), before any capture.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from .config import (SiftConfig, TRUNCATE_KEEP_HIGHEST_LEVELS,
                     TRUNCATE_KEEP_LOWEST_LEVELS, TRUNCATE_TOP_K)
from .features import FeatureTable
from .ops import gaussian
from .ops.compaction import (GlobalTable, compact_octave_keypoints,
                             compact_sorted)
from .ops.cuda import compact as kcompact
from .ops.cuda import conv as kconv
from .ops.cuda import detect as kdetect
from .ops.cuda import patch as kpatch
from .ops.descriptor import descriptor_window_size, finalize_descriptors
from .ops.gather import LevelMaps
from .ops.hessian import _grad_rot
from .ops.resize import rgb_to_gray, to_float, upsample
from .params import (gaussian_taps, max_features_per_level, octave_shapes,
                     required_octaves)
from .utils.graphs import GraphCache, graphs_enabled
from .utils.timing import stage

TWO_PI = 2.0 * math.pi


class PipelinePlan(NamedTuple):
    """Static shape plan for one (H, W) input size."""
    height: int
    width: int
    num_octaves: int
    octave_shapes: Tuple[Tuple[int, int], ...]
    level_caps: Tuple[int, ...]          # per (octave, key_level) capacity
    expanded_caps: Tuple[int, ...]       # after multi-orientation expansion


def make_plan(height: int, width: int, cfg: SiftConfig) -> PipelinePlan:
    """Static octave/capacity layout for an input size: octaves until the
    smaller working dimension reaches min_dim (SiftPyramid.cpp:305-311),
    capped by num_octaves if set."""
    noct = required_octaves(min(height, width), cfg.min_dim)
    if cfg.num_octaves > 0:
        noct = min(noct, cfg.num_octaves)
    shapes = octave_shapes(height, width, noct)
    p = cfg.scale_params()

    caps = []
    ecaps = []
    for (h, w) in shapes:
        cap = max_features_per_level(h, w, cfg.max_feature_percent,
                                     cfg.max_level_features)
        ecap = (int(cap * 1.5) + 7) // 8 * 8
        for _ in p.key_levels:
            caps.append(cap)
            ecaps.append(ecap)
    return PipelinePlan(height, width, noct, tuple(shapes), tuple(caps),
                        tuple(ecaps))


class _CfgKey:
    """Hashable wrapper so SiftConfig (mutable dataclass) can key a cache:
    equal when every field is equal."""

    def __init__(self, cfg: SiftConfig):
        self.cfg = cfg
        self._key = tuple(sorted(
            (k, v) for k, v in cfg.__dict__.items()
        ))

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, _CfgKey) and self._key == other._key


class _PlanConstants(NamedTuple):
    """Device constants of one (plan, configuration, device)."""
    level_ids: torch.Tensor    # i32 (sum of per-octave NK * cap,): the level
    #                            id of each slot of the concatenated lists
    key_sigmas: torch.Tensor   # f32 (NK,): the key levels' sigmas


def _plan_constants(plan: PipelinePlan, cfg: SiftConfig,
                    device) -> _PlanConstants:
    """The pipeline's per-plan constants on `device`, made at the first call
    of a key and reused after (never rebuilt inside a graph capture, where a
    copy from host memory raises)."""
    return _make_plan_constants(plan, _CfgKey(cfg), torch.device(device))


# 64 kept at once, the least recently used dropped first; a captured graph
# keeps its own alive (run_pipeline_jit).
@functools.lru_cache(maxsize=64)
def _make_plan_constants(plan: PipelinePlan, key: _CfgKey,
                         device: torch.device) -> _PlanConstants:
    p = key.cfg.scale_params()
    nk = len(p.key_levels)
    # the global table's input: per octave an (NK, cap) block, level id
    # octave * NK + key index (level-major, as _globalize concatenates)
    lid = np.concatenate([
        np.repeat(o * nk + np.arange(nk), plan.level_caps[o * nk])
        for o in range(plan.num_octaves)])
    return _PlanConstants(
        level_ids=torch.as_tensor(lid, dtype=torch.int32, device=device),
        key_sigmas=torch.tensor(
            [p.key_level_sigma(kl) for kl in p.key_levels],
            dtype=torch.float32, device=device))


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device without a card
    raises: nothing gives way to the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hessgpu_tpu_torch: device='cuda' was asked for but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions")
    return device


# ---------------------------------------------------------------------------
# stage helpers
# ---------------------------------------------------------------------------

def _build_pyramid(imgs: torch.Tensor, plan: PipelinePlan, cfg: SiftConfig,
                   plain: bool = False) -> List[torch.Tensor]:
    """Gaussian stacks (B, L, h, w) for every octave. imgs: (B, H, W) f32.

    Reference: PyramidCU::BuildPyramid (PyramidCU.cpp:1486-1558): initial
    blur, then per octave the incremental chain; the next octave's base is
    the decimated level_ds plane (plus a restart blur in DoG mode).
    conv_mode="direct" blurs every level straight from the octave base
    instead (the JAX package's jnp path, gaussian.build_octave_direct).

    The chain's kernel route writes each octave's base once, into level 0
    of its stack: the initial blur into octave 0's, and each chain's
    decimation epilogue into the next octave's, whose chain then starts from
    it in place. The decimation keeps ceil(h/2) rows, the plan floor-halves
    like the reference (PyramidCU.cpp:150), so the epilogue crops to the
    plan's shape. The restart blur is 0 under every scale schedule
    (level_ds - num_scales == level_min), so it never runs between the two;
    the kernel routes raise if it were not. plain=True calls the kernels'
    plain PyTorch versions one after another instead (a new tensor per
    step)."""
    p = cfg.scale_params()
    direct = cfg.conv_mode != "chain"
    taps_list = gaussian.direct_taps(p) if direct else gaussian.chain_taps(p)
    lds = p.level_ds - p.level_min
    sigma0 = p.initial_blur_sigma(cfg.first_octave)
    if plain:
        def blur(x, sigma):
            if sigma <= 0:
                return x
            return kconv.blur_plain(
                x, gaussian_taps(sigma, p.filter_width_factor))

        build = gaussian.octave_direct_taps if direct \
            else kconv.octave_chain_plain
        octaves: List[torch.Tensor] = []
        base = blur(imgs, sigma0)
        for o in range(plan.num_octaves):
            if o > 0:
                base = kconv.downsample2_plain(octaves[-1][:, lds])
                oh, ow = plan.octave_shapes[o]
                base = base[..., :oh, :ow].contiguous()
                base = blur(base, p.octave_restart_sigma())
            octaves.append(build(base, taps_list))
        return octaves

    if p.octave_restart_sigma() > 0:
        raise NotImplementedError(
            "_build_pyramid: a restart blur between a decimation and the "
            "next octave's chain; the in-place pyramid has none")

    def new_stack(o):
        h, w = plan.octave_shapes[o]
        return torch.empty((imgs.shape[0], p.num_levels, h, w),
                           dtype=torch.float32, device=imgs.device)

    taps0 = gaussian_taps(sigma0, p.filter_width_factor)
    octaves = []
    if direct:
        # one blur launch per level l > 0, from the octave base, written
        # through the output batch stride into level l; level 0 is the base
        # (sigma 0). The blur reads a contiguous base, so the base is a
        # tensor of its own: octave 0's the initial blur, a later octave's
        # the standalone decimation of the previous stack's level lds,
        # cropped to the plan's shape.
        base = kconv.blur(imgs, taps0) if sigma0 > 0 else imgs
        for o in range(plan.num_octaves):
            if o > 0:
                oh, ow = plan.octave_shapes[o]
                base = kconv.downsample2(octaves[-1][:, lds])
                if tuple(base.shape[1:]) != (oh, ow):
                    base = base[..., :oh, :ow].contiguous()
            stack = new_stack(o)
            for level, tp in enumerate(taps_list):
                if len(tp):
                    kconv.blur(base, tp, out=stack[:, level])
                else:
                    stack[:, level] = base
            octaves.append(stack)
        return octaves

    stack = new_stack(0)
    base = imgs
    if sigma0 > 0:
        kconv.blur(imgs, taps0, out=stack[:, 0])
        base = None
    for o in range(plan.num_octaves):
        if o + 1 < plan.num_octaves:
            nxt = new_stack(o + 1)
            kconv.octave_chain_into(stack, taps_list, base=base,
                                    decimate_level=lds, next_base=nxt[:, 0])
        else:
            nxt = None
            kconv.octave_chain_into(stack, taps_list, base=base)
        octaves.append(stack)
        stack, base = nxt, None
    return octaves


def _detect_norms(p, cfg: SiftConfig):
    """Per-level response norms: sigma^4 for the Hessian personality
    (the reference's octave term is deliberately disabled,
    PyramidCU.cpp:1569-1589); unused (1.0) for DoG."""
    if cfg.detector == "hessian":
        return [(p.level_sigma(l) ** 4)
                for l in range(p.level_min, p.level_max + 1)]
    return [1.0] * p.num_levels


def _detect_octave(gauss_oct: torch.Tensor, cfg: SiftConfig,
                   plain: bool = False):
    """Keypoint maps + gradient maps for one octave (B, L, h, w).

    Returns (maps, grad_k, rot_k): KeypointMaps with (B, NK, h, w) leaves
    (row i = key level p.key_levels[i]) and the per-key-level gradient
    magnitude / angle maps (consumed by the orientation and descriptor
    stages)."""
    p = cfg.scale_params()
    fn = kdetect.detect_octave_plain if plain else kdetect.detect_octave
    return fn(gauss_oct, _detect_norms(p, cfg), p.key_levels,
              threshold=p.threshold, edge_threshold=p.edge_threshold,
              subpixel=cfg.subpixel,
              darkness_adaption=cfg.darkness_adaption,
              detector=cfg.detector)


def _recompact(table: GlobalTable, keep: torch.Tensor, cap: int) -> GlobalTable:
    _, outs, slot_valid = compact_sorted(
        keep & table.valid,
        [table.x, table.y, table.sigma, table.theta, table.response,
         table.ftype, table.level_id],
        cap,
    )
    x, y, s, t, r, ft, lid = outs
    return GlobalTable(x=x, y=y, sigma=s, theta=t, response=r, ftype=ft,
                       level_id=lid, valid=slot_valid)


def _topk_mask(table: GlobalTable, k: int) -> torch.Tensor:
    """Selection mask for the k largest |response| (ties by global order).

    Behavior-equivalent to PyramidCU::SelectTopK (PyramidCU.cpp:1881-1989)."""
    absr = torch.where(table.valid, table.response.abs(),
                       torch.full_like(table.response, -math.inf))
    kk = min(k, absr.shape[-1])
    vk = torch.topk(absr, kk, dim=-1).values[..., -1:]
    above = absr > vk
    n_above = above.sum(dim=-1, keepdim=True)
    ties = absr == vk
    tie_rank = torch.cumsum(ties, dim=-1)
    return above | (ties & (tie_rank <= (kk - n_above)))


def _level_trunc_mask(table: GlobalTable, k: int, num_levels: int,
                      keep_lowest: bool) -> torch.Tensor:
    """-tc1/-tc2 level-dropping masks (SiftPyramid.cpp:224-277)."""
    lid = table.level_id.to(torch.int64)
    counts = torch.zeros(lid.shape[:-1] + (num_levels,), dtype=torch.int64,
                         device=lid.device)
    counts.scatter_add_(-1, lid, table.valid.to(torch.int64))
    before = torch.cumsum(counts, dim=-1) - counts
    if keep_lowest:
        keep_level = before < k
    else:
        suffix = counts.sum(dim=-1, keepdim=True) - before
        keepable = suffix <= k
        first_keep = torch.where(
            keepable.any(dim=-1, keepdim=True),
            keepable.to(torch.int64).argmax(dim=-1, keepdim=True),
            num_levels - 1)
        keep_level = torch.arange(num_levels, device=lid.device) >= first_keep
    return torch.gather(keep_level, -1, lid)


def key_level_gradients(gauss_oct: torch.Tensor, cfg: SiftConfig,
                        plain: bool = False):
    """Gradient magnitude / angle maps (B, NK, h, w) of one octave's key
    levels without keeping a detection: on a CUDA tensor the detect kernel
    (it computes them from the same planes), else ops.hessian's gradient."""
    if gauss_oct.is_cuda and not plain:
        _, grad, rot = _detect_octave(gauss_oct, cfg)
        return grad, rot
    kl = list(cfg.scale_params().key_levels)
    grad, rot = _grad_rot(gauss_oct[:, kl])
    return grad.contiguous(), rot.contiguous()


def window_sizes(cfg: SiftConfig, max_sigma: float) -> Tuple[int, int]:
    """Static orientation and descriptor window sizes that cover the support
    of a keypoint of scale max_sigma (level coordinates). The plain versions
    gather windows of this size; the kernels size theirs per keypoint."""
    owin = 2 * int(math.ceil(
        abs(max_sigma) * cfg.orientation_gaussian_factor
        * cfg.orientation_window_factor + 1.0)) + 1
    return owin, descriptor_window_size(max_sigma,
                                        cfg.descriptor_window_factor)


def orient_table(table, maps: LevelMaps, cfg: SiftConfig, owin: int,
                 single: bool, plain: bool = False):
    """Orientation stage over a (B, G) table in level coordinates."""
    fn = kpatch.orientation_plain if plain else kpatch.orientation
    return fn(table.x, table.y, table.sigma, table.valid, table.level_id,
              maps, owin,
              gaussian_factor=cfg.orientation_gaussian_factor,
              window_factor=cfg.orientation_window_factor,
              peak_threshold=cfg.multi_orientation_threshold,
              half_sift=cfg.half_sift, single=single,
              max_peaks=cfg.max_orientations)


def describe_table(table, maps: LevelMaps, cfg: SiftConfig, dwin: int,
                   plain: bool = False) -> torch.Tensor:
    """Descriptor stage over a (B, G) table in level coordinates with
    device-frame theta: (B, G, descriptor_dim), folded and normalized as the
    configuration says."""
    fn = kpatch.descriptor_plain if plain else kpatch.descriptor
    raw = fn(table.x, table.y, table.sigma, table.theta, table.valid,
             table.level_id, maps, dwin,
             window_factor=cfg.descriptor_window_factor)
    return finalize_descriptors(raw, table.valid, cfg.half_sift,
                                cfg.normalized_sift)


def _expand_orientations(table: GlobalTable, thetas: torch.Tensor,
                         ovalid: torch.Tensor, cap: int) -> GlobalTable:
    """One slot per (keypoint, orientation): every field repeated 4x, the
    pairs that hold an orientation compacted to `cap` slots in table order
    (reference ReshapeFeatureListCPU, PyramidCU.cpp:764-791)."""
    mask = (ovalid & table.valid[..., None]).flatten(-2)
    rep = lambda a: a.repeat_interleave(4, dim=-1)
    lidft = (table.level_id << 2) | (table.ftype & 3)
    _, outs, slot_valid = compact_sorted(
        mask,
        [rep(table.x), rep(table.y), rep(table.sigma), thetas.flatten(-2),
         rep(table.response), rep(lidft)],
        cap,
    )
    x, y, sg, th, r, lf = outs
    return GlobalTable(x=x, y=y, sigma=sg, theta=th, response=r,
                       ftype=torch.where(slot_valid, lf & 3, 0),
                       level_id=lf >> 2, valid=slot_valid)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def run_pipeline_batched(imgs: torch.Tensor, plan: PipelinePlan,
                         cfg: SiftConfig, plain: bool = False):
    """Detect + describe for a batch (B, H, W) of f32 [0, 1] frames, on the
    device the tensor lies on.

    Returns (FeatureTable with leading dim B in image coordinates -
    reference download frame x_img = 2^octave * (x_level - 0.5) + offset,
    PyramidCU.cpp:890-903 - and an aux dict with level_counts
    (B, n_levels) and pre_count (B,), the counts before truncation).

    plain=True runs the plain PyTorch versions of the kernels on whatever
    device the tensor lies on (the yardstick of chip_smoke.py).
    """
    if imgs.ndim != 3 or imgs.dtype != torch.float32:
        raise ValueError("run_pipeline_batched: expected (B, H, W) float32, "
                         f"got {tuple(imgs.shape)} {imgs.dtype}")
    if tuple(imgs.shape[1:]) != (plan.height, plan.width):
        raise ValueError(f"images {tuple(imgs.shape[1:])} do not match the "
                         f"plan ({plan.height}, {plan.width})")
    # stages carry the reference's TIMINGS_* bucket names (config.h:17-31)
    # into torch.profiler traces (scripts/torch_profile_main_path.py) and,
    # with tracing on, into the tracer (utils/timing.py), replays included
    with stage("BUILD_PYRAMID", imgs.device):
        octaves = _build_pyramid(imgs.contiguous(), plan, cfg, plain)
    return pipeline_from_octaves(octaves, plan, cfg, plain)


def detect_from_octaves(octaves: List[torch.Tensor], plan: PipelinePlan,
                        cfg: SiftConfig, plain: bool = False):
    """Detection, compaction, global table and truncation. octaves: one
    (B, L, h, w) Gaussian stack per plan octave. Returns (GlobalTable (B, G)
    in level coordinates with theta = 0, LevelMaps of the key levels' gradient
    maps, aux dict) - the input of the per-keypoint stages."""
    p = cfg.scale_params()
    sigma_step = p.sigmak
    nkey = len(p.key_levels)
    device = octaves[0].device
    consts = _plan_constants(plan, cfg, device)

    # ---- detection + per-octave compaction ----------------------------------
    # on the card the kernels of ops/cuda/compact.py: each octave's rows
    # counted here, the table written from the maps below
    compact = compact_octave_keypoints if plain else kcompact.compact_octave
    lists = []
    grads: List[torch.Tensor] = []
    rots: List[torch.Tensor] = []
    for o, gauss_oct in enumerate(octaves):
        with stage("DETECT_KEYPOINTS", device):
            maps, grad, rot = _detect_octave(gauss_oct, cfg, plain)
            grads.append(grad)
            rots.append(rot)
        with stage("GENERATE_FEATURE_LIST", device):
            lists.append(compact(maps, consts.key_sigmas, sigma_step,
                                 plan.level_caps[o * nkey]))

    # ---- global table ---------------------------------------------------------
    # per-(octave, level) counts and the pre-reduction total for the -v
    # report (reference PyramidCU.cpp:1327-1343, SiftPyramid.cpp:219-247)
    G = min(cfg.global_feature_cap, sum(plan.level_caps))
    table_of = kcompact.feature_table_plain if plain \
        else kcompact.feature_table
    with stage("GENERATE_FEATURE_LIST", device):
        table, level_counts, pre_count = table_of(lists, G, consts.level_ids)

    # ---- truncation (reference LimitFeatureCount, SiftPyramid.cpp:201-278)
    if cfg.feature_count_threshold > 0:
        k = cfg.feature_count_threshold
        nl = len(plan.level_caps)
        with stage("FEATURES_REDUCTION", device):
            if cfg.truncate_method == TRUNCATE_TOP_K:
                keep = _topk_mask(table, k)
            elif cfg.truncate_method == TRUNCATE_KEEP_LOWEST_LEVELS:
                keep = _level_trunc_mask(table, k, nl, True)
            elif cfg.truncate_method == TRUNCATE_KEEP_HIGHEST_LEVELS:
                keep = _level_trunc_mask(table, k, nl, False)
            else:
                keep = table.valid
            table = _recompact(table, keep, G)

    aux = {"level_counts": level_counts, "pre_count": pre_count}
    return table, LevelMaps(tuple(grads), tuple(rots)), aux


def pipeline_from_octaves(octaves: List[torch.Tensor], plan: PipelinePlan,
                          cfg: SiftConfig, plain: bool = False):
    """Everything after the pyramid: detection, compaction, global table,
    truncation, orientations, expansion, descriptors, image coordinates.
    octaves: one (B, L, h, w) Gaussian stack per plan octave. Same result as
    run_pipeline_batched, which calls this; tests also feed it the JAX
    package's pyramid."""
    table, level_maps, aux = detect_from_octaves(octaves, plan, cfg, plain)
    p = cfg.scale_params()
    sigma_step = p.sigmak
    s = p.num_scales
    device = table.x.device
    G = table.x.shape[-1]

    # ---- orientations (one pass over all levels) ------------------------------
    max_sigma = p.key_level_sigma(p.key_levels[-1]) * \
        (sigma_step if cfg.subpixel else 1.0)
    owin, dwin = window_sizes(cfg, max_sigma)
    single = cfg.max_orientations <= 1 or cfg.fixed_orientation
    if not cfg.fixed_orientation:     # else theta stays 0: upright
        with stage("COMPUTE_ORIENTATIONS", device):
            ores = orient_table(table, level_maps, cfg, owin, single, plain)
        if single:
            table = table._replace(theta=ores.thetas[..., 0].contiguous())
        else:
            with stage("MULTI_ORIENTATIONS", device):
                G_exp = int(G * cfg.expansion_factor + 7) // 8 * 8
                table = _expand_orientations(table, ores.thetas, ores.valid,
                                             G_exp)

    # ---- descriptors (separate pass) ------------------------------------------
    if cfg.compute_descriptors:
        with stage("COMPUTE_DESCRIPTORS", device):
            desc = describe_table(table, level_maps, cfg, dwin, plain)
    else:
        desc = torch.zeros(table.x.shape + (cfg.descriptor_dim,),
                           dtype=torch.float32, device=device)

    # ---- convert to image coordinates -----------------------------------------
    offset = 0.0 if cfg.lowe_origin else 0.5
    octave_id = torch.div(table.level_id, s, rounding_mode="floor")
    oss = torch.exp2(octave_id.to(torch.float32) + cfg.first_octave)

    out = FeatureTable(
        x=oss * (table.x - 0.5) + offset,
        y=oss * (table.y - 0.5) + offset,
        sigma=oss * table.sigma,
        theta=torch.where(table.valid,
                          torch.remainder(TWO_PI - table.theta, TWO_PI),
                          torch.zeros_like(table.theta)),
        response=table.response,
        level=table.level_id,
        ftype=table.ftype,
        valid=table.valid,
        desc=desc,
    )
    return out, aux


def _unbatch(result):
    table, aux = result
    return (FeatureTable(*(a[0] for a in table)),
            {k: v[0] for k, v in aux.items()})


def run_pipeline(img: torch.Tensor, plan: PipelinePlan, cfg: SiftConfig,
                 plain: bool = False):
    """Detect + describe for one grayscale image (H, W) f32 in [0, 1]: the
    batched pipeline at B = 1 with the batch dimension stripped."""
    return _unbatch(run_pipeline_batched(img[None], plan, cfg, plain))


# The bytes the captured pipelines may reserve, the least recently used
# dropped first. One graph's pool holds its call's buffers (PERF.md,
# chip_smoke.py's compiled phase, for 640x480 at B=16 and B=1 and for a
# 3200-pixel frame).
PIPELINE_GRAPH_BYTES = 4 << 30
_PIPELINE_GRAPHS = GraphCache(PIPELINE_GRAPH_BYTES)


def run_pipeline_jit(imgs: torch.Tensor, plan: PipelinePlan,
                     cfg: SiftConfig):
    """Detect + describe through one compiled program per (plan, cfg, batch,
    device): the counterpart of the JAX package's jitted run_pipeline_jit.

    imgs: (H, W) f32, with run_pipeline's result, or (B, H, W), with
    run_pipeline_batched's. On a CUDA tensor the call replays the CUDA graph
    of run_pipeline_batched for its key, captured at the key's first call,
    and returns fresh tensors; on a CPU tensor, and inside
    utils.graphs.disable_graphs(), it is run_pipeline_batched itself.
    run_pipeline_jit.clear_cache() frees the graphs and their memory."""
    if imgs.ndim == 2:
        return _unbatch(run_pipeline_jit(imgs[None], plan, cfg))
    if not imgs.is_cuda or not graphs_enabled():
        return run_pipeline_batched(imgs, plan, cfg)
    # made outside the capture; the graph keeps its function, and the
    # function these tensors, for as long as it replays them
    consts = _plan_constants(plan, cfg, imgs.device)
    return _PIPELINE_GRAPHS(
        (plan, _CfgKey(cfg)),
        lambda x, _consts=consts: run_pipeline_batched(x, plan, cfg), imgs)


def _clear_pipeline_cache() -> None:
    _PIPELINE_GRAPHS.clear()
    _make_plan_constants.cache_clear()


run_pipeline_jit.clear_cache = _clear_pipeline_cache


def prepare_input(img_np: np.ndarray, cfg: SiftConfig, device="cuda"):
    """Normalize the input and compute the static plan: returns
    (arr (H, W) f32 on `device`, plan, cfg) - the arguments of
    run_pipeline. cfg comes back with first_octave clamped for the Hessian
    personality (reference SiftGPU.cpp:1166-1170)."""
    device = resolve_device(device)
    if cfg.detector == "hessian" and cfg.first_octave < 0:
        cfg = dataclasses.replace(cfg, first_octave=0)
    arr = to_float(torch.as_tensor(np.ascontiguousarray(img_np)).to(device))
    if arr.ndim == 3:
        arr = rgb_to_gray(arr)
    if cfg.first_octave > 0:
        # reference: SampleImageD of the input before octave 0
        step = 1 << cfg.first_octave
        arr = arr[::step, ::step]
    elif cfg.first_octave < 0:
        # octave -1: corner-aligned bilinear upsample (reference
        # SampleImageU, ProgramCU.cu:233-310; DoG personality only)
        arr = upsample(arr, -cfg.first_octave)
    h, w = arr.shape
    return arr.contiguous(), make_plan(h, w, cfg), cfg


def detect_and_describe(img_np: np.ndarray, cfg: SiftConfig, device="cuda"):
    """Host entry: NumPy image (H, W) or (H, W, C), uint8 or float.

    Returns (FeatureTable, aux) on `device` - see run_pipeline_jit."""
    arr, plan, cfg = prepare_input(img_np, cfg, device)
    return run_pipeline_jit(arr, plan, cfg)
