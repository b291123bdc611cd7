#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hessgpu_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (nvcc); builds the kernels from
hessgpu_tpu_torch/csrc at first use. Exits non-zero, printing no result, if
there is no device, and on any failed phase. Phases, one JSON line each:

  device     the card (name and power limit as nvidia-smi gives them)
  build      seconds to build the kernel library
  kernels    each of the six kernels against its plain PyTorch version on
             the card, at every shape the main path gives it (640x480, B=16,
             five octaves; keypoint tables 16 x 2048 and 16 x 3072) plus an
             odd shape and one smaller than the chain's halo, Hessian and
             DoG, and a 33-tap chain that runs in groups; the pyramid built
             in place as the main path builds it (the blur into level 0 of
             octave 0's stack, each chain's decimation epilogue into the
             next stack's level 0) against the plain chain and the plain
             decimation, cropped, and the standalone decimation beside it;
             the epilogue at every level of the grouped chain and after an
             identity transition; orientation also on
             an all-invalid table and on large supports (sigma x
             LARGE_SIGMA_FACTOR); timings by CUDA events
             (warm-up, then the median of REPS launches, the L2 cache
             flushed and the card kept busy ~1 ms before each)
  main_path  detect_batch on 16 seeded 640x480 textures, through the
             kernels (launch counts read), against the same batch through
             the plain versions on the card, frame 0 against its pinned
             counts and against a CPU run; Hessian then DoG, first in the
             detection-only upright configuration (-sd -ofix), then in the
             default configuration (orientations, descriptors)
  compaction the row-capped compaction of a flooded (16, 3, 480, 640) octave
             on the card against the same on the CPU
  describe   describe_keypoints on the card fed frame 0's own keypoints
  blur       the octave-0 blur's ms beside the card's name and power limit
  {"kernels": [...]}   one entry per kernel: launches on the main path,
             error, times, bound; path_ms and path_bound_ms sum a batch's
             launches (every octave shape); octave_chain adds its time per
             octave with and without the decimation and from a base (the
             standalone contract); downsample2, launched 0 times (fused into
             octave_chain), carries the standalone kernel's times and, as
             path_ms, the epilogue's cost (chain with minus without the
             decimation, summed over the octaves); blur adds its path per detector
             and its times at the smaller octave shapes and with 33 taps;
             detect_octave adds the bounds of every map written densely and
             its first gate's warp shares; orientation and descriptor
             their time on an all-invalid table, orientation on large
             supports
  <name>, <power limit>
  {"ok": true, "device": {...}}
"""

import json
import statistics
import subprocess
import sys
import time

# Keypoints of the seed-0 640x480 texture under SiftConfig(
# compute_descriptors=False, fixed_orientation=True): total and per
# (octave, key level). tests/test_torch_pipeline.py asserts the same
# constants against the JAX package on the CPU.
FRAME0_KEYPOINTS = 139
FRAME0_LEVEL_COUNTS = [22, 18, 19, 19, 22, 22, 13, 3, 1, 0, 0, 0, 0, 0, 0]
# The same frame under the default SiftConfig() (up to 2 orientations per
# keypoint, descriptors): features after the expansion, total and per level.
# tests/test_torch_pipeline_default.py asserts them against the JAX package.
FRAME0_FEATURES = 210
FRAME0_FEATURE_LEVELS = [35, 31, 26, 31, 30, 32, 20, 3, 2, 0, 0, 0, 0, 0, 0]

# Kernel against plain version, per-keypoint stages: sums of 10^2..10^4 terms
# in another order, so smoothed votes and raw descriptor entries agree to
# VOTE_TOL of the keypoint's largest entry (1e-6 * sqrt(N)); descriptors
# after normalization to DESC_TOL absolute.
VOTE_TOL = 2e-5
DESC_TOL = 2e-6
# Float operations per contributing pixel, counted in csrc/patch.cu:
# orientation - offsets 4, distance 3, cut 1, bin 2, weight 14 (expf ~12),
# add 1; descriptor - offsets 4, rotation 6, cell coordinates and support 6,
# Gaussian 16, bin and fraction 5, then 2 x 2 cell weights 12, 2 bin shares
# 3, 8 entries x (multiply, multiply-add) 23.
ORI_FLOPS_PER_PIXEL = 25
DESC_FLOPS_PER_PIXEL = 75
# The orientation kernel on the main path's keypoints with their sigma scaled
# by this: boxes of 5 * 10^3 .. 1.3 * 10^4 pixels, the supports that
# describe_keypoints meets with a user's large keypoints.
LARGE_SIGMA_FACTOR = 6.0

BATCH = 16
HEIGHT, WIDTH = 480, 640
REPS = 10
# Cycles of torch.cuda._sleep (~1 ms) that keep the card busy before a timed
# launch, after the L2 flush: a per-keypoint wrapper takes 0.1-0.2 ms of host
# time to enqueue its launch, longer than the flush keeps the card busy, and
# what it takes beyond that entered the kernel's time.
BUSY_CYCLES = 2_000_000
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12       # float32 outside the tensor cores
# downsample2 is the chain's decimation epilogue on the main path
EXPECTED_LAUNCHES = {"blur": 1, "octave_chain": 5, "downsample2": 0,
                     "detect_octave": 5, "orientation": 0, "descriptor": 0}
EXPECTED_LAUNCHES_DEFAULT = dict(EXPECTED_LAUNCHES, orientation=1,
                                 descriptor=1)
# per-kernel details that the kernels line carries where a kernel has them
DETAIL = ("fused_into", "octave_ms_without_decimation",
          "octave_ms_from_base", "epilogue_ms_by_octave",
          "epilogue_bound_ms_by_octave", "standalone_path_ms",
          "standalone_path_bound_ms", "octave_bound_ms",
          "segment_rows", "path_ms_by_detector", "restart_blurs_by_detector",
          "octave_shape_ms", "ms_33_taps", "empty_table_ms",
          "large_support_ms", "large_support_pixels",
          "octave_ms", "valid_cells", "bound_ms_dense_contract",
          "path_bound_ms_dense_contract", "octave0_warp_share_nms",
          "octave0_warp_share_keypoint")
KERNEL_INFO = {
    "blur": ("hessgpu_tpu_torch/csrc/conv.cu",
             "hessgpu_tpu/ops/pallas/conv.py:381"),
    "octave_chain": ("hessgpu_tpu_torch/csrc/conv.cu",
                     "hessgpu_tpu/ops/pallas/conv.py:310"),
    "downsample2": ("hessgpu_tpu_torch/csrc/conv.cu",
                    "hessgpu_tpu/ops/pallas/conv.py:494"),
    "detect_octave": ("hessgpu_tpu_torch/csrc/detect.cu",
                      "hessgpu_tpu/ops/pallas/detect.py:550"),
    "orientation": ("hessgpu_tpu_torch/csrc/patch.cu",
                    "hessgpu_tpu/ops/pallas/patch.py:893"),
    "descriptor": ("hessgpu_tpu_torch/csrc/patch.cu",
                   "hessgpu_tpu/ops/pallas/patch.py:584"),
}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs one CUDA device", file=sys.stderr)
        sys.exit(2)

    import numpy as np

    from hessgpu_tpu_torch import (SiftConfig, describe_keypoints,
                                   detect_batch, make_plan, to_numpy_trimmed)
    from hessgpu_tpu_torch import pyramid as tpyr
    from hessgpu_tpu_torch.features import FeatureTable
    from hessgpu_tpu_torch.ops import gaussian, hessian
    from hessgpu_tpu_torch.ops.cuda import (build, conv, detect,
                                            launch_counts, patch,
                                            reset_launch_counts)
    from hessgpu_tpu_torch.ops.descriptor import (compute_descriptors_flat,
                                                  finalize_descriptors)
    from hessgpu_tpu_torch.ops.orientation import peaks_from_votes
    from hessgpu_tpu_torch.params import gaussian_taps
    from hessgpu_tpu_torch.sfm.synthetic import texture_frame

    dev = torch.device("cuda", 0)

    # ---- device -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi_line, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # ---- build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.lib()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds=build.build_seconds,
         sources=[p.name for p in build.sources()],
         flags=" ".join(build.NVCC_FLAGS))

    # ---- helpers ----------------------------------------------------------
    flush_buf = torch.empty(512 * 1024 * 1024, dtype=torch.int8, device=dev)

    def time_ms(fn, reps=REPS):
        """Median device time of fn() by CUDA events: 3 warm-up calls, then
        reps timed ones. Before each, a 512 MB write evicts the 50 MB L2 and,
        with a sleep of BUSY_CYCLES, keeps the card busy while the host
        enqueues the launch, so a short kernel's time is its own and not the
        host's time to launch it."""
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            flush_buf.zero_()
            torch.cuda._sleep(BUSY_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def same(a, b):
        """Bit-for-bit equality of two tensors (NaN equals NaN)."""
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.is_floating_point():
            return bool(((a == b) | (a.isnan() & b.isnan())).all())
        return bool(torch.equal(a, b))

    def max_abs(a, b):
        d = (a.double() - b.double()).abs()
        return float(d[~d.isnan()].max()) if d.numel() else 0.0

    errs = {k: 0.0 for k in KERNEL_INFO}      # max abs error per kernel
    detect_errs = {"grad_max_rel_err": 0.0, "rot_max_abs_err": 0.0}
    checked = {k: 0 for k in KERNEL_INFO}     # shapes checked per kernel

    def must_equal(kernel, what, got, want):
        errs[kernel] = max(errs[kernel], max_abs(got.float(), want.float()))
        if not same(got, want):
            fail(f"{kernel}: {what} differs from the plain version at "
                 f"{tuple(got.shape)}: max abs err "
                 f"{max_abs(got.float(), want.float())}")

    def check_detect(stack, cfg, **over):
        p = cfg.scale_params()
        kw = dict(threshold=p.threshold, edge_threshold=p.edge_threshold,
                  subpixel=cfg.subpixel,
                  darkness_adaption=cfg.darkness_adaption,
                  detector=cfg.detector)
        kw.update(over)
        args = (stack, tpyr._detect_norms(p, cfg), p.key_levels)
        gm, ggrad, grot = detect.detect_octave(*args, **kw)
        wm, wgrad, wrot = detect.detect_octave_plain(*args, **kw)
        torch.cuda.synchronize()
        # the kernel's contract: valid everywhere, the payload at the valid
        # cells only (elsewhere its maps hold what torch.empty gave)
        must_equal("detect_octave", "valid", gm.valid, wm.valid)
        for f in ("ftype", "response", "dx", "dy", "ds"):
            must_equal("detect_octave", f"{f} at the valid cells",
                       getattr(gm, f)[wm.valid], getattr(wm, f)[wm.valid])
        # grad: sqrt is IEEE on both sides, 1e-6 relative allows a last-bit
        # difference; rot: atan2f vs torch.atan2 may differ in the last bit,
        # 2e-6 rad
        rel = ((ggrad - wgrad).abs() / wgrad.abs().clamp_min(1e-30)).max()
        rot_err = (grot - wrot).abs().max()
        detect_errs["grad_max_rel_err"] = max(
            detect_errs["grad_max_rel_err"], float(rel))
        detect_errs["rot_max_abs_err"] = max(
            detect_errs["rot_max_abs_err"], float(rot_err))
        errs["detect_octave"] = max(errs["detect_octave"], float(rot_err),
                                    max_abs(ggrad, wgrad))
        if float(rel) > 1e-6:
            fail(f"detect_octave: grad rel err {float(rel)} > 1e-6")
        if float(rot_err) > 2e-6:
            fail(f"detect_octave: rot abs err {float(rot_err)} > 2e-6")
        checked["detect_octave"] += 1
        return int(gm.valid.sum())

    def check_pyramid_kernels(imgs, cfg):
        """Every kernel against its plain version along one pyramid, built
        in place as the main path builds it, each fed the same input (the
        kernel route's own intermediates): the blur into level 0 of octave
        0's stack; each chain from its level 0, decimating level level_ds
        into the next stack's level 0, against the plain chain and the plain
        decimation cropped to the plan's shape; the chain from a base and
        the standalone decimation beside them."""
        p = cfg.scale_params()
        plan = make_plan(imgs.shape[1], imgs.shape[2], cfg)
        taps0 = gaussian_taps(p.initial_blur_sigma(cfg.first_octave),
                              p.filter_width_factor)
        taps_list = gaussian.chain_taps(p)
        lds = p.level_ds - p.level_min

        def new_stack(o):
            return torch.empty((imgs.shape[0], p.num_levels)
                               + plan.octave_shapes[o], device=dev)

        stack = new_stack(0)
        conv.blur(imgs, taps0, out=stack[:, 0])
        must_equal("blur", "into a stack", stack[:, 0],
                   conv.blur_plain(imgs, taps0))
        must_equal("blur", "output", conv.blur(imgs, taps0), stack[:, 0])
        checked["blur"] += 1
        keys = 0
        for o in range(plan.num_octaves):
            base = stack[:, 0].contiguous()
            if o > 0:   # the blur at every octave shape, 13 and 33 taps
                for taps in (taps0, gaussian_taps(5.0)):
                    must_equal("blur", "octave shape", conv.blur(base, taps),
                               conv.blur_plain(base, taps))
                    checked["blur"] += 1
            want = conv.octave_chain_plain(base, taps_list)
            must_equal("octave_chain", "stack from a base",
                       conv.octave_chain(base, taps_list), want)
            nxt = new_stack(o + 1) if o + 1 < plan.num_octaves else None
            if nxt is None:
                conv.octave_chain_into(stack, taps_list)
            else:
                conv.octave_chain_into(stack, taps_list, decimate_level=lds,
                                       next_base=nxt[:, 0])
            must_equal("octave_chain", "stack in place", stack, want)
            groups = conv.octave_chain_groups(base, taps_list)
            if groups != 1:
                fail(f"octave_chain at {tuple(base.shape)} ({cfg.detector}) "
                     f"takes {groups} device launches, not one")
            checked["octave_chain"] += 1
            keys += check_detect(stack, cfg)
            if nxt is not None:
                nh, nw = plan.octave_shapes[o + 1]
                src = stack[:, lds]
                must_equal("downsample2", "the chain's decimation", nxt[:, 0],
                           conv.downsample2_plain(src)[..., :nh, :nw])
                must_equal("downsample2", "standalone", conv.downsample2(src),
                           conv.downsample2_plain(src))
                checked["downsample2"] += 2
            stack = nxt
        return keys

    def check_fused_decimation(x, taps_list, level):
        """octave_chain_into on x's stack, in place, decimating `level` into
        a plane of another stack, against the plain chain and decimation."""
        B, H, W = x.shape
        stack = torch.empty((B, 1 + len(taps_list), H, W), device=dev)
        stack[:, 0] = x
        nxt = torch.empty((B, 2, H // 2, W // 2), device=dev)
        conv.octave_chain_into(stack, taps_list, decimate_level=level,
                               next_base=nxt[:, 0])
        want = conv.octave_chain_plain(x, taps_list)
        must_equal("octave_chain", f"in place, level {level} decimated",
                   stack, want)
        must_equal("downsample2", f"the chain's decimation of level {level}",
                   nxt[:, 0],
                   conv.downsample2_plain(want[:, level])[..., :H // 2,
                                                          :W // 2])
        checked["downsample2"] += 1

    # ---- inputs -----------------------------------------------------------
    t0 = time.perf_counter()
    frames = np.stack([texture_frame(seed, HEIGHT, WIDTH)
                       for seed in range(BATCH)])
    imgs = torch.from_numpy(frames).to(dev)
    slice_cfg = dict(compute_descriptors=False, fixed_orientation=True)
    cfg_h = SiftConfig(**slice_cfg)
    cfg_d = SiftConfig(detector="dog", **slice_cfg)
    input_seconds = time.perf_counter() - t0

    # ---- kernels: correctness ----------------------------------------------
    keys_h = check_pyramid_kernels(imgs, cfg_h)
    keys_d = check_pyramid_kernels(imgs, cfg_d)
    # an odd shape (plan floor-halves, decimation ceil-halves), a tiny one,
    # the widest filter, and the detector's other switches
    rng = np.random.RandomState(7)
    taps_h = gaussian.chain_taps(cfg_h.scale_params())
    odd = torch.from_numpy(rng.rand(2, 101, 75).astype(np.float32)).to(dev)
    tiny = torch.from_numpy(rng.rand(3, 30, 40).astype(np.float32)).to(dev)
    for x in (odd, tiny):
        for cfg in (cfg_h, cfg_d):
            check_pyramid_kernels(x, cfg)
        wide = gaussian_taps(5.0)            # 33 taps, the maximum
        must_equal("blur", "33 taps", conv.blur(x, wide),
                   conv.blur_plain(x, wide))
        checked["blur"] += 1
    # the chain beyond one launch: four 33-tap transitions (cumulative halo
    # 64) run in groups of levels wherever the image is larger than a tile
    # plus that halo, and in one launch where it is smaller than the halo; an
    # identity transition copies its level
    wide_chain = [gaussian_taps(5.0)] * 4
    big = torch.from_numpy(rng.rand(2, 200, 264).astype(np.float32)).to(dev)
    chain_groups = {}
    for x in (big, odd, tiny):
        must_equal("octave_chain", "33-tap chain",
                   conv.octave_chain(x, wide_chain),
                   conv.octave_chain_plain(x, wide_chain))
        chain_groups[str(tuple(x.shape))] = conv.octave_chain_groups(
            x, wide_chain)
        checked["octave_chain"] += 1
        with_identity = [taps_h[0], (), taps_h[1], taps_h[2]]
        must_equal("octave_chain", "identity transition",
                   conv.octave_chain(x, with_identity),
                   conv.octave_chain_plain(x, with_identity))
        checked["octave_chain"] += 1
        # the epilogue in every launch of the groups: a group's base, a
        # level inside a later group, a launch's last level; and the level
        # an identity transition produces
        for level in range(len(wide_chain) + 1):
            check_fused_decimation(x, wide_chain, level)
        check_fused_decimation(x, with_identity, 2)
    if chain_groups[str(tuple(big.shape))] < 2:
        fail(f"the 33-tap chain did not run in groups: {chain_groups}")
    odd_stack_h = conv.octave_chain(odd, taps_h)
    odd_stack_d = conv.octave_chain(odd, gaussian.chain_taps(cfg_d.scale_params()))
    for stack, cfg in ((odd_stack_h, cfg_h), (odd_stack_d, cfg_d)):
        check_detect(stack, cfg, subpixel=False)
        check_detect(stack, cfg, darkness_adaption=True)
        check_detect(stack, cfg, subpixel=False, darkness_adaption=True)
    if keys_h < BATCH * 50 or keys_d < BATCH * 50:
        fail(f"degenerate kernel check: {keys_h} Hessian / {keys_d} DoG "
             "keypoints")

    # ---- per-keypoint kernels: correctness ----------------------------------
    ori_stats = {"cases": 0, "keypoints": 0, "differing_keypoints": 0,
                 "votes_max_rel_err": 0.0}
    desc_stats = {"cases": 0, "keypoints": 0, "raw_max_rel_err": 0.0,
                  "normalized_max_abs_err": 0.0, "norm_max_abs_err": 0.0}

    def keypoint_scene(x, cfg):
        """Table, maps and window sizes as the pipeline hands them to the
        per-keypoint stages for the batch x."""
        plan = make_plan(x.shape[1], x.shape[2], cfg)
        table, maps, _ = tpyr.detect_from_octaves(
            tpyr._build_pyramid(x, plan, cfg), plan, cfg)
        p = cfg.scale_params()
        owin, dwin = tpyr.window_sizes(
            cfg, p.key_level_sigma(p.key_levels[-1]) * p.sigmak)
        return table, maps, owin, dwin

    def check_orientation(t, maps, owin, **mode):
        """The orientation kernel against its plain version on one table.
        Returns (kernel result, plain result, (B, G) mask of the keypoints
        whose orientations differ between the two)."""
        args = (t.x, t.y, t.sigma, t.valid, t.level_id, maps, owin)
        got = patch.orientation(*args, return_votes=True, **mode)
        again = patch.orientation(*args, return_votes=True, **mode)
        want = patch.orientation_plain(*args, **mode)
        torch.cuda.synchronize()
        what = f"orientation {mode} at {tuple(t.x.shape)}"
        for f in ("thetas", "valid", "votes"):
            if not same(getattr(got, f), getattr(again, f)):
                fail(f"{what}: {f} differs between two runs of the kernel")
        inv = ~t.valid
        if bool(got.thetas[inv].any()) or bool(got.valid[inv].any()) \
                or bool(got.votes[inv].any()):
            fail(f"{what}: a slot that is not valid is not zero")
        scale = want.votes.amax(-1, keepdim=True).clamp_min(1e-30)
        rel = float(((got.votes - want.votes).abs() / scale).max())
        if rel > VOTE_TOL:
            fail(f"{what}: votes {rel} away from the plain version's, "
                 f"relative to the keypoint's largest; limit {VOTE_TOL}")
        # Orientations are discrete, so a histogram inside its tolerance can
        # still put a peak on the other side of 0.8 * max, swap two peaks or
        # move floor(frac * 255) by one. The plain peak picker on the
        # kernel's own histograms must give the kernel's orientations bit
        # for bit: then a keypoint that differs between the two routes
        # differs through its histogram alone, which is within VOTE_TOL.
        max_peaks = mode.get("max_peaks", 4)
        single = bool(mode.get("single")) or max_peaks <= 1
        th, ov = peaks_from_votes(got.votes, single=single,
                                  max_peaks=max_peaks)
        th = th.masked_fill(inv[..., None], 0.0)
        ov = ov & t.valid[..., None]
        if not (same(th, got.thetas) and same(ov, got.valid)):
            fail(f"{what}: the plain peak picking on the kernel's histograms "
                 "does not reproduce the kernel's orientations")
        if single:   # full-precision theta: 1e-4 rad is far below a quantum
            differing = ((got.thetas - want.thetas).abs() > 1e-4).any(-1)
        else:
            differing = ((got.valid != want.valid)
                         | (got.thetas != want.thetas)).any(-1)
        ori_stats["cases"] += 1
        ori_stats["keypoints"] += int(t.valid.sum())
        ori_stats["differing_keypoints"] += int(differing.sum())
        ori_stats["votes_max_rel_err"] = max(ori_stats["votes_max_rel_err"],
                                             rel)
        errs["orientation"] = max(errs["orientation"],
                                  max_abs(got.votes, want.votes))
        checked["orientation"] += 1
        return got, want, differing

    def check_descriptor(t, maps, dwin):
        """The descriptor kernel against its plain version on one table with
        device-frame theta. Returns the plain version's count of contributing
        pixels per slot."""
        args = (t.x, t.y, t.sigma, t.theta, t.valid, t.level_id, maps, dwin)
        got = patch.descriptor(*args)
        again = patch.descriptor(*args)
        want, support = compute_descriptors_flat(*args)
        torch.cuda.synchronize()
        what = f"descriptor at {tuple(t.x.shape)}"
        if not same(got, again):
            fail(f"{what}: two runs of the kernel differ")
        if bool(got[~t.valid].any()):
            fail(f"{what}: a slot that is not valid is not zero")
        scale = want.abs().amax((-2, -1), keepdim=True).clamp_min(1e-30)
        rel = float(((got - want).abs() / scale).max())
        if rel > VOTE_TOL:
            fail(f"{what}: raw entries {rel} away from the plain version's, "
                 f"relative to the keypoint's largest; limit {VOTE_TOL}")
        for half in (False, True):
            a = finalize_descriptors(got, t.valid, half, True)
            b = finalize_descriptors(want, t.valid, half, True)
            d = max_abs(a, b)
            desc_stats["normalized_max_abs_err"] = max(
                desc_stats["normalized_max_abs_err"], d)
            if d > DESC_TOL:
                fail(f"{what}: normalized descriptors {d} apart (half_sift="
                     f"{half}); limit {DESC_TOL}")
            some = t.valid & (got != 0).flatten(-2).any(-1)
            nerr = float((a[some].norm(dim=-1) - 1).abs().max())
            desc_stats["norm_max_abs_err"] = max(
                desc_stats["norm_max_abs_err"], nerr)
            if nerr > 1e-5:
                fail(f"{what}: a descriptor's norm is {nerr} from 1")
        desc_stats["cases"] += 1
        desc_stats["keypoints"] += int(t.valid.sum())
        desc_stats["raw_max_rel_err"] = max(desc_stats["raw_max_rel_err"], rel)
        errs["descriptor"] = max(errs["descriptor"], max_abs(got, want))
        checked["descriptor"] += 1
        return support

    # the real tables and maps of the seeded batch, in the default mode (up
    # to 2 orientations), then the expanded table through the descriptor
    cfg_def = {"hessian": SiftConfig(), "dog": SiftConfig(detector="dog")}
    scenes, differing_frames = {}, {}
    for det, cfg in cfg_def.items():
        t, maps, owin, dwin = keypoint_scene(imgs, cfg)
        got, want, differing = check_orientation(
            t, maps, owin, max_peaks=cfg.max_orientations)
        differing_frames[det] = differing.any(-1)
        g_exp = int(t.x.shape[-1] * cfg.expansion_factor + 7) // 8 * 8
        te = tpyr._expand_orientations(t, got.thetas, got.valid, g_exp)
        scenes[det] = dict(table=t, maps=maps, owin=owin, dwin=dwin,
                           expanded=te, ori_support=want.support,
                           desc_support=check_descriptor(te, maps, dwin))
    ori_modes = [dict(single=True), dict(max_peaks=1), dict(max_peaks=2),
                 dict(max_peaks=3), dict(max_peaks=4),
                 dict(max_peaks=2, half_sift=True),
                 dict(single=True, half_sift=True)]
    sc = scenes["hessian"]
    for mode in ori_modes:
        check_orientation(sc["table"], sc["maps"], sc["owin"], **mode)
    # an all-invalid table, and every sigma scaled by LARGE_SIGMA_FACTOR
    for det, cfg in cfg_def.items():
        s = scenes[det]
        tab = s["table"]
        check_orientation(tab._replace(valid=torch.zeros_like(tab.valid)),
                          s["maps"], s["owin"], max_peaks=cfg.max_orientations)
        big = tab._replace(sigma=(tab.sigma * LARGE_SIGMA_FACTOR).contiguous())
        big_win = tpyr.window_sizes(cfg, float(big.sigma[big.valid].max()))[0]
        for mode in (dict(max_peaks=cfg.max_orientations), dict(single=True)):
            _, want, _ = check_orientation(big, s["maps"], big_win, **mode)
        s["large"] = (big, big_win, want.support)
    # an odd-shaped and a tiny batch (a lower threshold, so that the small
    # frames have keypoints), every mode, both personalities
    for shape in ((2, 101, 75), (3, 30, 40)):
        x = torch.from_numpy(np.stack(
            [texture_frame(seed, *shape[1:]) for seed in range(shape[0])]
        )).to(dev)
        for det in ("hessian", "dog"):
            cfg = SiftConfig(detector=det, threshold=0.002)
            t, maps, owin, dwin = keypoint_scene(x, cfg)
            if int(t.valid.sum()) < 3:
                fail(f"degenerate per-keypoint check at {shape} ({det})")
            for mode in ori_modes:
                got, _, _ = check_orientation(t, maps, owin, **mode)
            check_descriptor(
                t._replace(theta=got.thetas[..., 0].contiguous()), maps, dwin)

    # ---- kernels: time, at every shape the main path gives them ------------
    p = cfg_h.scale_params()
    plan = make_plan(HEIGHT, WIDTH, cfg_h)
    taps0 = gaussian_taps(p.initial_blur_sigma(0), p.filter_width_factor)
    taps_list = gaussian.chain_taps(p)
    chain_taps_n = [len(t) for t in taps_list]
    lds = p.level_ds - p.level_min
    L, NK = p.num_levels, len(p.key_levels)
    norms = tpyr._detect_norms(p, cfg_h)
    dkw = dict(threshold=p.threshold, edge_threshold=p.edge_threshold,
               subpixel=True, darkness_adaption=False, detector="hessian")
    octaves = tpyr._build_pyramid(imgs, plan, cfg_h)
    bases = [o[:, 0].contiguous() for o in octaves]

    def bound(nbytes, flops):
        tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        return max(tb, tf), ("bytes" if tb >= tf else "operations")

    timing = {}
    # blur: one launch on the main path, the initial blur. Its library
    # yardstick is one cuDNN convolution with the outer product of the taps
    # over a replicate-padded copy (TF32 by default, so it is held to 2e-3
    # only); timed here, used nowhere in the port.
    n0 = BATCH * HEIGHT * WIDTH
    r0 = len(taps0) // 2
    t0f = torch.tensor(taps0, dtype=torch.float32, device=dev)
    k2d = torch.outer(t0f, t0f)[None, None]

    def blur_library():
        padded = torch.nn.functional.pad(imgs[:, None], (r0, r0, r0, r0),
                                         mode="replicate")
        return torch.nn.functional.conv2d(padded, k2d)[:, 0]

    lib_err = max_abs(blur_library(), conv.blur(imgs, taps0))
    if lib_err > 2e-3:
        fail(f"blur: the library convolution is {lib_err} away")

    def blur_bound(x, taps):
        # reads the planes once, writes them once; 2 passes of `taps`
        # multiply-adds
        return bound(8 * x.numel(), 4 * len(taps) * x.numel())

    def blur_path(cfg):
        """The blur launches of one batch of cfg's main path: the initial
        blur, and a restart blur at every later octave where the scale
        schedule has one (octave_restart_sigma() is 0 for both
        personalities: level_ds - num_scales == level_min). Returns (ms,
        bound ms, restart launches), each launch timed at its own shape."""
        q = cfg.scale_params()
        calls = [(imgs, gaussian_taps(q.initial_blur_sigma(cfg.first_octave),
                                      q.filter_width_factor))]
        if q.octave_restart_sigma() > 0:
            rt = gaussian_taps(q.octave_restart_sigma(), q.filter_width_factor)
            calls += [(b, rt) for b in bases[1:]]
        return (sum(time_ms(lambda: conv.blur(x, t)) for x, t in calls),
                sum(blur_bound(x, t)[0] for x, t in calls), len(calls) - 1)

    blur_h, blur_d = blur_path(cfg_h), blur_path(cfg_d)
    timing["blur"] = dict(
        shape=[BATCH, HEIGHT, WIDTH, len(taps0)],
        ms=time_ms(lambda: conv.blur(imgs, taps0)),
        plain_ms=time_ms(lambda: conv.blur_plain(imgs, taps0)),
        library_ms=time_ms(blur_library), library_max_abs_err=lib_err,
        bound=blur_bound(imgs, taps0),
        path_ms=blur_h[0], path_bound_ms=blur_h[1],
        path_ms_by_detector={"hessian": blur_h[0], "dog": blur_d[0]},
        restart_blurs_by_detector={"hessian": blur_h[2], "dog": blur_d[2]},
        segment_rows=conv.blur_segment_rows(imgs),
        # the same 13 taps at the smaller octave shapes, and the widest
        # filter at the main path's shape
        octave_shape_ms=[time_ms(lambda: conv.blur(b, taps0))
                         for b in bases[1:]],
        ms_33_taps=time_ms(lambda: conv.blur(imgs, gaussian_taps(5.0))))

    # Bounds of the multi-launch kernels, per launch at each octave's shape;
    # a path bound is their sum over the launches of one batch.
    def chain_bound(n, n_dec=0):
        # in place: reads level 0 once, writes the L - 1 levels after it and
        # the n_dec pixels of the decimated plane; per level 2 passes of taps
        return bound(4 * n * L + 4 * n_dec, 4 * sum(chain_taps_n) * n)

    def down_bound(n):
        # standalone: reads the kept quarter of the pixels, writes them
        return bound(8 * n, 0)

    def epilogue_bound(n):
        # fused: the kept pixels are on chip; it writes them
        return bound(4 * n, 0)

    def detect_bound(n, n_valid):
        # reads L Gaussian planes; writes per key level valid (1 byte), grad
        # and rot (4 bytes each) at every pixel and the payload (response,
        # dx, dy, ds, ftype: 20 bytes) at this run's valid cells. About 13
        # float ops per response plane and pixel, 30 per key level and
        # pixel (threshold, gradient, angle), 170 per valid cell (NMS, edge
        # test, 3x3 solve, typing)
        return bound(n * (4 * L + 9 * NK) + 20 * n_valid,
                     n * (13 * L + 30 * NK) + 170 * n_valid)

    def detect_bound_dense(n):
        # the dense contract: all eight maps at every pixel, the whole
        # test at every pixel and key level
        return bound(n * (4 * L + 29 * NK), n * (13 * L + 170 * NK))

    n_oct = [BATCH * h * w for h, w in plan.octave_shapes]
    # the decimated plane of octave o: level 0 of octave o + 1
    n_dec = [BATCH * h * w for h, w in plan.octave_shapes[1:]] + [0]
    chain_ms, nodec_ms, from_base_ms, down_ms = [], [], [], []
    det_ms, det_valid = [], []
    for o, stack in enumerate(octaves):
        # the main path's call, in place into a copy of the octave's stack
        # (level 0 stays, the levels after it are rewritten alike), the
        # decimation into a plane of a stack of the next octave's shape
        work = stack.clone()
        fused = {}
        if o + 1 < len(octaves):
            nxt = torch.empty_like(octaves[o + 1])
            fused = dict(decimate_level=lds, next_base=nxt[:, 0])
        chain_ms.append(time_ms(
            lambda: conv.octave_chain_into(work, taps_list, **fused)))
        nodec_ms.append(time_ms(
            lambda: conv.octave_chain_into(work, taps_list)))
        from_base_ms.append(time_ms(
            lambda: conv.octave_chain(bases[o], taps_list)))
        det_valid.append(int(detect.detect_octave(
            stack, norms, p.key_levels, **dkw)[0].valid.sum()))
        det_ms.append(time_ms(
            lambda: detect.detect_octave(stack, norms, p.key_levels, **dkw)))
        if o + 1 < len(octaves):
            down_ms.append(time_ms(
                lambda: conv.downsample2(stack[:, lds])))
        del work, fused

    def chain_plain_0():
        # what the plain route does for octave 0: the chain, then the
        # decimation of level level_ds, cropped, as the next base
        s0 = conv.octave_chain_plain(bases[0], taps_list)
        h1, w1 = plan.octave_shapes[1]
        return conv.downsample2_plain(s0[:, lds])[..., :h1, :w1].contiguous()

    timing["octave_chain"] = dict(
        shape=list(octaves[0].shape), ms=chain_ms[0], octave_ms=chain_ms,
        path_ms=sum(chain_ms), octave_ms_without_decimation=nodec_ms,
        octave_ms_from_base=from_base_ms,
        plain_ms=time_ms(chain_plain_0),
        library_ms=None, bound=chain_bound(n0, n_dec[0]),
        octave_bound_ms=[chain_bound(n, d)[0] for n, d in zip(n_oct, n_dec)],
        path_bound_ms=sum(chain_bound(n, d)[0] for n, d in zip(n_oct, n_dec)))
    src0 = octaves[0][:, lds]
    n_down = [BATCH * ((h + 1) // 2) * ((w + 1) // 2)
              for h, w in plan.octave_shapes[:-1]]
    epilogue_ms = [a - b for a, b in zip(chain_ms[:-1], nodec_ms[:-1])]
    timing["downsample2"] = dict(
        fused_into="octave_chain",
        shape=list(src0.shape), ms=down_ms[0], octave_ms=down_ms,
        standalone_path_ms=sum(down_ms),
        standalone_path_bound_ms=sum(down_bound(n)[0] for n in n_down),
        epilogue_ms_by_octave=epilogue_ms,
        epilogue_bound_ms_by_octave=[epilogue_bound(n)[0]
                                     for n in n_dec[:-1]],
        path_ms=sum(epilogue_ms),
        path_bound_ms=sum(epilogue_bound(n)[0] for n in n_dec[:-1]),
        plain_ms=time_ms(lambda: conv.downsample2_plain(src0)),
        # the one PyTorch call that computes the same function
        library_ms=time_ms(lambda: src0[..., ::2, ::2].contiguous()),
        bound=down_bound(n_down[0]))

    def detect_gate_shares(stack):
        """The kernel's first gate on one octave: the share of warp passes
        (32 adjacent columns of one row, one key level) with a lane inside
        the border whose |response| passes the threshold - they run the
        NMS - and the share that holds a keypoint. A function, so that its
        temporaries are gone before the main path's peak memory is read."""
        def warp_share(m):
            seg = torch.nn.functional.pad(m, (0, (-m.shape[-1]) % 32))
            return float(seg.reshape(m.shape[:-1] + (-1, 32)).any(-1)
                         .float().mean())

        valid = detect.detect_octave(stack, norms, p.key_levels,
                                     **dkw)[0].valid
        resp = hessian.hessian_response_and_gradient(
            stack, norms, grad_levels=p.key_levels)[0][:, p.key_levels]
        interior = torch.zeros(resp.shape[-2:], dtype=torch.bool, device=dev)
        interior[1:-1, 1:-1] = True
        thr0 = 0.8 * p.threshold if dkw["subpixel"] else p.threshold
        return warp_share(interior & (resp.abs() > thr0)), warp_share(valid)

    share_nms, share_keypoint = detect_gate_shares(octaves[0])
    timing["detect_octave"] = dict(
        shape=list(octaves[0].shape), ms=det_ms[0], octave_ms=det_ms,
        path_ms=sum(det_ms),
        plain_ms=time_ms(lambda: detect.detect_octave_plain(
            octaves[0], norms, p.key_levels, **dkw)),
        library_ms=None, valid_cells=det_valid,
        bound=detect_bound(n0, det_valid[0]),
        path_bound_ms=sum(detect_bound(n, v)[0]
                          for n, v in zip(n_oct, det_valid)),
        bound_ms_dense_contract=detect_bound_dense(n0)[0],
        path_bound_ms_dense_contract=sum(detect_bound_dense(n)[0]
                                         for n in n_oct),
        octave0_warp_share_nms=share_nms,
        octave0_warp_share_keypoint=share_keypoint)
    # the per-keypoint kernels at the main path's tables. Bound: each valid
    # keypoint's contributing pixels read once from both maps, the table read
    # once, the outputs written once; operations per contributing pixel as
    # counted in the kernels.
    def sum_int(a):
        return int(a.sum(dtype=torch.int64))

    t, maps, te = sc["table"], sc["maps"], sc["expanded"]
    ori_args = (t.x, t.y, t.sigma, t.valid, t.level_id, maps, sc["owin"])
    ori_kw = dict(max_peaks=cfg_def["hessian"].max_orientations)
    n_ori, px_ori = t.x.numel(), sum_int(sc["ori_support"])
    ori_none = ori_args[:3] + (torch.zeros_like(t.valid),) + ori_args[4:]
    big, big_win, big_support = sc["large"]
    ori_big = (big.x, big.y, big.sigma, big.valid, big.level_id, maps,
               big_win)
    timing["orientation"] = dict(
        shape=list(t.x.shape),
        ms=time_ms(lambda: patch.orientation(*ori_args, **ori_kw)),
        empty_table_ms=time_ms(lambda: patch.orientation(*ori_none,
                                                         **ori_kw)),
        large_support_ms=time_ms(lambda: patch.orientation(*ori_big,
                                                           **ori_kw)),
        large_support_pixels=sum_int(big_support),
        plain_ms=time_ms(lambda: patch.orientation_plain(*ori_args, **ori_kw),
                         reps=3),
        library_ms=None, valid_keypoints=sum_int(t.valid),
        support_pixels=px_ori,
        bound=bound(8 * px_ori + n_ori * (17 + 20),
                    ORI_FLOPS_PER_PIXEL * px_ori))
    desc_args = (te.x, te.y, te.sigma, te.theta, te.valid, te.level_id, maps,
                 sc["dwin"])
    n_desc, px_desc = te.x.numel(), sum_int(sc["desc_support"])
    # the same table with every slot marked not valid: what the walk over
    # the slots and the zeros cost
    no_slot = torch.zeros_like(te.valid)
    empty_args = desc_args[:4] + (no_slot,) + desc_args[5:]
    if bool(patch.descriptor(*empty_args).any()):
        fail("descriptor: an all-invalid table does not give zeros")
    timing["descriptor"] = dict(
        shape=list(te.x.shape),
        ms=time_ms(lambda: patch.descriptor(*desc_args)),
        empty_table_ms=time_ms(lambda: patch.descriptor(*empty_args)),
        plain_ms=time_ms(lambda: patch.descriptor_plain(*desc_args), reps=3),
        library_ms=None, valid_keypoints=sum_int(te.valid),
        support_pixels=px_desc,
        bound=bound(8 * px_desc + n_desc * (21 + 512),
                    DESC_FLOPS_PER_PIXEL * px_desc))
    for name in ("orientation", "descriptor"):
        timing[name]["path_ms"] = timing[name]["ms"]
    for name in ("orientation", "descriptor"):   # one launch a batch
        timing[name]["path_bound_ms"] = timing[name]["bound"][0]
    emit("kernels",
         max_abs_err=errs, detect=detect_errs,
         exact=["blur", "octave_chain", "downsample2",
                "detect_octave: valid; ftype response dx dy ds at the "
                "valid cells"],
         tolerances={"grad_rel": 1e-6, "rot_abs": 2e-6,
                     "votes_and_raw_descriptor_rel": VOTE_TOL,
                     "normalized_descriptor_abs": DESC_TOL},
         orientation=ori_stats, descriptor=desc_stats,
         deterministic=["orientation", "descriptor"],
         keypoints_checked={"hessian": keys_h, "dog": keys_d},
         chain_device_launches_33_taps=chain_groups,
         empty_table_ms={k: timing[k]["empty_table_ms"]
                         for k in ("orientation", "descriptor")},
         shapes_checked=checked,
         timing_ms={k: {kk: vv for kk, vv in v.items() if kk != "bound"}
                    for k, v in timing.items()},
         reps=REPS, l2_flushed=True, busy_cycles=BUSY_CYCLES)

    # ---- compaction: the per-row candidate cap on the card -------------------
    def check_row_cap():
        """compact_octave_keypoints of a flooded (16, 3, 480, 640) octave on
        the card against the same on the CPU: key level 0 has rows of 214
        candidates (the cap keeps 32), level 1 sparse cells only, level 2
        so many capped rows that the level cap binds too. Every field but
        sigma bit for bit. A function, so that its maps are gone before the
        main path's peak memory is read."""
        from hessgpu_tpu_torch.ops.compaction import (_row_cap,
                                                      compact_octave_keypoints)
        from hessgpu_tpu_torch.ops.keypoint import KeypointMaps
        g = np.random.RandomState(9)
        shape = (BATCH, 3, HEIGHT, WIDTH)
        valid = g.rand(*shape) < 0.002
        valid[:, 0, ::37, ::3] = True
        valid[:, 2, ::5, ::2] = True
        f = lambda: torch.from_numpy(
            g.rand(*shape).astype(np.float32) * 1.9 - 0.95)
        cpu_maps = KeypointMaps(
            valid=torch.from_numpy(valid), response=f(), dx=f(), dy=f(),
            ds=f(), ftype=torch.from_numpy(g.randint(0, 3, shape)
                                           .astype(np.int32)))
        cap = plan.level_caps[0]
        sig = [p.key_level_sigma(k) for k in p.key_levels]
        want = compact_octave_keypoints(cpu_maps, sig, p.sigmak, cap)
        got = compact_octave_keypoints(
            KeypointMaps(*(a.to(dev) for a in cpu_maps)), sig, p.sigmak, cap)
        torch.cuda.synchronize()
        for fld in ("valid", "x", "y", "theta", "response", "ftype"):
            if not same(getattr(got, fld).cpu(), getattr(want, fld)):
                fail(f"row-capped compaction: {fld} differs between the card "
                     "and the CPU")
        # sigma = level sigma * step**ds: pow may differ in the last bit
        # between the two devices
        sig_err = float(((got.sigma.cpu() - want.sigma).abs()
                         / want.sigma.abs().clamp_min(1e-30)).max())
        if sig_err > 1e-6:
            fail(f"row-capped compaction: sigma {sig_err} apart (rel)")
        kpr = min(WIDTH, _row_cap(WIDTH))
        expect = np.minimum(valid.sum(-1), kpr).sum(-1).clip(max=cap)
        counts = want.count().numpy()
        if not (counts == expect).all() or counts[0, 0] >= valid[0, 0].sum() \
                or counts[0, 2] != cap:
            fail(f"row-capped compaction: counts {counts[0].tolist()}, "
                 f"expected {expect[0].tolist()}")
        emit("compaction", shape=list(shape), capacity=cap, kpr=kpr,
             frame0_valid_cells=valid[0].sum((-2, -1)).tolist(),
             frame0_kept=counts[0].tolist(), card_equals_cpu=True,
             sigma_max_rel_err=sig_err,
             sigma_bit_equal=bool(same(got.sigma.cpu(), want.sigma)))

    check_row_cap()

    # ---- main path ----------------------------------------------------------
    def table_fields(t):
        return {f: getattr(t, f) for f in t._fields}

    def run_main(cfg, pinned):
        reset_launch_counts()
        table = detect_batch(imgs, cfg)              # device defaults to cuda
        torch.cuda.synchronize()
        launches = launch_counts()
        for name, n in launches.items():
            if n == 0 and EXPECTED_LAUNCHES[name]:
                fail(f"main path ({cfg.detector}) never launched {name}")
        if launches != EXPECTED_LAUNCHES:
            fail(f"launch counts {launches} != {EXPECTED_LAUNCHES}")
        plain = detect_batch(imgs, cfg, plain=True)  # plain versions, on the card
        torch.cuda.synchronize()
        if launch_counts() != launches:
            fail("the plain run launched a kernel")
        G = min(cfg.global_feature_cap, sum(plan.level_caps))
        for f, a in table_fields(table).items():
            want_shape = (BATCH, G) + ((128,) if f == "desc" else ())
            if tuple(a.shape) != want_shape:
                fail(f"{f}: shape {tuple(a.shape)} != {want_shape}")
            if a.is_floating_point() and not bool(torch.isfinite(a).all()):
                fail(f"{f}: non-finite values")
            if not same(a, getattr(plain, f)):
                fail(f"main path ({cfg.detector}): {f} differs between the "
                     "kernels and the plain versions")
        if bool(table.theta.any()) or bool(table.desc.any()):
            fail("theta/desc must be zero in the upright, detection-only mode")
        counts = table.count().tolist()
        if pinned:
            lv = table.level[0][table.valid[0]].cpu().numpy()
            level_counts = np.bincount(lv, minlength=len(plan.level_caps))
            if counts[0] != FRAME0_KEYPOINTS or \
                    level_counts.tolist() != FRAME0_LEVEL_COUNTS:
                fail(f"frame 0: {counts[0]} keypoints, per level "
                     f"{level_counts.tolist()}; pinned {FRAME0_KEYPOINTS}, "
                     f"{FRAME0_LEVEL_COUNTS}")
            # the same frame on the CPU (plain versions): same keypoints.
            # exp2/pow differ in the last bit between the two devices, so
            # sigma is compared to 1e-6 relative; the rest is exact.
            cpu = detect_batch(frames[:1], cfg, device="cpu")
            for f in ("valid", "level", "ftype", "response", "x", "y"):
                if not same(getattr(table, f)[:1].cpu(), getattr(cpu, f)):
                    fail(f"frame 0: {f} differs between the card and the CPU")
            if not torch.allclose(table.sigma[:1].cpu(), cpu.sigma,
                                  rtol=1e-6, atol=0):
                fail("frame 0: sigma differs between the card and the CPU")
        return launches, counts

    launches_h, counts_h = run_main(cfg_h, pinned=True)

    # a few timed iterations of the entry point, host clock around work that
    # ends in a synchronize
    torch.cuda.reset_peak_memory_stats()
    iters = []
    for _ in range(5):
        t0 = time.perf_counter()
        detect_batch(imgs, cfg_h)
        torch.cuda.synchronize()
        iters.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    kernel_path_ms = sum(t["path_ms"] for name, t in timing.items()
                         if EXPECTED_LAUNCHES[name])
    emit("main_path", config="-sd -ofix", detector="hessian", batch=BATCH,
         height=HEIGHT,
         width=WIDTH, launches=launches_h, keypoints=counts_h,
         frame0_keypoints=counts_h[0], equals_plain=True,
         frame0_equals_cpu=True,
         batch_seconds=iters, frames_per_s_best=BATCH / min(iters),
         frames_per_s_median=BATCH / statistics.median(iters),
         kernels_ms_per_batch=kernel_path_ms,
         max_memory_allocated=peak, input_seconds=round(input_seconds, 3))

    launches_d, counts_d = run_main(cfg_d, pinned=False)
    emit("main_path", config="-sd -ofix", detector="dog", batch=BATCH,
         launches=launches_d, keypoints=counts_d, equals_plain=True)

    # ---- main path, default configuration ------------------------------------
    quantum = 2.0 * np.pi / 255.0

    def circ(a, b):
        d = (a - b).abs() % (2.0 * np.pi)
        return torch.minimum(d, 2.0 * np.pi - d)

    def run_main_default(cfg, pinned):
        reset_launch_counts()
        table = detect_batch(imgs, cfg)              # device defaults to cuda
        torch.cuda.synchronize()
        launches = launch_counts()
        for name, n in launches.items():
            if n == 0 and EXPECTED_LAUNCHES_DEFAULT[name]:
                fail(f"default main path ({cfg.detector}) never launched "
                     f"{name}")
        if launches != EXPECTED_LAUNCHES_DEFAULT:
            fail(f"launch counts {launches} != {EXPECTED_LAUNCHES_DEFAULT}")
        plain = detect_batch(imgs, cfg, plain=True)  # plain versions, on the card
        torch.cuda.synchronize()
        if launch_counts() != launches:
            fail("the plain run launched a kernel")
        G = min(cfg.global_feature_cap, sum(plan.level_caps))
        g_exp = int(G * cfg.expansion_factor + 7) // 8 * 8
        for f, a in table_fields(table).items():
            want_shape = (BATCH, g_exp) + ((128,) if f == "desc" else ())
            if tuple(a.shape) != want_shape:
                fail(f"{f}: shape {tuple(a.shape)} != {want_shape}")
            if a.is_floating_point() and not bool(torch.isfinite(a).all()):
                fail(f"{f}: non-finite values")
        # Both runs feed bit-equal tables to the orientation stage (checked
        # above, field for field), so the keypoints whose orientations differ
        # between kernel and plain version are those the kernels phase found
        # and explained. A frame that holds one has its later slots shifted;
        # every other frame must agree slot for slot.
        ok = ~differing_frames[cfg.detector]
        for f in ("valid", "level", "ftype", "x", "y", "sigma", "response",
                  "theta"):
            if not same(getattr(table, f)[ok], getattr(plain, f)[ok]):
                fail(f"default main path ({cfg.detector}): {f} differs "
                     "between the kernels and the plain versions")
        desc_err = max_abs(table.desc[ok], plain.desc[ok])
        if desc_err > DESC_TOL:
            fail(f"default main path ({cfg.detector}): descriptors "
                 f"{desc_err} apart; limit {DESC_TOL}")
        norm_err = float((table.desc[table.valid].norm(dim=-1) - 1)
                         .abs().max())
        if norm_err > 1e-5:
            fail(f"a valid descriptor's norm is {norm_err} from 1")
        if bool(table.desc[~table.valid].any()) \
                or bool(table.theta[~table.valid].any()):
            fail("a slot that is not valid is not zero")
        counts = table.count().tolist()
        report = dict(launches=launches, features=counts,
                      frames_with_differing_orientations=int((~ok).sum()),
                      desc_max_abs_err=desc_err, norm_max_abs_err=norm_err)
        if pinned:
            lv = table.level[0][table.valid[0]].cpu().numpy()
            levels = np.bincount(lv, minlength=len(plan.level_caps)).tolist()
            if counts[0] != FRAME0_FEATURES or levels != FRAME0_FEATURE_LEVELS:
                fail(f"frame 0: {counts[0]} features, per level {levels}; "
                     f"pinned {FRAME0_FEATURES}, {FRAME0_FEATURE_LEVELS}")
            # The same frame on the CPU (plain versions). exp, atan2 and the
            # sums differ in the last bits between the devices: positions
            # are exact, sigma 1e-6 relative; an orientation may land one
            # 2pi/255 quantum away on at most 1% of the features, and the
            # descriptors of the others agree to 1e-5.
            cpu = detect_batch(frames[:1], cfg, device="cpu")
            for f in ("valid", "level", "ftype", "response", "x", "y"):
                if not same(getattr(table, f)[:1].cpu(), getattr(cpu, f)):
                    fail(f"frame 0: {f} differs between the card and the CPU")
            if not torch.allclose(table.sigma[:1].cpu(), cpu.sigma,
                                  rtol=1e-6, atol=0):
                fail("frame 0: sigma differs between the card and the CPU")
            dth = circ(table.theta[:1].cpu(), cpu.theta)
            moved = dth > 1e-6
            if float(dth.max()) > quantum + 1e-6 \
                    or int(moved.sum()) > counts[0] // 100:
                fail(f"frame 0: theta differs between the card and the CPU "
                     f"on {int(moved.sum())} features, by up to "
                     f"{float(dth.max())}")
            cpu_err = max_abs(table.desc[:1].cpu()[~moved], cpu.desc[~moved])
            if cpu_err > 1e-5:
                fail(f"frame 0: descriptors {cpu_err} apart between the card "
                     "and the CPU")
            report.update(frame0_features=counts[0],
                          frame0_theta_moved_vs_cpu=int(moved.sum()),
                          frame0_desc_max_abs_err_vs_cpu=cpu_err)
        return table, report

    table_def, report_h = run_main_default(cfg_def["hessian"], pinned=True)
    launches_def = report_h["launches"]
    torch.cuda.reset_peak_memory_stats()
    iters = []
    for _ in range(5):
        t0 = time.perf_counter()
        detect_batch(imgs, cfg_def["hessian"])
        torch.cuda.synchronize()
        iters.append(time.perf_counter() - t0)
    emit("main_path", config="default", detector="hessian", batch=BATCH,
         height=HEIGHT, width=WIDTH, **report_h,
         batch_seconds=iters, frames_per_s_best=BATCH / min(iters),
         frames_per_s_median=BATCH / statistics.median(iters),
         kernels_ms_per_batch=sum(t["path_ms"] for name, t in timing.items()
                                  if EXPECTED_LAUNCHES_DEFAULT[name]),
         max_memory_allocated=torch.cuda.max_memory_allocated())
    _, report_d = run_main_default(cfg_def["dog"], pinned=False)
    emit("main_path", config="default", detector="dog", batch=BATCH,
         **report_d)

    # ---- keypoint re-entry ---------------------------------------------------
    # describe_keypoints on the card, fed frame 0's own keypoints. It bins a
    # keypoint to a level by its scale, which is not always the level it was
    # detected on (the subpixel step moves sigma); where it is, (a) without
    # theta its full-precision strongest orientation lies within one 2pi/255
    # quantum of the pipeline's first, quantized one, and the descriptors,
    # taken a fraction of a quantum apart, within 0.05; (b) given the
    # pipeline's theta the descriptors agree to 1e-5 on at least 99% of the
    # keypoints (a pixel whose angle sits on a bin edge can move a whole
    # vote: 0.02 at most).
    from hessgpu_tpu_torch.describe import _bin_by_scale
    f0 = to_numpy_trimmed(FeatureTable(*(a[0] for a in table_def)))
    keys = np.stack([f0["x"], f0["y"], f0["sigma"], f0["theta"]], axis=1)
    first = np.ones(len(keys), bool)        # first orientation per keypoint
    first[1:] = (keys[1:, :3] != keys[:-1, :3]).any(axis=1)
    binned, _ = _bin_by_scale(f0["sigma"], plan.num_octaves,
                              cfg_def["hessian"])
    level_kept = binned == f0["level"]
    reset_launch_counts()
    no_theta = describe_keypoints(frames[0], keys[first, :3],
                                  has_orientation=False)
    with_theta = describe_keypoints(frames[0], keys)
    describe_launches = launch_counts()
    if describe_launches["orientation"] != 1 \
            or describe_launches["descriptor"] != 2:
        fail(f"describe_keypoints launches: {describe_launches}")
    sel = level_kept[first]
    dth = np.abs(np.mod(no_theta["theta"] - f0["theta"][first] + np.pi,
                        2 * np.pi) - np.pi)[sel]
    dd = np.abs(no_theta["desc"] - f0["desc"][first]).max(axis=1)[sel]
    dd4 = np.abs(with_theta["desc"] - f0["desc"]).max(axis=1)[level_kept]
    if sel.mean() < 0.8 or dth.max() > quantum + 1e-5 or dd.max() > 0.05 \
            or (dd4 <= 1e-5).mean() < 0.99 or dd4.max() > 0.02 \
            or not np.isfinite(no_theta["desc"]).all() \
            or not np.isfinite(with_theta["desc"]).all():
        fail(f"describe_keypoints vs the pipeline on frame 0: level kept "
             f"{sel.mean()}, theta {dth.max()}, desc {dd.max()}, with theta "
             f"{dd4.max()} ({(dd4 <= 1e-5).mean()} within 1e-5)")
    emit("describe", keypoints=int(first.sum()), features=len(keys),
         level_kept_share=float(level_kept.mean()),
         theta_max_abs_diff=float(dth.max()), quantum=quantum,
         desc_max_abs_diff_without_theta=float(dd.max()),
         desc_max_abs_diff_with_theta=float(dd4.max()),
         share_within_1e_5_with_theta=float((dd4 <= 1e-5).mean()),
         launches=describe_launches)

    emit("blur", octave0_ms=timing["blur"]["ms"],
         path_ms_by_detector=timing["blur"]["path_ms_by_detector"],
         nvidia_smi=smi_line)

    # ---- result -------------------------------------------------------------
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches_def[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            "shape": t["shape"], "path_ms": t["path_ms"],
            "path_bound_ms": t["path_bound_ms"],
            **{k: t[k] for k in DETAIL if k in t}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
