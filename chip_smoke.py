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
  first_octave  DoG at -fo -1 (octave 0 upsampled to 960x1280): every kernel
             against its plain version along that pyramid and on its tables,
             detect_batch on the 16 upsampled frames (launches pinned) against
             the plain versions, frame 0 through detect_and_describe against
             the batch and the CPU; ms per frame; chain and detect at 960x1280
  direct     conv_mode="direct", Hessian and DoG, -sd -ofix, B=16: launches
             pinned (blur 21 / 26, downsample2 4, no chain), bit-equal to the
             plain route, frame 0 equal to the CPU; pyramid ms and device
             busy (torch.profiler) beside the chain mode's
  facade     HessianSift on PGM files of frames 0-3 equal to
             detect_and_describe, get_feature_vector, save_sift and
             load_sift_text, run_with_keypoints, device_stage_report; run ms
             split into load / pipeline / download
  cli        python -m hessgpu_tpu_torch.cli.hess -i on two PGMs (the .sift
             files byte-equal to the facade's) and -speed on one (Hz,
             .speed.csv)
  matcher    frame 0 against its 10 degree rotation, plain and guided: the
             card's matches equal the CPU's; dots equal to int64 numpy at
             frame 0's size and at 16384 x 16384; ms of _match_core and of
             _guided_gate
  evaluation evaluate_repeatability on frame 0 under the rotation, card = CPU
  ba         bench_ba.py's problem (64 cameras, 4096 points, 32768
             observations, 30 CG steps per LM step): one lm_step on the card
             and on the CPU from the same state (cost0 within 1e-5 relative,
             cost1 within 1e-3, accepted equal); LM and CG iterations/s over
             10 LM steps after 2 warm-up steps; launches and device busy per
             LM step (utils.timing.device_profile); the final RMSE on the
             card and the CPU within 1e-2 px; two card runs bit-equal
  sfm        the synthetic TUM sequence (write_tum_sequence's scene, 40
             frames at 640x480, rendered in memory): HessianSift(threshold
             0.003).run per frame on the card (launches pinned), then
             reconstruct_sequence on the card and on the CPU from those
             features: all 40 frames registered on both, the same view_ids,
             the card's ATE at most twice the JAX package's (JAX_SFM_ATE);
             seconds for detection, reconstruction, its BA and its SVDs
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
             supports; octave_chain and detect_octave their ms at
             960x1280 (-fo -1); every kernel its launches on each path
             (launches_by_path)
  <name>, <power limit>
  {"ok": true, "device": {...}}
"""

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
          "octave0_warp_share_keypoint", "ms_960x1280", "launches_by_path")
# ba phase: bench_ba.py's problem (64 cameras, 4096 points, every camera
# sees every 8th point: 32768 observations), built here in NumPy
BA_CAMS, BA_PTS, BA_SEE_EVERY = 64, 4096, 8
BA_CG_ITERS, BA_WARMUP, BA_ITERS = 30, 2, 10
# sfm phase: write_tum_sequence's scene (seed 7, its K), 40 frames at
# 640x480, SiftConfig(threshold=0.003), reconstruct_sequence's defaults
SFM_FRAMES, SFM_SEED, SFM_THRESHOLD = 40, 7, 0.003
# The JAX package's ATE on that sequence (write_tum_sequence(n_frames=40,
# h=480, w=640) -> evaluate_sequence_ate, SiftConfig(threshold=0.003),
# mesh=None) on a CPU host: scripts/jax_sfm_ate_reference.py, 40 of 40
# frames registered, 1944 points. The card's ATE must be at most twice it.
JAX_SFM_ATE = 0.000959249298848135
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


REPO_DIR = os.path.dirname(os.path.abspath(__file__))


def write_pgm(path, img_u8):
    """An 8-bit grayscale image as a binary PGM (P5)."""
    import numpy as np
    with open(path, "wb") as f:
        f.write(f"P5\n{img_u8.shape[1]} {img_u8.shape[0]}\n255\n".encode())
        f.write(np.ascontiguousarray(img_u8).tobytes())
    return path


def ba_problem():
    """bench_ba.py's problem in NumPy: cameras on a ring looking at a point
    cloud, Gaussian pixel noise (0.5 px), perturbed start (0.05)."""
    import numpy as np
    import torch

    from hessgpu_tpu_torch.sfm.ba import so3_exp

    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (BA_PTS, 3)).astype(np.float32)
    X[:, 2] += 6.0
    R_list, t_list = [], []
    for c in range(BA_CAMS):
        ang = 0.4 * np.sin(2 * np.pi * c / BA_CAMS)
        w = np.array([0.0, ang, 0.0], np.float32)
        R = so3_exp(torch.from_numpy(w)).numpy()
        cpos = np.array([3.0 * np.sin(ang), 0.3 * np.cos(ang), 0.0])
        R_list.append(R)
        t_list.append(-R @ cpos)
    R = np.stack(R_list).astype(np.float32)
    t = np.stack(t_list).astype(np.float32)
    f, cx, cy = 800.0, 320.0, 240.0
    intr = np.tile(np.array([f, cx, cy], np.float32), (BA_CAMS, 1))
    cam_idx, pt_idx, uvs = [], [], []
    for c in range(BA_CAMS):
        pts = np.arange(c % BA_SEE_EVERY, BA_PTS, BA_SEE_EVERY)
        Xc = X[pts] @ R[c].T + t[c]
        uv = Xc[:, :2] / Xc[:, 2:3] * f + np.array([cx, cy])
        cam_idx.append(np.full(len(pts), c))
        pt_idx.append(pts)
        uvs.append(uv + rng.normal(0, 0.5, uv.shape))
    uv = np.concatenate(uvs)
    return dict(R=R, t=t + rng.normal(0, 0.05, t.shape),
                X=X + rng.normal(0, 0.05, X.shape), intr=intr,
                cam_idx=np.concatenate(cam_idx), pt_idx=np.concatenate(pt_idx),
                uv=uv, weight=np.ones(len(uv), np.float32))


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

    # =======================================================================
    # The public entry points and the last two pipeline modes. Each phase
    # sets the launch counts to 0 just before it drives its path and reads
    # them just after.
    # =======================================================================
    from hessgpu_tpu_torch import HessianSift, SiftMatcher, detect_and_describe
    from hessgpu_tpu_torch import matcher as tmatch
    from hessgpu_tpu_torch.evaluation import (evaluate_repeatability,
                                              rotation_homography, warp_image)
    from hessgpu_tpu_torch.formats import load_sift_text
    from hessgpu_tpu_torch.ops.resize import upsample
    from hessgpu_tpu_torch.utils.timing import (REFERENCE_BUCKETS,
                                                device_profile, synchronize)

    def wall_ms(fn, reps=5):
        """Host clock around fn() and a synchronize, after one warm-up:
        every rep's ms."""
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    def device_busy(fn):
        """Device ms and pieces of device work per call of fn (the port's
        own accounting, utils.timing.device_profile), over 5 calls."""
        prof = device_profile(fn)
        if prof["busy_ms"] <= 0:
            fail("torch.profiler saw no device time")
        return dict(busy_ms=prof["busy_ms"], kernel_launches=prof["launches"])

    def frame_vs_cpu(card_table, cpu_table, what, descriptors=True):
        """One frame on the card against the same frame on the CPU (plain
        versions): the rules of the main path's frame-0 check."""
        for f in ("valid", "level", "ftype", "response", "x", "y"):
            if not same(getattr(card_table, f).cpu(), getattr(cpu_table, f)):
                fail(f"{what}: {f} differs between the card and the CPU")
        if not torch.allclose(card_table.sigma.cpu(), cpu_table.sigma,
                              rtol=1e-6, atol=0):
            fail(f"{what}: sigma differs between the card and the CPU")
        n = int(cpu_table.valid.sum())
        dth = circ(card_table.theta.cpu(), cpu_table.theta)
        moved = dth > 1e-6
        if float(dth.max()) > quantum + 1e-6 or int(moved.sum()) > n // 100:
            fail(f"{what}: theta differs between the card and the CPU on "
                 f"{int(moved.sum())} features, by up to {float(dth.max())}")
        err = max_abs(card_table.desc.cpu()[~moved], cpu_table.desc[~moved]) \
            if descriptors else 0.0
        if err > 1e-5:
            fail(f"{what}: descriptors {err} apart between the card and the "
                 "CPU")
        return dict(features=n, theta_moved=int(moved.sum()),
                    desc_max_abs_err=err)

    def kernels_equal_plain(table, plain, ok, what):
        """The main path through the kernels against the plain versions on
        the card, slot for slot on the frames `ok` (a frame outside it holds
        a keypoint whose orientations the kernels phase found differing
        within tolerance), descriptors within DESC_TOL."""
        for f in ("valid", "level", "ftype", "x", "y", "sigma", "response",
                  "theta"):
            if not same(getattr(table, f)[ok], getattr(plain, f)[ok]):
                fail(f"{what}: {f} differs between the kernels and the plain "
                     "versions")
            a = getattr(table, f)
            if a.is_floating_point() and not bool(torch.isfinite(a).all()):
                fail(f"{what}: {f} has non-finite values")
        err = max_abs(table.desc[ok], plain.desc[ok])
        if err > DESC_TOL:
            fail(f"{what}: descriptors {err} apart; limit {DESC_TOL}")
        return err

    launches_by_path = {"default": launches_def}

    # ---- first_octave: DoG at -fo -1, octave 0 upsampled to 960x1280 -------
    cfg_fo = SiftConfig(detector="dog", first_octave=-1)
    up = upsample(imgs).contiguous()                   # (16, 960, 1280)
    plan_fo = make_plan(2 * HEIGHT, 2 * WIDTH, cfg_fo)
    n_fo = plan_fo.num_octaves
    # the kernels against their plain versions along this pyramid (blur,
    # chain in place with its decimation, detect) and on its tables
    keys_fo = check_pyramid_kernels(up, cfg_fo)
    t_fo, maps_fo, owin_fo, dwin_fo = keypoint_scene(up, cfg_fo)
    got_fo, _, differing_fo = check_orientation(
        t_fo, maps_fo, owin_fo, max_peaks=cfg_fo.max_orientations)
    g_fo = int(t_fo.x.shape[-1] * cfg_fo.expansion_factor + 7) // 8 * 8
    check_descriptor(tpyr._expand_orientations(t_fo, got_fo.thetas,
                                               got_fo.valid, g_fo),
                     maps_fo, dwin_fo)
    del t_fo, maps_fo, got_fo
    expected_fo = dict(EXPECTED_LAUNCHES_DEFAULT, octave_chain=n_fo,
                       detect_octave=n_fo)
    reset_launch_counts()
    table_fo = detect_batch(up, cfg_fo)
    torch.cuda.synchronize()
    launches_fo = launch_counts()
    if launches_fo != expected_fo:
        fail(f"-fo -1 launch counts {launches_fo} != {expected_fo}")
    launches_by_path["first_octave_dog"] = launches_fo
    plain_fo = detect_batch(up, cfg_fo, plain=True)
    torch.cuda.synchronize()
    if launch_counts() != launches_fo:
        fail("the plain -fo -1 run launched a kernel")
    ok_fo = ~differing_fo.any(-1)
    fo_desc_err = kernels_equal_plain(table_fo, plain_fo, ok_fo, "-fo -1")
    # frame 0 through detect_and_describe (the upsample on the card), against
    # the batch's row 0 and against the CPU
    one_fo, _ = detect_and_describe(frames[0], cfg_fo)
    for f in one_fo._fields:
        if not same(getattr(one_fo, f), getattr(table_fo, f)[0]):
            fail(f"-fo -1 frame 0: {f} differs between detect_and_describe "
                 "and the batch")
    cpu_fo, _ = detect_and_describe(frames[0], cfg_fo, device="cpu")
    fo_cpu = frame_vs_cpu(one_fo, cpu_fo, "-fo -1 frame 0")
    # ms per frame, and the two dense kernels at 960x1280
    fo_batch_ms = wall_ms(lambda: detect_batch(up, cfg_fo))
    fo_frame_ms = wall_ms(lambda: detect_and_describe(frames[0], cfg_fo))
    p_fo = cfg_fo.scale_params()
    taps_fo = gaussian.chain_taps(p_fo)
    lds_fo = p_fo.level_ds - p_fo.level_min
    oct_fo = tpyr._build_pyramid(up, plan_fo, cfg_fo)
    work = oct_fo[0].clone()
    nxt = torch.empty_like(oct_fo[1])
    chain_fo_ms = time_ms(lambda: conv.octave_chain_into(
        work, taps_fo, decimate_level=lds_fo, next_base=nxt[:, 0]))
    norms_fo = tpyr._detect_norms(p_fo, cfg_fo)
    dkw_fo = dict(threshold=p_fo.threshold,
                  edge_threshold=p_fo.edge_threshold, subpixel=True,
                  darkness_adaption=False, detector="dog")
    valid_fo = int(detect.detect_octave(oct_fo[0], norms_fo, p_fo.key_levels,
                                        **dkw_fo)[0].valid.sum())
    detect_fo_ms = time_ms(lambda: detect.detect_octave(
        oct_fo[0], norms_fo, p_fo.key_levels, **dkw_fo))
    n_big = BATCH * 4 * HEIGHT * WIDTH
    L_fo, NK_fo = p_fo.num_levels, len(p_fo.key_levels)
    chain_fo_bound = bound(4 * n_big * L_fo + n_big,
                           4 * sum(len(t) for t in taps_fo) * n_big)
    detect_fo_bound = bound(n_big * (4 * L_fo + 9 * NK_fo) + 20 * valid_fo,
                            n_big * (13 * L_fo + 30 * NK_fo) + 170 * valid_fo)
    del work, nxt, oct_fo, plain_fo
    emit("first_octave", detector="dog", first_octave=-1, batch=BATCH,
         input=[HEIGHT, WIDTH], octave0=[2 * HEIGHT, 2 * WIDTH],
         octaves=n_fo, launches=launches_fo, keypoints_checked=keys_fo,
         features=table_fo.count().tolist(),
         frames_with_differing_orientations=int((~ok_fo).sum()),
         equals_plain=True, desc_max_abs_err=fo_desc_err,
         frame0_equals_batch=True, frame0_vs_cpu=fo_cpu,
         batch_ms=fo_batch_ms, ms_per_frame_batched=min(fo_batch_ms) / BATCH,
         frame0_ms=fo_frame_ms, ms_per_frame_single=min(fo_frame_ms),
         chain_ms_960x1280=chain_fo_ms, chain_bound_ms_960x1280=chain_fo_bound,
         detect_ms_960x1280=detect_fo_ms,
         detect_bound_ms_960x1280=detect_fo_bound,
         detect_valid_cells_960x1280=valid_fo)
    timing["octave_chain"]["ms_960x1280"] = chain_fo_ms
    timing["detect_octave"]["ms_960x1280"] = detect_fo_ms
    del table_fo, one_fo, up

    # ---- direct: every level blurred from the octave base ------------------
    direct_report = {}
    for det, blurs in (("hessian", 21), ("dog", 26)):
        cfg_dir = SiftConfig(detector=det, conv_mode="direct", **slice_cfg)
        cfg_chain = SiftConfig(detector=det, **slice_cfg)
        expected = dict(EXPECTED_LAUNCHES, blur=blurs, downsample2=4,
                        octave_chain=0)
        reset_launch_counts()
        table = detect_batch(imgs, cfg_dir)
        torch.cuda.synchronize()
        launches = launch_counts()
        if launches != expected:
            fail(f"direct ({det}) launch counts {launches} != {expected}")
        launches_by_path[f"direct_{det}"] = launches
        plain = detect_batch(imgs, cfg_dir, plain=True)
        torch.cuda.synchronize()
        if launch_counts() != launches:
            fail("the plain direct run launched a kernel")
        # detection only: the whole table is upstream of the orientation
        # stage, so kernel and plain routes agree bit for bit
        for f in table._fields:
            if not same(getattr(table, f), getattr(plain, f)):
                fail(f"direct ({det}): {f} differs between the kernels and "
                     "the plain versions")
        cpu = detect_batch(frames[:1], cfg_dir, device="cpu")
        frame_vs_cpu(FeatureTable(*(a[:1] for a in table)), cpu,
                     f"direct ({det}) frame 0", descriptors=False)
        plan_d = make_plan(HEIGHT, WIDTH, cfg_dir)
        direct_report[det] = dict(
            launches=launches, keypoints=table.count().tolist(),
            chain_mode_keypoints=detect_batch(imgs, cfg_chain).count()
            .tolist(),
            pyramid_ms=time_ms(lambda: tpyr._build_pyramid(imgs, plan_d,
                                                           cfg_dir)),
            chain_mode_pyramid_ms=time_ms(lambda: tpyr._build_pyramid(
                imgs, plan_d, cfg_chain)),
            device=device_busy(lambda: detect_batch(imgs, cfg_dir)),
            chain_mode_device=device_busy(lambda: detect_batch(imgs,
                                                               cfg_chain)))
        del table, plain
    emit("direct", config="-sd -ofix", batch=BATCH, height=HEIGHT,
         width=WIDTH, equals_plain=True, frame0_equals_cpu=True,
         **direct_report)

    # ---- facade: HessianSift on PGM files ----------------------------------
    workdir = tempfile.mkdtemp(prefix="hessgpu_smoke_")
    try:
        u8 = [(np.clip(frames[i], 0, 1) * 255 + 0.5).astype(np.uint8)
              for i in range(4)]
        pgms = [write_pgm(os.path.join(workdir, f"f{i}.pgm"), u8[i])
                for i in range(4)]
        sift = HessianSift()                          # device defaults to cuda
        reset_launch_counts()
        feats = [sift.run(p) for p in pgms]
        torch.cuda.synchronize()
        launches = launch_counts()
        want_launches = {k: 4 * v for k, v in EXPECTED_LAUNCHES_DEFAULT.items()}
        if launches != want_launches:
            fail(f"HessianSift.run launch counts {launches} != "
                 f"{want_launches}")
        launches_by_path["facade_4_frames"] = launches
        # Each frame's run is detect_and_describe's on the card, field for
        # field. That B=1 path is held, slot for slot, to its plain versions
        # on the card and, under the main path's frame-0 rules, to the CPU.
        facade_vs_cpu = []
        for i, f in enumerate(feats):
            card, _ = detect_and_describe(u8[i], SiftConfig())
            want = to_numpy_trimmed(card)
            for k in want:
                if not np.array_equal(f[k], want[k]):
                    fail(f"HessianSift.run frame {i}: {k} differs from "
                         "detect_and_describe")
            reset_launch_counts()
            plain, _ = tpyr.run_pipeline(
                *tpyr.prepare_input(u8[i], SiftConfig()), plain=True)
            torch.cuda.synchronize()
            if any(launch_counts().values()):
                fail("the plain B=1 run launched a kernel")
            kernels_equal_plain(FeatureTable(*(a[None] for a in card)),
                                FeatureTable(*(a[None] for a in plain)),
                                torch.ones(1, dtype=torch.bool, device=dev),
                                f"HessianSift.run frame {i}")
            cpu, _ = detect_and_describe(u8[i], SiftConfig(), device="cpu")
            facade_vs_cpu.append(frame_vs_cpu(card, cpu,
                                              f"HessianSift.run frame {i}"))
            del card, plain, cpu
        if len(feats[0]["x"]) != FRAME0_FEATURES:
            fail(f"HessianSift.run frame 0: {len(feats[0]['x'])} features, "
                 f"pinned {FRAME0_FEATURES}")
        facade_sifts = []
        for i in (0, 1):
            f = sift.run(pgms[i])
            kp, desc = sift.get_feature_vector()
            if kp.shape != (len(f["x"]), 6) or desc is not f["desc"] \
                    or not np.array_equal(kp[:, 0], f["x"]) \
                    or not np.array_equal(kp[:, 5].view(np.uint32) & 0xFFFF,
                                          f["level"]):
                fail("get_feature_vector does not carry the features")
            path = os.path.join(workdir, f"facade{i}.sift")
            sift.save_sift(path)
            facade_sifts.append(path)
            back = load_sift_text(path)
            if len(back["x"]) != len(f["x"]) \
                    or np.abs(back["x"] - f["x"]).max() > 0.005 \
                    or np.abs(back["desc"] - f["desc"]).max() > 0.5 / 512 + 1e-6 \
                    or not np.array_equal(back["level"], f["level"]):
                fail("save_sift / load_sift_text do not round-trip")
        kp, _ = sift.get_feature_vector()       # frame 1's
        reset_launch_counts()
        reentry = sift.run_with_keypoints(pgms[1], kp)
        reentry_launches = launch_counts()
        if reentry_launches["descriptor"] != 1 \
                or reentry_launches["orientation"] != 0 \
                or len(reentry["x"]) != len(kp) \
                or not np.array_equal(reentry["response"], kp[:, 4]) \
                or not np.isfinite(reentry["desc"]).all() \
                or np.abs(np.linalg.norm(reentry["desc"], axis=1) - 1).max() \
                > 1e-5:
            fail(f"run_with_keypoints: launches {reentry_launches}")
        rep = sift.device_stage_report(pgms[0])
        vals = list(rep.values())
        if tuple(rep) != REFERENCE_BUCKETS or not all(
                np.isfinite(v) and v >= 0 for v in vals) \
                or rep["TOTAL"] < sum(vals[:-1]) - 1e-9 \
                or rep["TOTAL"] <= 0 or rep["BUILD_PYRAMID"] <= 0 \
                or rep["DETECT_KEYPOINTS"] <= 0:
            fail(f"device_stage_report: {dict(rep)}")
        stage_ms = {k: [] for k in ("load", "pipeline", "download")}
        run_ms = []
        sift.run(pgms[0])
        for _ in range(10):
            t0 = time.perf_counter()
            sift.run(pgms[0])
            run_ms.append((time.perf_counter() - t0) * 1e3)
            for k in stage_ms:
                stage_ms[k].append(sift.timer.last[k])
        emit("facade", frames=4, features=[len(f["x"]) for f in feats],
             launches=launches, equals_detect_and_describe=True,
             equals_plain=True, vs_cpu=facade_vs_cpu,
             save_sift_roundtrip=True, reentry_launches=reentry_launches,
             device_stage_report_ms=dict(rep),
             run_ms=run_ms, run_ms_median=statistics.median(run_ms),
             stage_ms_median={k: statistics.median(v)
                              for k, v in stage_ms.items()},
             stage_ms=stage_ms, nvidia_smi=smi_line)

        # ---- cli: python -m hessgpu_tpu_torch.cli.hess, on the card ---------
        env = dict(os.environ, PYTHONPATH=REPO_DIR + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        cli = subprocess.run(
            [sys.executable, "-m", "hessgpu_tpu_torch.cli.hess", "-i",
             pgms[0], pgms[1]], cwd=workdir, env=env, capture_output=True,
            text=True, timeout=300)
        if cli.returncode != 0:
            fail(f"hess -i: exit {cli.returncode}: {cli.stderr[-2000:]}")
        for i, path in enumerate(facade_sifts):
            with open(path, "rb") as a, \
                    open(os.path.join(workdir, f"f{i}.sift"), "rb") as b:
                if a.read() != b.read():
                    fail(f"hess -i: f{i}.sift differs from the facade's")
        speed = subprocess.run(
            [sys.executable, "-m", "hessgpu_tpu_torch.cli.hess", "-i",
             pgms[2], "-speed"], cwd=workdir, env=env, capture_output=True,
            text=True, timeout=300)
        hz = [float(v) for v in re.findall(r"([0-9.]+) Hz \(",
                                           speed.stdout)]
        csv_path = os.path.join(workdir, "f2.speed.csv")
        if speed.returncode != 0 or len(hz) != 2 \
                or not os.path.exists(csv_path):
            fail(f"hess -speed: exit {speed.returncode}: {speed.stdout[-800:]}"
                 f"{speed.stderr[-1500:]}")
        with open(csv_path) as fh:
            speed_csv = fh.read().splitlines()
        if tuple(speed_csv[3].split(",")) != REFERENCE_BUCKETS:
            fail(f"hess -speed: {csv_path} buckets {speed_csv[3]}")
        emit("cli", images=2, sift_files_equal_facade=True, speed_hz=hz,
             speed_csv=speed_csv, nvidia_smi=smi_line)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # ---- matcher --------------------------------------------------------------
    H10 = rotation_homography(10, HEIGHT, WIDTH)
    warped = warp_image(frames[0], H10)
    fa = HessianSift().run(frames[0])
    fb = HessianSift().run(warped)
    m_card, m_cpu = SiftMatcher(), SiftMatcher(device="cpu")
    pairs = [m.match(fa, fb) for m in (m_card, m_cpu)]
    if not np.array_equal(pairs[0], pairs[1]) or len(pairs[0]) < 50:
        fail(f"matcher: {len(pairs[0])} matches on the card, {len(pairs[1])} "
             "on the CPU, or they differ")
    guided = []
    for m in (m_card, m_cpu):
        m.set_feature_location(0, np.stack([fa["x"], fa["y"]], 1))
        m.set_feature_location(1, np.stack([fb["x"], fb["y"]], 1))
        guided.append(m.get_guided_sift_match(H=H10.astype(np.float32)))
    if not np.array_equal(guided[0], guided[1]) or len(guided[0]) < 50:
        fail("matcher: guided matches differ between the card and the CPU")
    qa = torch.from_numpy(tmatch.quantize_descriptors(fa["desc"])).to(dev)
    qb = torch.from_numpy(tmatch.quantize_descriptors(fb["desc"])).to(dev)
    dots = tmatch.descriptor_dots(qa, qb).cpu().numpy()
    want = qa.cpu().numpy().astype(np.int64) @ qb.cpu().numpy().astype(
        np.int64).T
    if not (dots == want).all():
        fail("matcher: the dots at frame 0's size differ from int64 numpy")
    g = np.random.RandomState(11)
    N = 16384
    big_a = torch.from_numpy(g.randint(0, 256, (N, 128), np.uint8)).to(dev)
    big_b = torch.from_numpy(g.randint(0, 256, (N, 128), np.uint8)).to(dev)
    big_a[0] = 255      # the largest dot: 128 * 255^2 = 8323200 < 2^24
    big_b[0] = 255
    dots = tmatch.descriptor_dots(big_a, big_b).cpu().numpy()
    # every partial sum is an integer below 2^24, so the float64 product
    # (BLAS, exact below 2^53) is the int64 one
    want = (big_a.cpu().numpy().astype(np.float64)
            @ big_b.cpu().numpy().astype(np.float64).T).astype(np.int64)
    if not (dots == want).all() or int(want.max()) != 128 * 255 * 255:
        fail("matcher: the 16384 x 16384 dots differ from int64 numpy")
    del dots, want
    va = torch.ones(N, dtype=torch.bool, device=dev)
    core = lambda a, b, v1, v2: tmatch._match_core(a, b, v1, v2, 0.7, 0.8)
    loc_a = torch.from_numpy(g.rand(N, 2).astype(np.float32) * 640).to(dev)
    loc_b = torch.from_numpy(g.rand(N, 2).astype(np.float32) * 640).to(dev)
    Ht = torch.from_numpy(H10.astype(np.float32)).to(dev)
    Ft = torch.eye(3, device=dev)
    vq = torch.ones(len(qa), dtype=torch.bool, device=dev)
    vr = torch.ones(len(qb), dtype=torch.bool, device=dev)
    emit("matcher", frame0_features=[len(fa["x"]), len(fb["x"])],
         matches=len(pairs[0]), guided_matches=len(guided[0]),
         card_equals_cpu=True, dots_equal_int64=[[len(qa), len(qb)], [N, N]],
         match_core_ms_frame0=time_ms(lambda: core(qa, qb, vq, vr)),
         match_core_ms_16384=time_ms(lambda: core(big_a, big_b, va, va),
                                     reps=5),
         guided_gate_ms_16384=time_ms(lambda: tmatch._guided_gate(
             loc_a, loc_b, Ht, 32.0, Ft, 16.0), reps=5),
         nvidia_smi=smi_line)
    del big_a, big_b

    # ---- evaluation: repeatability under the 10 degree rotation ------------
    scores = [evaluate_repeatability(frames[0], angles=(10,), scales=(1.0,),
                                     device=d) for d in ("cuda", "cpu")]
    if scores[0] != scores[1] or not scores[0]["mean"] > 0.5:
        fail(f"evaluate_repeatability: card {scores[0]}, CPU {scores[1]}")
    emit("evaluation", angle=10, scale=1.0,
         repeatability=scores[0]["mean"], card_equals_cpu=True)

    # ---- ba: bundle adjustment at bench_ba.py's size ---------------------
    from hessgpu_tpu_torch.convert import ba_from_numpy
    from hessgpu_tpu_torch.sfm import ba as tba

    ba_np = ba_problem()
    st_card, pr_card = ba_from_numpy(device=dev, **ba_np)
    st_cpu, pr_cpu = ba_from_numpy(device="cpu", **ba_np)
    lam0 = 1e-3
    step_card = tba.lm_step(st_card, pr_card, torch.tensor(lam0, device=dev),
                            cg_iters=BA_CG_ITERS)
    step_cpu = tba.lm_step(st_cpu, pr_cpu, torch.tensor(lam0),
                           cg_iters=BA_CG_ITERS)
    c0 = [float(step_card[2]), float(step_cpu[2])]
    c1 = [float(step_card[3]), float(step_cpu[3])]
    if abs(c0[0] - c0[1]) > 1e-5 * abs(c0[1]) \
            or abs(c1[0] - c1[1]) > 1e-3 * abs(c1[1]) \
            or bool(step_card[4]) != bool(step_cpu[4]):
        fail(f"ba: lm_step card {c0[0]} -> {c1[0]} ({bool(step_card[4])}), "
             f"CPU {c0[1]} -> {c1[1]} ({bool(step_cpu[4])})")

    def lm_run(st, pr, iters):
        lam = torch.tensor(lam0, device=st.R.device)
        for _ in range(iters):
            st, lam, _, _, _ = tba.lm_step(st, pr, lam, cg_iters=BA_CG_ITERS)
        return st

    lm_run(st_card, pr_card, BA_WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_card = lm_run(st_card, pr_card, BA_ITERS)
    torch.cuda.synchronize()
    ba_s = time.perf_counter() - t0
    out_card2 = lm_run(st_card, pr_card, BA_ITERS)
    out_cpu = lm_run(st_cpu, pr_cpu, BA_ITERS)
    rmse = [tba.reprojection_rmse(out_card, pr_card),
            tba.reprojection_rmse(out_cpu, pr_cpu)]
    rmse2 = tba.reprojection_rmse(out_card2, pr_card)
    if abs(rmse[0] - rmse[1]) > 1e-2 or not np.isfinite(rmse[0]):
        fail(f"ba: final RMSE {rmse[0]} px on the card, {rmse[1]} on the CPU")
    # the segment sums are ordered (sfm/ba.py), so a card run repeats itself
    for f in ("R", "t", "X"):
        if not same(getattr(out_card, f), getattr(out_card2, f)):
            fail(f"ba: two card runs of the same LM steps differ in {f}")
    prof = device_profile(lambda: tba.lm_step(
        st_card, pr_card, torch.tensor(lam0, device=dev),
        cg_iters=BA_CG_ITERS), runs=3)
    emit("ba", cameras=BA_CAMS, points=BA_PTS,
         observations=int(pr_card.uv.shape[0]), cg_iters=BA_CG_ITERS,
         lm_step_cost0_card_cpu=c0, lm_step_cost1_card_cpu=c1,
         accepted=bool(step_card[4]),
         lm_iters_per_s=BA_ITERS / ba_s, cg_iters_per_s=BA_ITERS
         * BA_CG_ITERS / ba_s, timed_iters=BA_ITERS, timed_s=ba_s,
         launches_per_lm_iter=prof["launches"],
         device_busy_ms_per_lm_iter=prof["busy_ms"],
         wall_ms_per_lm_iter_profiler_on=prof["wall_ms"],
         top_device_work=dict(list(prof["by_kernel"].items())[:8]),
         final_rmse_px_card_cpu=rmse, rmse_px_second_card_run=rmse2,
         two_card_runs_max_abs_diff={
             f: max_abs(getattr(out_card, f), getattr(out_card2, f))
             for f in ("R", "t", "X")},
         card_vs_cpu_max_abs_diff={
             f: max_abs(getattr(out_card, f).cpu(), getattr(out_cpu, f))
             for f in ("R", "t", "X")},
         nvidia_smi=smi_line)
    del st_card, pr_card, out_card, out_card2

    # ---- sfm: the synthetic TUM sequence, detect + reconstruct + ATE ------
    from hessgpu_tpu_torch.sfm import incremental as tinc
    from hessgpu_tpu_torch.sfm.evaluate import ate_rmse, camera_centers
    from hessgpu_tpu_torch.sfm.synthetic import tum_sequence

    seq_frames, seq_K, _, seq_centers = tum_sequence(
        SFM_FRAMES, HEIGHT, WIDTH, seed=SFM_SEED)
    sift = HessianSift(SiftConfig(threshold=SFM_THRESHOLD))
    reset_launch_counts()
    t0 = time.perf_counter()
    seq_feats = [sift.run(f) for f in seq_frames]
    torch.cuda.synchronize()
    detect_s = time.perf_counter() - t0
    launches = launch_counts()
    want_launches = {k: SFM_FRAMES * v
                     for k, v in EXPECTED_LAUNCHES_DEFAULT.items()}
    if launches != want_launches:
        fail(f"sfm: HessianSift.run launch counts {launches} != "
             f"{want_launches}")
    launches_by_path[f"sfm_{SFM_FRAMES}_frames"] = launches

    def reconstruct(device):
        """reconstruct_sequence on `device`, its BA and (on the card) its
        SVDs timed by the host clock around a synchronize."""
        stats = {"ba_s": 0.0, "svd": {}}
        real_ba, real_svd = tinc.bundle_adjust, torch.linalg.svd

        def timed_ba(*a, **kw):
            t = time.perf_counter()
            out = real_ba(*a, **kw)
            synchronize(device)
            stats["ba_s"] += time.perf_counter() - t
            return out

        def timed_svd(A, *a, **kw):
            synchronize(device)
            t = time.perf_counter()
            out = real_svd(A, *a, **kw)
            synchronize(device)
            k = stats["svd"].setdefault("x".join(map(str, A.shape)),
                                        [0, 0.0])
            k[0] += 1
            k[1] += time.perf_counter() - t
            return out

        tinc.bundle_adjust = timed_ba
        torch.linalg.svd = timed_svd
        try:
            t = time.perf_counter()
            rec = tinc.reconstruct_sequence(seq_feats, seq_K, device=device)
            synchronize(device)
            stats["seconds"] = time.perf_counter() - t
        finally:
            tinc.bundle_adjust, torch.linalg.svd = real_ba, real_svd
        if rec is None:
            fail(f"sfm: reconstruct_sequence on {device} returned None")
        ids = rec.view_ids
        stats["svd_s"] = sum(v[1] for v in stats["svd"].values())
        stats.update(
            registered=rec.num_cameras, points=rec.num_points,
            ate=ate_rmse(camera_centers(rec.R, rec.t), seq_centers[ids]))
        return rec, stats

    rec_card, sfm_card = reconstruct("cuda")
    rec_cpu, sfm_cpu = reconstruct("cpu")
    if rec_card.view_ids != list(range(SFM_FRAMES)) \
            or rec_cpu.view_ids != rec_card.view_ids:
        fail(f"sfm: view_ids on the card {rec_card.view_ids}, on the CPU "
             f"{rec_cpu.view_ids}; all {SFM_FRAMES} expected")
    if not sfm_card["ate"] <= 2 * JAX_SFM_ATE:
        fail(f"sfm: ATE {sfm_card['ate']} on the card, limit "
             f"{2 * JAX_SFM_ATE} (twice the JAX package's)")
    emit("sfm", frames=SFM_FRAMES, height=HEIGHT, width=WIDTH,
         threshold=SFM_THRESHOLD, features=[len(f["x"]) for f in seq_feats],
         launches=launches, detect_s=detect_s,
         view_ids_equal=True, card=sfm_card, cpu=sfm_cpu,
         jax_ate_reference=JAX_SFM_ATE, ate_limit=2 * JAX_SFM_ATE,
         nvidia_smi=smi_line)

    emit("blur", octave0_ms=timing["blur"]["ms"],
         path_ms_by_detector=timing["blur"]["path_ms_by_detector"],
         nvidia_smi=smi_line)

    # ---- result -------------------------------------------------------------
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        t = timing[name]
        t["launches_by_path"] = {path: n[name]
                                 for path, n in launches_by_path.items()}
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
