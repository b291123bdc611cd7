#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hessgpu_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (nvcc); builds the kernels from
hessgpu_tpu_torch/csrc at first use. Exits non-zero, printing no result, if
there is no device, and on any failed phase. Phases, one JSON line each:

  device     the card (name and power limit as nvidia-smi gives them)
  build      seconds to build the kernel library
  kernels    each of the four kernels against its plain PyTorch version on
             the card, at every shape the main path gives it (640x480, B=16,
             five octaves) plus an odd shape, Hessian and DoG; timings by
             CUDA events (warm-up, then the median of REPS launches, the L2
             cache flushed before each)
  main_path  detect_batch on 16 seeded 640x480 textures, through the
             kernels (launch counts read), against the same batch through
             the plain versions on the card, frame 0 against its pinned
             counts and against a CPU run; then the DoG personality
  {"kernels": [...]}   one entry per kernel: launches on the main path,
             error, times, bound
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

BATCH = 16
HEIGHT, WIDTH = 480, 640
REPS = 10
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12       # float32 outside the tensor cores
EXPECTED_LAUNCHES = {"blur": 1, "octave_chain": 5, "downsample2": 4,
                     "detect_octave": 5}
KERNEL_INFO = {
    "blur": ("hessgpu_tpu_torch/csrc/conv.cu",
             "hessgpu_tpu/ops/pallas/conv.py:381"),
    "octave_chain": ("hessgpu_tpu_torch/csrc/conv.cu",
                     "hessgpu_tpu/ops/pallas/conv.py:310"),
    "downsample2": ("hessgpu_tpu_torch/csrc/conv.cu",
                    "hessgpu_tpu/ops/pallas/conv.py:494"),
    "detect_octave": ("hessgpu_tpu_torch/csrc/detect.cu",
                      "hessgpu_tpu/ops/pallas/detect.py:550"),
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

    from hessgpu_tpu_torch import SiftConfig, detect_batch, make_plan
    from hessgpu_tpu_torch import pyramid as tpyr
    from hessgpu_tpu_torch.ops import gaussian
    from hessgpu_tpu_torch.ops.cuda import (build, conv, detect,
                                            launch_counts,
                                            reset_launch_counts)
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
        reps timed ones. Before each, a 512 MB write evicts the 50 MB L2 and
        keeps the card busy while the host enqueues the launch, so a short
        kernel's time is its own and not the host's time to launch it."""
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            flush_buf.zero_()
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
        for f in ("valid", "ftype", "response", "dx", "dy", "ds"):
            must_equal("detect_octave", f, getattr(gm, f), getattr(wm, f))
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
        """Every kernel against its plain version along one pyramid, each
        fed the same input (the kernel chain's own intermediates)."""
        p = cfg.scale_params()
        plan = make_plan(imgs.shape[1], imgs.shape[2], cfg)
        taps0 = gaussian_taps(p.initial_blur_sigma(cfg.first_octave),
                              p.filter_width_factor)
        base = conv.blur(imgs, taps0)
        must_equal("blur", "output", base, conv.blur_plain(imgs, taps0))
        checked["blur"] += 1
        taps_list = gaussian.chain_taps(p)
        lds = p.level_ds - p.level_min
        keys = 0
        for o, (oh, ow) in enumerate(plan.octave_shapes):
            stack = conv.octave_chain(base, taps_list)
            must_equal("octave_chain", "stack", stack,
                       conv.octave_chain_plain(base, taps_list))
            checked["octave_chain"] += 1
            keys += check_detect(stack, cfg)
            if o + 1 < plan.num_octaves:
                src = stack[:, lds]
                down = conv.downsample2(src)
                must_equal("downsample2", "output", down,
                           conv.downsample2_plain(src))
                checked["downsample2"] += 1
                nh, nw = plan.octave_shapes[o + 1]
                base = down[..., :nh, :nw].contiguous()
        return keys

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
    odd = torch.from_numpy(rng.rand(2, 101, 75).astype(np.float32)).to(dev)
    tiny = torch.from_numpy(rng.rand(3, 30, 40).astype(np.float32)).to(dev)
    for x in (odd, tiny):
        for cfg in (cfg_h, cfg_d):
            check_pyramid_kernels(x, cfg)
        wide = gaussian_taps(5.0)            # 33 taps, the maximum
        must_equal("blur", "33 taps", conv.blur(x, wide),
                   conv.blur_plain(x, wide))
        checked["blur"] += 1
    odd_stack_h = conv.octave_chain(odd, gaussian.chain_taps(cfg_h.scale_params()))
    odd_stack_d = conv.octave_chain(odd, gaussian.chain_taps(cfg_d.scale_params()))
    for stack, cfg in ((odd_stack_h, cfg_h), (odd_stack_d, cfg_d)):
        check_detect(stack, cfg, subpixel=False)
        check_detect(stack, cfg, darkness_adaption=True)
        check_detect(stack, cfg, subpixel=False, darkness_adaption=True)
    if keys_h < BATCH * 50 or keys_d < BATCH * 50:
        fail(f"degenerate kernel check: {keys_h} Hessian / {keys_d} DoG "
             "keypoints")

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
    timing["blur"] = dict(
        shape=[BATCH, HEIGHT, WIDTH, len(taps0)],
        ms=time_ms(lambda: conv.blur(imgs, taps0)),
        plain_ms=time_ms(lambda: conv.blur_plain(imgs, taps0)),
        library_ms=time_ms(blur_library), library_max_abs_err=lib_err,
        # reads the image once, writes it once; 2 passes of `taps`
        # multiply-adds
        bound=bound(8 * n0, 4 * len(taps0) * n0))
    timing["blur"]["path_ms"] = timing["blur"]["ms"]

    chain_ms, down_ms, det_ms = [], [], []
    for o, stack in enumerate(octaves):
        chain_ms.append(time_ms(
            lambda: conv.octave_chain(bases[o], taps_list)))
        det_ms.append(time_ms(
            lambda: detect.detect_octave(stack, norms, p.key_levels, **dkw)))
        if o + 1 < len(octaves):
            down_ms.append(time_ms(
                lambda: conv.downsample2(stack[:, lds])))
    timing["octave_chain"] = dict(
        shape=list(octaves[0].shape), ms=chain_ms[0],
        path_ms=sum(chain_ms),
        plain_ms=time_ms(
            lambda: conv.octave_chain_plain(bases[0], taps_list)),
        library_ms=None,
        # reads the base once, writes L levels; per level 2 passes of taps
        bound=bound(4 * n0 * (1 + L), 4 * sum(chain_taps_n) * n0))
    src0 = octaves[0][:, lds]
    nq = BATCH * ((HEIGHT + 1) // 2) * ((WIDTH + 1) // 2)
    timing["downsample2"] = dict(
        shape=list(src0.shape), ms=down_ms[0], path_ms=sum(down_ms),
        plain_ms=time_ms(lambda: conv.downsample2_plain(src0)),
        # the one PyTorch call that computes the same function
        library_ms=time_ms(lambda: src0[..., ::2, ::2].contiguous()),
        # reads the kept quarter of the pixels, writes them; no arithmetic
        bound=bound(8 * nq, 0))
    timing["detect_octave"] = dict(
        shape=list(octaves[0].shape), ms=det_ms[0], path_ms=sum(det_ms),
        plain_ms=time_ms(lambda: detect.detect_octave_plain(
            octaves[0], norms, p.key_levels, **dkw)),
        library_ms=None,
        # reads L Gaussian planes, writes per key level 7 4-byte maps and
        # one byte map; about 13 float ops per response plane and pixel and
        # 170 per key level and pixel (27-neighbour test, edge test, 3x3
        # solve, typing, gradient)
        bound=bound(n0 * (4 * L + 29 * NK), n0 * (13 * L + 170 * NK)))
    emit("kernels",
         max_abs_err=errs, detect=detect_errs,
         exact=["blur", "octave_chain", "downsample2",
                "detect_octave: valid ftype response dx dy ds"],
         tolerances={"grad_rel": 1e-6, "rot_abs": 2e-6},
         keypoints_checked={"hessian": keys_h, "dog": keys_d},
         shapes_checked=checked,
         timing_ms={k: {kk: vv for kk, vv in v.items() if kk != "bound"}
                    for k, v in timing.items()},
         reps=REPS, l2_flushed=True)

    # ---- main path ----------------------------------------------------------
    def table_fields(t):
        return {f: getattr(t, f) for f in t._fields}

    def run_main(cfg, pinned):
        reset_launch_counts()
        table = detect_batch(imgs, cfg)              # device defaults to cuda
        torch.cuda.synchronize()
        launches = launch_counts()
        for name, n in launches.items():
            if n == 0:
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
    kernel_path_ms = sum(t["path_ms"] for t in timing.values())
    emit("main_path", detector="hessian", batch=BATCH, height=HEIGHT,
         width=WIDTH, launches=launches_h, keypoints=counts_h,
         frame0_keypoints=counts_h[0], equals_plain=True,
         frame0_equals_cpu=True,
         batch_seconds=iters, frames_per_s_best=BATCH / min(iters),
         frames_per_s_median=BATCH / statistics.median(iters),
         kernels_ms_per_batch=kernel_path_ms,
         max_memory_allocated=peak, input_seconds=round(input_seconds, 3))

    launches_d, counts_d = run_main(cfg_d, pinned=False)
    emit("main_path", detector="dog", batch=BATCH, launches=launches_d,
         keypoints=counts_d, equals_plain=True)

    # ---- result -------------------------------------------------------------
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches_h[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            "shape": t["shape"], "path_ms": t["path_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
