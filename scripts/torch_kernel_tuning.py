#!/usr/bin/env python3
"""Registers, correctness and tile timings of the octave-chain,
orientation, descriptor and blur kernels (needs one CUDA device and nvcc).

    python3 scripts/torch_kernel_tuning.py [--quick] [--ptxas-log FILE]
                                           [--tiles 80x128,64x64,...]
                                           [--blur-blocks 2,3,4,5,6,8]
                                           [--blur-stages 2,3,4]
                                           [--ori-blocks 4,6,8,12,16]
                                           [--ori-ahead 1,2,4,8]
                                           [--old-patch OTHER/.../patch.cu]

Builds the kernel library with -Xptxas -v and prints each kernel's registers,
shared memory and spills; holds octave_chain against its plain version at
the main path's shapes, small and odd ones, a 33-tap chain that runs in
groups and an identity transition, and the chain's decimation epilogue
(octave_chain_into in place, every level decimated in turn) against the
plain decimation; holds orientation (default and single
mode, and on supports grown by sigma x 6) and descriptor against their plain
versions on the seeded 640x480 B=16 batch; then (unless --quick) times the
orientation kernel on the main path's table, on the same table with every
slot not valid and on the large supports: as built, with each blocks-per-SM
target of --ori-blocks, with each count of --ori-ahead rounds whose map
values are requested together, and with its tail cut off after the walk, after the
merge and after the smoothing (the walk's histograms kept live by a store,
so only the time is read); with --old-patch, the orientation kernel of that
copy of csrc/patch.cu (another tree's) as built and cut after its walk and
after its merge, in the same way; each kernel as built is timed again on the
main table five times as above, five times with the flush alone keeping the
card busy and five times warm, beside the host's time to enqueue one call.
It times the
descriptor on the full and on an all-invalid table, the host's planning of a
chain with and without its plan cache, the main path's chain per octave and
detector with and without its decimation epilogue, from a base (writing
level 0) and the standalone decimation beside it, and the chain per octave
and detector with the tile its cost model picks beside each tile of
--tiles. The kernel
has no argument that fixes its tile: for each tile the script compiles a copy
of csrc/conv.cu whose tile list is cut to that tile, and the chain is checked
and timed through it wherever that tile runs the octave in one launch. The
blur is timed the same way at 16 x 480 x 640 (13 and 33 taps) and 16 x 240 x
320: as built, with each pair of an input-buffer count of --blur-stages and
a blocks-per-SM target of --blur-blocks (the segment height), and with one
phase taken out of the kernel - the staging copies, the horizontal pass, the
vertical pass, the stores - to show what each costs (those copies compute
garbage; only their times are read). Times
are medians of CUDA-event timings with the L2 cache evicted and the card
kept busy ~1 ms before each launch. Prints JSON lines.
"""

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="build and check only, no timings")
    ap.add_argument("--ptxas-log", type=Path,
                    help="also write the compiler's whole output here")
    ap.add_argument("--tiles", default="80x128,64x128,96x128,128x96,64x160,"
                    "80x96,80x64,64x64,128x32,32x32",
                    help="rows x columns of the tiles to time beside the "
                    "cost model's choice")
    ap.add_argument("--blur-blocks", default="2,3,4,5,6,8",
                    help="blocks-per-SM targets of the blur's segment rule "
                    "to time beside the kernel's own")
    ap.add_argument("--blur-stages", default="2,3,4",
                    help="input buffers of the blur (copies run that many "
                    "steps minus one ahead) to time beside the kernel's own")
    ap.add_argument("--ori-blocks", default="4,6,12,16",
                    help="blocks-per-SM targets of the orientation kernel's "
                    "grid to time beside the kernel's own")
    ap.add_argument("--ori-ahead", default="1,2,8",
                    help="rounds of the orientation kernel's walk whose map "
                    "values are requested together, to time beside its own")
    ap.add_argument("--old-patch", type=Path,
                    help="another tree's csrc/patch.cu whose orientation "
                    "kernel (same C interface) is timed beside this one")
    args = ap.parse_args()

    import io
    from contextlib import redirect_stdout

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from hessgpu_tpu_torch import SiftConfig, make_plan
    from hessgpu_tpu_torch import pyramid as tpyr
    from hessgpu_tpu_torch.ops import gaussian
    from hessgpu_tpu_torch.ops.cuda import build, conv, patch
    from hessgpu_tpu_torch.ops.orientation import peaks_from_votes
    from hessgpu_tpu_torch.params import gaussian_taps
    from hessgpu_tpu_torch.sfm.synthetic import texture_frame

    def emit(what, **fields):
        print(json.dumps({"what": what, **fields}), flush=True)

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    emit("card", nvidia_smi=smi.stdout.strip())

    # ---- ptxas ------------------------------------------------------------
    log = io.StringIO()
    with redirect_stdout(log):
        build.build(verbose=True)
    if args.ptxas_log:
        args.ptxas_log.parent.mkdir(parents=True, exist_ok=True)
        args.ptxas_log.write_text(log.getvalue())
    def report_ptxas(text, variant="built"):
        name = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                smem = re.search(r"(\d+) bytes smem", line)
                emit("ptxas", variant=variant, kernel=name,
                     registers=int(m.group(1)),
                     static_smem=int(smem.group(1)) if smem else 0)
            if "spill" in line and name and \
                    "0 bytes spill stores, 0 bytes spill loads" not in line:
                emit("ptxas_spill", variant=variant, kernel=name,
                     line=line.strip())

    report_ptxas(log.getvalue())
    emit("build", seconds=build.build_seconds)

    flush_buf = torch.empty(512 * 1024 * 1024, dtype=torch.int8, device=dev)

    def time_ms(fn, reps=10, flush=True, sleep=2_000_000):
        """Median of reps CUDA-event timings after 3 warm-up calls. Before
        each, a 512 MB write evicts the L2 and keeps the card busy (about
        0.16 ms), and `sleep` cycles of torch.cuda._sleep (~1 ms) keep it
        busy longer, while the host enqueues the launch; with flush=False
        the launch finds what the previous one left in the L2."""
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            if flush:
                flush_buf.zero_()
            if sleep:
                torch.cuda._sleep(sleep)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    # ---- chain: correctness -----------------------------------------------
    rng = np.random.RandomState(3)
    bad = 0
    taps = {d: gaussian.chain_taps(SiftConfig(detector=d).scale_params())
            for d in ("hessian", "dog")}
    wide = [gaussian_taps(5.0)] * 4
    cases = []
    for shape in [(16, 480, 640), (16, 240, 320), (16, 120, 160),
                  (16, 60, 80), (16, 30, 40), (2, 101, 75), (3, 30, 40)]:
        for d in ("hessian", "dog"):
            cases.append((shape, d, taps[d]))
    cases += [((2, 200, 264), "33x4", wide),
              ((3, 30, 40), "33x4", wide),
              ((2, 200, 264), "hessian", taps["hessian"]),
              ((2, 200, 264), "dog", taps["dog"]),
              ((1, 101, 75), "identity",
               [taps["hessian"][0], (), taps["hessian"][1]])]
    for shape, label, tl in cases:
        x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dev)
        got = conv.octave_chain(x, tl)
        want = conv.octave_chain_plain(x, tl)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        bad += not equal
        # the epilogue: each level in turn decimated into a plane of a stack
        B, H, W = shape
        dec_equal = []
        for level in range(1 + len(tl)):
            stack = torch.empty_like(want)
            stack[:, 0] = x
            nxt = torch.full((B, 2, H // 2, W // 2), float("nan"),
                             device=dev)
            conv.octave_chain_into(stack, tl, decimate_level=level,
                                   next_base=nxt[:, 0])
            dec = conv.downsample2_plain(want[:, level])[..., :H // 2,
                                                         :W // 2]
            dec_equal.append(bool(torch.equal(stack, want))
                             and bool(torch.equal(nxt[:, 0], dec))
                             and bool(nxt[:, 1].isnan().all()))
        bad += not all(dec_equal)
        emit("chain_check", shape=shape, taps=label, equal=equal,
             device_launches=conv.octave_chain_groups(x, tl),
             max_abs_err=float((got - want).abs().max()),
             decimation_equal_by_level=dec_equal)

    # ---- descriptor: correctness ------------------------------------------
    frames = np.stack([texture_frame(seed) for seed in range(16)])
    imgs = torch.from_numpy(frames).to(dev)
    scenes, ori_scenes = {}, {}

    def ori_check(det, t, maps, owin, **mode):
        """The orientation kernel against its plain version on one table;
        returns whether it passed (NaN equals NaN: a histogram of zeros has
        a NaN single-mode theta on both routes)."""
        a = (t.x, t.y, t.sigma, t.valid, t.level_id, maps, owin)
        got = patch.orientation(*a, return_votes=True, **mode)
        again = patch.orientation(*a, return_votes=True, **mode)
        want = patch.orientation_plain(*a, **mode)
        torch.cuda.synchronize()
        scale = want.votes.amax(-1, keepdim=True).clamp_min(1e-30)
        rel = float(((got.votes - want.votes).abs() / scale).max())
        single = mode.get("single", False) or mode.get("max_peaks", 4) <= 1
        th, ov = peaks_from_votes(got.votes, single=single,
                                  max_peaks=mode.get("max_peaks", 4))
        inv = ~t.valid[..., None]
        same = lambda x, y: bool(((x == y) | (x.isnan() & y.isnan())).all())
        same_bits = all(same(x, y) for x, y in zip(got, again)
                        if x is not None)
        zeros = not any(bool(x[~t.valid].any()) for x in got
                        if x is not None)
        own_peaks = torch.equal(ov & ~inv, got.valid) and same(
            th.masked_fill(inv, 0.0), got.thetas)
        ok = rel <= 2e-5 and same_bits and zeros and own_peaks
        emit("orientation_check", detector=det, mode=mode,
             slots=list(t.x.shape), keypoints=int(t.valid.sum()),
             max_sigma=float(t.sigma[t.valid].max()),
             voting_pixels=int(want.support.sum()), votes_max_rel_err=rel,
             same_bits_twice=same_bits, zeros_on_invalid=zeros,
             thetas_from_own_votes=own_peaks, ok=ok)
        return ok
    for det in ("hessian", "dog"):
        cfg = SiftConfig(detector=det)
        plan = make_plan(480, 640, cfg)
        t, maps, _ = tpyr.detect_from_octaves(
            tpyr._build_pyramid(imgs, plan, cfg), plan, cfg)
        p = cfg.scale_params()
        owin, dwin = tpyr.window_sizes(
            cfg, p.key_level_sigma(p.key_levels[-1]) * p.sigmak)
        ori = patch.orientation(t.x, t.y, t.sigma, t.valid, t.level_id, maps,
                                owin, max_peaks=cfg.max_orientations)
        big = t._replace(sigma=(t.sigma * 6.0).contiguous())
        big_win = tpyr.window_sizes(cfg, float(big.sigma[big.valid].max()))[0]
        for tab, win in ((t, owin), (big, big_win)):
            for mode in (dict(max_peaks=cfg.max_orientations),
                         dict(single=True)):
                bad += not ori_check(det, tab, maps, win, **mode)
        ori_scenes[det] = (t, big, maps, owin, big_win, cfg.max_orientations)
        g_exp = int(t.x.shape[-1] * cfg.expansion_factor + 7) // 8 * 8
        te = tpyr._expand_orientations(t, ori.thetas, ori.valid, g_exp)
        a = (te.x, te.y, te.sigma, te.theta, te.valid, te.level_id, maps, dwin)
        got = patch.descriptor(*a)
        again = patch.descriptor(*a)
        want = patch.descriptor_plain(*a)
        torch.cuda.synchronize()
        scale = want.abs().amax((-2, -1), keepdim=True).clamp_min(1e-30)
        rel = float(((got - want).abs() / scale).max())
        ok = rel <= 2e-5 and bool(torch.equal(got, again)) \
            and not bool(got[~te.valid].any())
        bad += not ok
        emit("descriptor_check", detector=det, slots=list(te.x.shape),
             features=int(te.valid.sum()), raw_max_rel_err=rel,
             same_bits_twice=bool(torch.equal(got, again)),
             zeros_on_invalid=not bool(got[~te.valid].any()))
        scenes[det] = (a, te)
    if bad:
        sys.exit(f"{bad} checks failed")
    if args.quick:
        return
    torch.cuda.synchronize()

    # ---- timings ----------------------------------------------------------
    for det, (a, te) in scenes.items():
        none = torch.zeros_like(te.valid)
        emit("descriptor_ms", detector=det, features=int(te.valid.sum()),
             ms=time_ms(lambda: patch.descriptor(*a)),
             empty_table_ms=time_ms(lambda: patch.descriptor(
                 *a[:4], none, *a[5:])))
    # what a launch costs before any filtering, and what a transition adds
    th_ = taps["hessian"]
    for shape in [(16, 30, 40), (16, 480, 640)]:
        x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dev)
        emit("chain_parts_ms", shape=shape,
             copy_only=time_ms(lambda: conv.octave_chain(x, [])),
             taps_11=time_ms(lambda: conv.octave_chain(x, th_[:1])),
             taps_21=time_ms(lambda: conv.octave_chain(x, th_[3:])),
             taps_11_13=time_ms(lambda: conv.octave_chain(x, th_[:2])),
             blur_11=time_ms(lambda: conv.blur(x, th_[0])),
             blur_21=time_ms(lambda: conv.blur(x, th_[3])))
    # the host's planning of one chain: a new batch size each time misses the
    # plan cache, the same arguments again hit it
    probe = torch.empty((1, 480, 640), device=dev)
    t0 = time.perf_counter()
    for b in range(1, 65):
        conv.octave_chain_groups(probe.expand(b, -1, -1), th_)
    miss = (time.perf_counter() - t0) / 64
    t0 = time.perf_counter()
    for _ in range(64):
        conv.octave_chain_groups(probe, th_)
    hit = (time.perf_counter() - t0) / 64
    emit("chain_plan_host_us", cache_miss=miss * 1e6, cache_hit=hit * 1e6)

    octaves = [(16, 480, 640), (16, 240, 320), (16, 120, 160), (16, 60, 80),
               (16, 30, 40)]
    inputs = {shape: torch.from_numpy(
        rng.rand(*shape).astype(np.float32)).to(dev) for shape in octaves}
    rows = {(det, shape): {"chosen": time_ms(
        lambda: conv.octave_chain(inputs[shape], taps[det]))}
        for det in taps for shape in octaves}

    # The main path's chain with and without its decimation epilogue (level
    # level_ds into a plane of a stack of the next octave's shape), in place,
    # in turns (with, without, without, with) of 20 timed launches each; the
    # chain from a base (the standalone contract, level 0 written) and the
    # standalone decimation of the same level beside them.
    for det, tl in taps.items():
        q = SiftConfig(detector=det).scale_params()
        lds = q.level_ds - q.level_min
        for shape in octaves:
            x = inputs[shape]
            work = torch.empty((shape[0], 1 + len(tl)) + shape[1:],
                               device=dev)
            work[:, 0] = x
            nxt = torch.empty((shape[0], 2, shape[1] // 2, shape[2] // 2),
                              device=dev)
            fused = lambda: conv.octave_chain_into(
                work, tl, decimate_level=lds, next_base=nxt[:, 0])
            alone = lambda: conv.octave_chain_into(work, tl)
            turns = [time_ms(f, reps=20) for f in (fused, alone, alone,
                                                   fused)]
            emit("chain_epilogue_ms", detector=det, shape=shape,
                 with_decimation=[turns[0], turns[3]],
                 without_decimation=[turns[1], turns[2]],
                 epilogue=(turns[0] + turns[3] - turns[1] - turns[2]) / 2,
                 from_base=time_ms(lambda: conv.octave_chain(x, tl)),
                 standalone_downsample2=time_ms(
                     lambda: conv.downsample2(work[:, lds])))

    # A copy of a source with some of its text replaced, compiled into a
    # library of its own that takes the place of the wrappers' library.
    nvcc = build._find_nvcc()

    def load_variant(name, text):
        cu = build.BUILD_DIR / f"{name}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        r = subprocess.run([nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v",
                            "-shared", str(cu), "-o", str(so)],
                           capture_output=True, text=True, check=True)
        if name.startswith("ori_"):
            report_ptxas(r.stdout + r.stderr, name)
        build._lib = ctypes.CDLL(str(so))
        build._functions.clear()

    def edited(text, name, pairs):
        for old, new in pairs:
            if text.count(old) != 1:
                sys.exit(f"variant {name}: {old!r} is not there once")
            text = text.replace(old, new)
        return text

    # ---- orientation: grid and phases, this tree's kernel and another's ----
    t, big, omaps, owin, big_win, mp = ori_scenes["hessian"]
    none = torch.zeros_like(t.valid)
    oargs = (t.x, t.y, t.sigma, t.valid, t.level_id, omaps, owin)
    ref = patch.orientation(*oargs, max_peaks=mp, return_votes=True)

    def ori_times(variant, exact, spread=False):
        if exact:   # any grid gives the built kernel's bits
            got = patch.orientation(*oargs, max_peaks=mp, return_votes=True)
            if not all(torch.equal(a, b) for a, b in zip(got, ref)
                       if a is not None):
                sys.exit(f"orientation {variant}: differs from the built "
                         "kernel")
        emit("orientation_ms", variant=variant,
             keypoints=int(t.valid.sum()),
             ms=time_ms(lambda: patch.orientation(*oargs, max_peaks=mp)),
             empty_table_ms=time_ms(lambda: patch.orientation(
                 *oargs[:3], none, *oargs[4:], max_peaks=mp)),
             large_support_ms=time_ms(lambda: patch.orientation(
                 big.x, big.y, big.sigma, big.valid, big.level_id, omaps,
                 big_win, max_peaks=mp)))
        if spread:
            # The main table again, five times each: as above; with the flush
            # alone keeping the card busy (the timer of chip_smoke.py before
            # it slept too), so that a host slower to enqueue the launch than
            # the flush lasts enters the time; and warm. And the host's time
            # to enqueue one call.
            run = lambda: patch.orientation(*oargs, max_peaks=mp)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                run()
            host_us = (time.perf_counter() - t0) / 50 * 1e6
            torch.cuda.synchronize()
            emit("orientation_spread_ms", variant=variant,
                 host_us_per_call=host_us,
                 cold=[time_ms(run) for _ in range(5)],
                 cold_flush_only=[time_ms(run, sleep=0) for _ in range(5)],
                 warm=[time_ms(run, flush=False) for _ in range(5)])

    ori_times("built", True, spread=True)
    psrc = (build.CSRC_DIR / "patch.cu").read_text()
    for knob, label, values in (("kOriBlocksPerSM", "blocks_per_sm",
                                 args.ori_blocks),
                                ("kOriAhead", "ahead", args.ori_ahead)):
        m = re.search(r"constexpr int %s = (\d+);" % knob, psrc)
        if not m:
            sys.exit(f"patch.cu: no {knob} to replace")
        for v in map(int, values.split(",")):
            if v != int(m.group(1)):
                name = f"ori_{label}_{v}"
                load_variant(name, edited(psrc, name, [(
                    m.group(0), f"constexpr int {knob} = {v};")]))
                ori_times(name, True)
    # the tail taken off: each cut keeps what came before live by a store
    keep = "if (lane < 4) o_theta[(long long)slot * 4 + lane] = {};\n" \
           "            continue;\n"
    cuts = [
        ("ori_walk_only", "            // Merge: lane l < 18", "hist[lane]"),
        ("ori_walk_merge", "            // 6 rounds of circular", "lo + hi"),
        ("ori_walk_merge_smooth", "            // the first maximum",
         "lo + hi")]
    for name, at, value in cuts:
        load_variant(name, edited(psrc, name, [
            (at, "            " + keep.format(value) + at)]))
        ori_times(name, False)
    if args.old_patch:
        old = args.old_patch.read_text()
        keep_old = ("    if (lane < 4) "
                    "o_theta[(long long)slot * 4 + lane] = {};\n"
                    "    return;\n")
        for name, pairs in [
                ("ori_old_built", []),
                ("ori_old_walk_only", [(
                    "    __syncwarp();\n    float* v = vbuf[warp][0];",
                    "    __syncwarp();\n" + keep_old.format("hw[lane]")
                    + "    float* v = vbuf[warp][0];")]),
                ("ori_old_walk_merge", [(
                    "    __syncwarp();\n    if (lane != 0) return;",
                    "    __syncwarp();\n" + keep_old.format("v[lane]"))])]:
            load_variant(name, edited(old, name, pairs))
            ori_times(name, False, spread=not pairs)

    source = (build.CSRC_DIR / "conv.cu").read_text()

    # ---- blur: segment rule and phases ------------------------------------
    t13 = gaussian_taps(SiftConfig().scale_params().initial_blur_sigma(0))
    bx = {s: torch.from_numpy(rng.rand(*s).astype(np.float32)).to(dev)
          for s in [(16, 480, 640), (16, 240, 320)]}
    bcases = [("480x640_13", bx[(16, 480, 640)], t13),
              ("480x640_33", bx[(16, 480, 640)], gaussian_taps(5.0)),
              ("240x320_13", bx[(16, 240, 320)], t13)]
    knobs = {k: re.search(r"constexpr int %s = (\d+);" % k, source)
             for k in ("kBlurStages", "kBlurBlocksPerSM")}
    if not all(knobs.values()):
        sys.exit("conv.cu: no kBlurStages / kBlurBlocksPerSM to replace")
    built = {k: int(m.group(1)) for k, m in knobs.items()}
    variants = [("built", [])]
    for st in sorted({built["kBlurStages"],
                      *map(int, args.blur_stages.split(","))}):
        for bps in sorted({built["kBlurBlocksPerSM"],
                           *map(int, args.blur_blocks.split(","))}):
            if (st, bps) != (built["kBlurStages"], built["kBlurBlocksPerSM"]):
                variants.append((f"stages_{st}_blocks_per_sm_{bps}", [
                    (knobs["kBlurStages"].group(0),
                     f"constexpr int kBlurStages = {st};"),
                    (knobs["kBlurBlocksPerSM"].group(0),
                     f"constexpr int kBlurBlocksPerSM = {bps};")]))
    variants += [   # a condition that never holds takes a phase out
        ("no_staging", [("e < rows * iw;", "e < rows * iw && H < 0;")]),
        ("no_horizontal_pass", [("if (lane < rows) {",
                                 "if (lane < rows && H < 0) {")]),
        ("no_vertical_pass", [("K; y < oend;", "K; y < oend && H < 0;")]),
        ("no_stores", [("if (gx < W) {",
                        "if (gx < W && acc[0] == -1.5f) {")])]
    for name, pairs in variants:
        load_variant(f"conv_blur_{name}", edited(source, name, pairs))
        row = {"segment_rows": conv.blur_segment_rows(bx[(16, 480, 640)])}
        for label, x, tp in bcases:
            if not name.startswith("no_") and not torch.equal(
                    conv.blur(x, tp), conv.blur_plain(x, tp)):
                sys.exit(f"blur {name}: differs from the plain blur at "
                         f"{label}")
            row[label] = time_ms(lambda: conv.blur(x, tp))
        emit("blur_ms", variant=name, **row)

    # One tile at a time: a copy of conv.cu whose tile list holds that tile
    # only.
    for name in args.tiles.split(","):
        th, tw = map(int, name.split("x"))
        text = source
        for array, value in (("kTileH", th), ("kTileW", tw)):
            text, n = re.subn(r"constexpr int %s\[\] = \{[^}]*\};" % array,
                              "constexpr int %s[] = {%d};" % (array, value),
                              text)
            if n != 1:
                sys.exit(f"conv.cu: no tile list {array} to replace")
        load_variant(f"conv_tile_{name}", text)
        for (det, shape), row in rows.items():
            # the whole chain must fit one launch's shared memory (else the
            # kernel runs it in groups, or refuses a single transition)
            halo = sum(len(tp) // 2 for tp in taps[det])
            rows0 = min(shape[1], th + 2 * halo)
            cols0 = min(shape[2], tw + 2 * halo)
            cols1 = min(shape[2], tw + 2 * (halo - len(taps[det][0]) // 2))
            if 4 * (rows0 * ((cols0 | 1) + (cols1 | 1)) + 8 * 33) > 232448:
                continue
            x = inputs[shape]
            if conv.octave_chain_groups(x, taps[det]) != 1:
                continue
            if not torch.equal(conv.octave_chain(x, taps[det]),
                               conv.octave_chain_plain(x, taps[det])):
                sys.exit(f"tile {name}: chain differs at {shape} ({det})")
            row[name] = time_ms(lambda: conv.octave_chain(x, taps[det]),
                                reps=5)
    for (det, shape), row in rows.items():
        emit("chain_ms", detector=det, shape=shape, **row)

if __name__ == "__main__":
    main()
