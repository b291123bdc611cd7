"""hess: batch detect+describe CLI of the PyTorch/CUDA port (counterpart of
hessgpu_tpu/cli/hess.py, the same flags and files).

  python -m hessgpu_tpu_torch.cli.hess -i img1.pgm img2.pgm ... [-o out.sift]
      [--device cpu|cuda] [sift options]

Port of the reference `hess` tool (src/HessGPU/hessgpucmd.cpp):
  hess -i img1.jpg img2.jpg ... [-o out.sift] [sift options]
  hess -il list.txt [sift options]
  hess -time: write per-stage CSV to <img>.timings (hessgpucmd.cpp:84-192)
  hess -speed: average 10 reruns and report Hz (hessgpucmd.cpp:246-300)
It runs on the card (--device cuda, the default) unless --device cpu asks
for the CPU.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List


def parse_cli(argv: List[str]):
    """Split hess-specific options from detector options."""
    images: List[str] = []
    out_path = None
    do_time = False
    do_speed = False
    dump_dir = None
    device = "cuda"
    rest: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-i":
            i += 1
            while i < len(argv) and not argv[i].startswith("-"):
                images.append(argv[i])
                i += 1
            continue
        elif a == "-il":
            i += 1
            list_path = argv[i]
            base = os.path.dirname(os.path.abspath(list_path))
            with open(list_path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        images.append(line if os.path.isabs(line)
                                      else os.path.join(base, line))
        elif a == "-o":
            i += 1
            out_path = argv[i]
        elif a == "-time":
            do_time = True
        elif a == "-speed":
            do_speed = True
        elif a == "--dump-intermediates":
            # reference DEBUG_SIFTGPU texture dumps (SiftPyramid.cpp:573-635)
            # + the 7 viewer views, as PNGs per image
            i += 1
            dump_dir = argv[i]
        elif a == "--device":
            i += 1
            device = argv[i]
        else:
            rest.append(a)
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                # keep option values attached
                rest.append(argv[i + 1])
                i += 1
        i += 1
    return images, out_path, do_time, do_speed, dump_dir, device, rest


HELP = """hess - Hessian/SIFT detect+describe (reference SiftGPU.cpp:789-846 flags)
-h -help            : this message
-i <strings>        : input image file(s)
-il <string>        : image list file
-o <string>         : save SIFT features (single input image)
-f <float>          : filter width factor (default 4.0)
-w <float>          : orientation window factor (default 2.0)
-dw <float>         : descriptor grid size factor (default 3.0)
-fo <int>           : first octave (default 0)
-no <int>           : max number of octaves
-d <int>            : levels per octave (default 3)
-t <float>          : response threshold (default 0.02/3)
-e <float>          : edge threshold (default 10.0)
-m <int=2>          : max orientations per keypoint (1..4)
-s <int=1>          : subpixel/subscale localization
-da                 : darkness adaption (hessian personality)
-dog / -hessian     : detector personality (default hessian; reference
                      picks this at build time via config.h GPU_HESSIAN)
-sd                 : skip descriptors
-unn                : unnormalized descriptors
-b / -bvlf          : binary / vlfeat output format
-half               : half SIFT (fold opposite gradients)
-tc[1|2|3] <int>    : limit feature count (3 truncation methods)
-topk <int>         : keep K strongest distinct keypoints
-maxd <int>         : max working dimension
-loweo              : (0,0) at center of top-left pixel
-ofix / -ofix-not   : fixed zero orientation on/off
-v <int>            : verbosity (per-level feature counts at >=2)
-time               : per-stage CSV to <img>.timings
-speed              : 2x30-rerun speed protocol
--dump-intermediates <dir> : viewer views as PNGs
--device <cpu|cuda> : where to run (default cuda; no card raises)"""


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if any(a in ("-h", "-help", "--help") for a in argv):
        print(HELP)
        return 0
    from hessgpu_tpu_torch import HessianSift, SiftConfig

    images, out_path, do_time, do_speed, dump_dir, device, rest = \
        parse_cli(argv)
    if not images:
        print("usage: hess (-i <images...> | -il <list>) [-o out.sift] "
              "[-time] [-speed] [sift options]", file=sys.stderr)
        return 1

    cfg = SiftConfig.parse_args(rest)
    sift = HessianSift(cfg, device=device)

    for idx, img_path in enumerate(images):
        if do_speed:
            # reference speed protocol: warm-up, then 2 sets of 30 reruns
            # with a per-run feature-count determinism check ("+" match /
            # "e" mismatch), reporting Hz per set (speed.cpp:60-160)
            feats = sift.run(img_path)  # warmup/compile
            num0 = feats["x"].shape[0]
            speed_sets = []
            for s in range(2):
                n_runs = 30
                marks = []
                t0 = time.perf_counter()
                for _ in range(n_runs):
                    feats = sift.run(img_path)
                    marks.append("+" if feats["x"].shape[0] == num0 else "e")
                dt = time.perf_counter() - t0
                speed_sets.append((n_runs / dt, 1000 * dt / n_runs))
                print(f"{img_path} [set {s + 1}] {''.join(marks)} "
                      f"{num0} features, {n_runs / dt:.2f} Hz "
                      f"({1000 * dt / n_runs:.1f} ms/img)")
            # reference exports the accumulated stage timings as CSV in
            # speed mode too (hessgpucmd.cpp:246-300, timingsSuffix file)
            with open(os.path.splitext(img_path)[0] + ".speed.csv",
                      "w") as f:
                f.write("set,hz,ms_per_img,features\n")
                for s, (hz, ms) in enumerate(speed_sets):
                    f.write(f"{s + 1},{hz:.2f},{ms:.2f},{num0}\n")
                rep = sift.device_stage_report(img_path)
                f.write(",".join(rep.keys()) + "\n")
                f.write(",".join(f"{v:.3f}" for v in rep.values()) + "\n")
        else:
            feats = sift.run(img_path)
            if cfg.verbose:
                print(f"{img_path}: #Features: {feats['x'].shape[0]}")

        target = out_path if (out_path and len(images) == 1) else None
        if target is None:
            root, _ = os.path.splitext(img_path)
            target = root + ".sift"
        sift.save_sift(target)

        if do_time:
            with open(os.path.splitext(img_path)[0] + ".timings", "w") as f:
                f.write(sift.timer.csv())
                # reference-grade per-stage granularity (TIMINGS_* buckets,
                # config.h:17-31): device time per stage of the replayed
                # graph (CPU time with --device cpu)
                rep = sift.device_stage_report(img_path)
                f.write(",".join(rep.keys()) + "\n")
                f.write(",".join(f"{v:.3f}" for v in rep.values()) + "\n")

        if dump_dir:
            from ..utils.viz import dump_views
            from ..io_image import load_image
            sub = os.path.join(
                dump_dir,
                os.path.splitext(os.path.basename(img_path))[0])
            dump_views(load_image(img_path), cfg, out_dir=sub, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
