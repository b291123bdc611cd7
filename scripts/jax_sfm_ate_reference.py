#!/usr/bin/env python3
"""The JAX package's ATE on the synthetic TUM sequence that chip_smoke.py's
`sfm` phase reconstructs with the port: 40 frames at 640x480 rendered by
write_tum_sequence (seed 7), SiftConfig(threshold=0.003), every
reconstruct_sequence default, mesh=None (no distributed polish), or with
--mesh N an N-device "obs" mesh of CPU devices (every periodic and the
final BA end with the distributed LM polish, as chip_smoke.py's `sfm_mesh`).

    JAX_PLATFORMS=cpu python3 scripts/jax_sfm_ate_reference.py [out_dir] [--mesh N]

Prints one JSON line: ate, registered, points, seconds, the JAX backend,
the mesh. chip_smoke.py holds the port's ATE on the card to at most twice
the mesh=None figure.
"""

import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    args = sys.argv[1:]
    mesh_n = 0
    if "--mesh" in args:
        i = args.index("--mesh")
        mesh_n = int(args[i + 1])
        del args[i:i + 2]
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_force_host_platform_device_count="
                                   f"{mesh_n}")
    import jax

    from hessgpu_tpu.config import SiftConfig
    from hessgpu_tpu.parallel.distributed import device_mesh
    from hessgpu_tpu.sfm.datasets import (evaluate_sequence_ate,
                                          load_tum_sequence)
    from hessgpu_tpu.sfm.synthetic import write_tum_sequence

    out = args[0] if args else tempfile.mkdtemp(prefix="hessgpu_tum40_")
    t0 = time.perf_counter()
    meta = write_tum_sequence(out, n_frames=40, h=480, w=640)
    seq = load_tum_sequence(out)
    res = evaluate_sequence_ate(seq["image_paths"], seq["gt_centers"],
                                K=meta["K"], cfg=SiftConfig(threshold=0.003),
                                mesh=device_mesh("obs", mesh_n)
                                if mesh_n else None)
    print(json.dumps({
        "ate": float(res["ate"]), "registered": int(res["registered"]),
        "points": int(res.get("points", 0)), "frames": 40,
        "seconds": time.perf_counter() - t0,
        "backend": jax.default_backend(), "mesh": mesh_n,
        "root": os.path.abspath(out)}))


if __name__ == "__main__":
    main()
