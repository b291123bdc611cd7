#!/usr/bin/env python3
"""The JAX package's ATE on the synthetic TUM sequence that chip_smoke.py's
`sfm` phase reconstructs with the port: 40 frames at 640x480 rendered by
write_tum_sequence (seed 7), SiftConfig(threshold=0.003), every
reconstruct_sequence default, mesh=None (no distributed polish).

    JAX_PLATFORMS=cpu python3 scripts/jax_sfm_ate_reference.py [out_dir]

Prints one JSON line: ate, registered, points, seconds, the JAX backend.
chip_smoke.py holds the port's ATE on the card to at most twice this figure.
"""

import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    import jax

    from hessgpu_tpu.config import SiftConfig
    from hessgpu_tpu.sfm.datasets import (evaluate_sequence_ate,
                                          load_tum_sequence)
    from hessgpu_tpu.sfm.synthetic import write_tum_sequence

    out = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp(
        prefix="hessgpu_tum40_")
    t0 = time.perf_counter()
    meta = write_tum_sequence(out, n_frames=40, h=480, w=640)
    seq = load_tum_sequence(out)
    res = evaluate_sequence_ate(seq["image_paths"], seq["gt_centers"],
                                K=meta["K"], cfg=SiftConfig(threshold=0.003))
    print(json.dumps({
        "ate": float(res["ate"]), "registered": int(res["registered"]),
        "points": int(res.get("points", 0)), "frames": 40,
        "seconds": time.perf_counter() - t0,
        "backend": jax.default_backend(), "root": os.path.abspath(out)}))


if __name__ == "__main__":
    main()
