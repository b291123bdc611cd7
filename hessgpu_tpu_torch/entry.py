"""Entry points (counterpart of the JAX package's __graft_entry__.py).

entry():            a one-image detect + describe forward step.
dryrun_multichip(): one step of every multi-device path over an n-shard
                    mesh: batch detect, match_sharded, sharded_blur,
                    sharded_detect_and_describe and bundle_adjust_sharded.

    python -m hessgpu_tpu_torch.entry [--device cuda|cpu] [--shards 8]

runs the dry run on an in-process mesh of 8 shards on one device.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from .config import SiftConfig
from .parallel.batch import detect_batch
from .parallel.distributed import DeviceMesh, local_mesh, match_sharded
from .parallel.spatial import sharded_blur, sharded_detect_and_describe
from .pyramid import make_plan, resolve_device, run_pipeline
from .sfm.ba import BAProblem, BAState
from .sfm.distributed_ba import bundle_adjust_sharded


def _make_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).rand(h, w).astype(np.float32)


def entry(device="cuda"):
    """Returns (fn, example_args): the forward step of one 480x640 image
    under the default SiftConfig, fn(img) -> (x, y, sigma, theta, desc,
    valid)."""
    cfg = SiftConfig()
    h, w = 480, 640
    plan = make_plan(h, w, cfg)

    def forward(img):
        table, _ = run_pipeline(img, plan, cfg)
        return (table.x, table.y, table.sigma, table.theta, table.desc,
                table.valid)

    img = torch.from_numpy(_make_image(h, w)).to(resolve_device(device))
    return forward, (img,)


def dryrun_multichip(n_devices: int, mesh: Optional[DeviceMesh] = None,
                     device="cuda") -> dict:
    """One step of each multi-device path on an n_devices-shard mesh (an
    in-process mesh on `device` unless a mesh is given), at the JAX
    package's dry-run sizes. Returns the per-frame feature counts, the
    number of matches, the spatial table's count and the BA's cost."""
    dev = resolve_device(device)
    mesh = mesh or local_mesh(n_devices)
    if mesh.size != n_devices:
        raise ValueError(f"the mesh has {mesh.size} shards, not {n_devices}")
    n = n_devices

    # data-parallel detect + describe: the batch split over the shards
    cfg = SiftConfig(max_level_features=64)
    imgs = np.stack([_make_image(64, 64, seed=i) for i in range(n)])
    table = detect_batch(imgs, cfg, mesh=mesh, device=dev)
    counts = table.count().cpu()
    assert counts.shape == (n,)

    # the matcher: rows split over the shards, column statistics gathered
    d1 = np.random.RandomState(0).randint(0, 100, (n * 16, 128)) \
        .astype(np.uint8)
    m = match_sharded(d1, d1, mesh, mutual_best=True, device=dev)
    assert m.shape == (n * 16,)

    # row-sharded blur with halo exchange
    big = _make_image(8 * n, 64, seed=3)
    blurred = sharded_blur(big, 1.6, mesh, device=dev)
    assert blurred.shape == big.shape

    # row-sharded detect + describe (the -maxd replacement)
    cfg_sp = SiftConfig(max_level_features=64, num_octaves=1,
                        threshold=0.001)
    res = sharded_detect_and_describe(_make_image(48 * n, 64, seed=4),
                                      cfg_sp, mesh, device=dev)
    assert bool(torch.isfinite(res.desc).all())

    # distributed bundle adjustment: observations sharded over the mesh
    rng = np.random.RandomState(1)
    n_obs, n_pts = 8 * n, 16
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    st = BAState(R=torch.eye(3, device=dev).expand(2, 3, 3).contiguous(),
                 t=f32(rng.rand(2, 3) * 0.1),
                 X=f32(rng.rand(n_pts, 3) + [[0, 0, 4.0]]),
                 intr=torch.full((2, 3), 60.0, device=dev))
    prob = BAProblem(
        cam_idx=torch.as_tensor(rng.randint(0, 2, n_obs), device=dev),
        pt_idx=torch.as_tensor(rng.randint(0, n_pts, n_obs), device=dev),
        uv=f32(rng.rand(n_obs, 2) * 64),
        weight=torch.ones(n_obs, device=dev))
    out, cost = bundle_adjust_sharded(st, prob, mesh, iterations=2)
    assert bool(torch.isfinite(out.X).all())

    result = {"counts": counts.tolist(), "matches": int((m >= 0).sum()),
              "spatial_count": int(res.count()), "ba_cost": cost}
    print(f"dryrun_multichip({n}): ok, counts={result['counts']}")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=8)
    args = ap.parse_args(argv)
    dryrun_multichip(args.shards, device=args.device)


if __name__ == "__main__":
    main()
