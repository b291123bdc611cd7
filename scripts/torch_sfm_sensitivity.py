#!/usr/bin/env python3
"""How far the port's reconstruction of chip_smoke.py's sfm sequence moves
when the first fundamental RANSAC's F moves by one float32 ulp, and at
which step the move grows.

    python3 scripts/torch_sfm_sensitivity.py [--device cpu|cuda] \
        [--entries 9] [--features FILE] [--out FILE]

The sequence is chip_smoke.py's (write_tum_sequence's scene, seed 7, 40
frames at 640x480, SiftConfig(threshold=0.003)); it is detected once on
--device, or loaded from --features (an .npz this script wrote; written
where it does not exist yet). Then reconstruct_sequence runs with its
defaults and the JAX package's draws: once as it is (the base run), then
once for each of 2 x --entries variants, in which entry k (row-major) of
the init pair's F is moved one ulp up or down (torch.nextafter) before the
essential matrix and the pose are formed from it.

Each run records its steps in order: every fundamental RANSAC (its
inliers), every PnP registration (its inliers and the camera's centre),
every global BA (periodic and final) and the loop closure (the centres of
the cameras so far and their ATE against the ground truth). A variant's
step is held to the base run's step of the same kind and rank: how many
inliers changed (-1: a different number of correspondences), the largest
distance between the two runs' centres of the same views in the
reconstruction's own units (camera 0 at the origin, but scale and
rotation are free in the BAs, so this grows along the gauge), and, at a
BA or the loop closure, `aligned_moved`: the RMS distance between the two
runs' centres of the same views, each run aligned to the ground truth by
its own similarity (the ATE's units, where the trajectory's shape
differs). One JSON line a run: its ATE, the first step whose inliers
changed, the first step whose aligned centres moved by more than 1e-3,
and the steps; a last line sums up how many variants end above
chip_smoke.py's limit (twice JAX_SFM_ATE). --out also writes the lines.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import JAX_SFM_ATE  # noqa: E402
from hessgpu_tpu_torch import HessianSift, SiftConfig  # noqa: E402
from hessgpu_tpu_torch.sfm import incremental  # noqa: E402
from hessgpu_tpu_torch.sfm.evaluate import (  # noqa: E402
    ate_rmse, camera_centers, umeyama_alignment)
from hessgpu_tpu_torch.sfm.synthetic import tum_sequence  # noqa: E402

MOVED = 1e-3


def features(path, device):
    frames, K, _, centers = tum_sequence(40, 480, 640)
    if path is not None and path.exists():
        z = np.load(path)
        feats = [{} for _ in frames]
        for key in z.files:
            i, k = key.split("_", 1)
            feats[int(i)][k] = z[key]
        return feats, K, centers
    sift = HessianSift(SiftConfig(threshold=0.003), device=device)
    feats = [sift.run(f) for f in frames]
    if path is not None:
        np.savez(path, **{f"{i}_{k}": v for i, f in enumerate(feats)
                          for k, v in f.items()
                          if isinstance(v, np.ndarray)})
    return feats, K, centers


class Recorder:
    """The hooks of one run: the steps it took, and the perturbation of the
    first F (entry, direction), or none."""

    def __init__(self, centers, nudge=None):
        self.gt, self.nudge, self.steps = centers, nudge, []
        self.real = {k: getattr(incremental, k) for k in (
            "ransac_fundamental_from_samples", "_pnp_register",
            "run_global_ba", "_close_loops")}

    def __enter__(self):
        for k in self.real:
            setattr(incremental, k, getattr(self, k))
        return self

    def __exit__(self, *exc):
        for k, v in self.real.items():
            setattr(incremental, k, v)

    def ransac_fundamental_from_samples(self, *a, **kw):
        res = self.real["ransac_fundamental_from_samples"](*a, **kw)
        first = not any(s["kind"] == "fundamental" for s in self.steps)
        if first and self.nudge is not None:
            k, up = self.nudge
            F = res.F.clone().reshape(-1)
            F[k] = torch.nextafter(F[k], F.new_tensor(
                float("inf") if up else float("-inf")))
            res = res._replace(F=F.reshape(3, 3))
        self.steps.append(dict(kind="fundamental",
                               inliers=res.inliers.cpu().numpy().copy(),
                               F=res.F.double().cpu().numpy()))
        return res

    def _pnp_register(self, K, pts3d, pts2d, device, threshold=8.0, seed=0):
        got = self.real["_pnp_register"](K, pts3d, pts2d, device,
                                         threshold=threshold, seed=seed)
        step = dict(kind="pnp", view=seed)
        if got is not None:
            R, t, inl = got
            step.update(inliers=np.asarray(inl).copy(),
                        centers={seed: -R.T @ t})
        self.steps.append(step)
        return got

    def _cameras(self, kind, rec):
        C = camera_centers(rec.R, rec.t)
        gt = self.gt[rec.view_ids]
        sc, R, t = umeyama_alignment(C, gt)
        self.steps.append(dict(
            kind=kind, cameras=rec.num_cameras,
            centers=dict(zip(rec.view_ids, C)),
            aligned=dict(zip(rec.view_ids, (sc * (R @ C.T)).T + t)),
            ate=ate_rmse(C, gt)))

    def run_global_ba(self, rec, *a, **kw):
        rec = self.real["run_global_ba"](rec, *a, **kw)
        self._cameras("ba", rec)
        return rec

    def _close_loops(self, rec, *a, **kw):
        out = self.real["_close_loops"](rec, *a, **kw)
        self._cameras("loops", rec)
        return out


def compare(steps, base):
    """Each step of a variant beside the base run's step of the same kind
    and rank: inliers changed, centres moved (max over common views),
    aligned centres moved (RMS over common views)."""
    rank, out = {}, []
    by_kind = {}
    for s in base:
        by_kind.setdefault(s["kind"], []).append(s)
    for s in steps:
        r = rank.get(s["kind"], 0)
        rank[s["kind"]] = r + 1
        b = by_kind.get(s["kind"], [])
        b = b[r] if r < len(b) else None
        row = dict(kind=s["kind"], rank=r)
        for key in ("view", "cameras", "ate"):
            if key in s:
                row[key] = s[key]
        if b is not None and "inliers" in s and "inliers" in b:
            same_n = len(s["inliers"]) == len(b["inliers"])
            row["inliers_changed"] = int(
                (s["inliers"] != b["inliers"]).sum()) if same_n else -1
        if b is not None and "F" in s:
            row["F_moved"] = float(np.abs(s["F"] - b["F"]).max())
        if b is not None and "centers" in s and "centers" in b:
            common = set(s["centers"]) & set(b["centers"])
            if common:
                row["centers_moved"] = max(float(np.linalg.norm(
                    s["centers"][v] - b["centers"][v])) for v in common)
                if "aligned" in s and "aligned" in b:
                    row["aligned_moved"] = float(np.sqrt(np.mean([
                        np.sum((s["aligned"][v] - b["aligned"][v]) ** 2)
                        for v in common])))
        if b is not None and b.get("ate") is not None:
            row["base_ate"] = b["ate"]
        out.append(row)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--entries", type=int, default=9)
    ap.add_argument("--features", type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    feats, K, centers = features(args.features, args.device)
    if args.device == "cpu":
        torch.set_num_threads(1)      # a CPU run that repeats itself
    lines = []

    def emit(rec):
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    def run(nudge):
        with Recorder(centers, nudge) as r:
            t0 = time.perf_counter()
            rec = incremental.reconstruct_sequence(feats, K,
                                                   device=args.device)
            dt = time.perf_counter() - t0
        ate = ate_rmse(camera_centers(rec.R, rec.t), centers[rec.view_ids])
        return dict(ate=ate, registered=rec.num_cameras, seconds=dt), r.steps

    base, base_steps = run(None)
    emit(dict(variant="base", device=args.device, **base,
              steps=compare(base_steps, base_steps)))
    limit = 2 * JAX_SFM_ATE
    above = []
    for k in range(args.entries):
        for up in (True, False):
            res, steps = run((k, up))
            rows = compare(steps, base_steps)
            first_inl = next((r for r in rows
                              if r.get("inliers_changed", 0) != 0), None)
            first_moved = next((r for r in rows
                                if r.get("aligned_moved", 0) > MOVED), None)
            name = f"F[{k // 3},{k % 3}] {'+' if up else '-'}1 ulp"
            if not res["ate"] <= limit:
                above.append(name)
            emit(dict(variant=name, **res, first_inliers_changed=first_inl,
                      first_aligned_moved=first_moved, steps=rows))
    emit(dict(summary=True, device=args.device, base_ate=base["ate"],
              limit=limit, variants=2 * args.entries,
              above_limit=len(above), above=above,
              max_ate=max(r["ate"] for r in lines if "ate" in r)))
    if args.out:
        args.out.write_text("".join(json.dumps(r) + "\n" for r in lines))


if __name__ == "__main__":
    main()
