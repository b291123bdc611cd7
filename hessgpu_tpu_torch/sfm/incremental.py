"""Incremental SfM: sequential pose chaining, track building, triangulation,
periodic bundle adjustment (counterpart of hessgpu_tpu/sfm/incremental.py).

The pipeline consumes the detector's typed features:

    images -> detect+describe (HessianSift)
           -> pairwise type-aware matching (SiftMatcher)
           -> two-view initialization (ransac_fundamental/recover_pose)
           -> PnP-style registration of each next view
           -> track table -> triangulation -> LM bundle adjustment

Scale convention: the first two cameras define the gauge (|t_01| = 1).

The bookkeeping (tracks, observations, keyframes, loop candidates) is NumPy
on the host, as in the JAX package; the numeric calls (matching, RANSAC,
pose recovery, triangulation, PnP refinement, bundle adjustment, the pose
graph) run in float32 on `device`. Where the JAX package handed a float64
array to its device, it became float32 (JAX runs with 64-bit mode off), and
what came back stayed float32 in the bookkeeping; the port casts at the
same places.

RANSAC samples are drawn through `sample_indices` with the integer the JAX
package gives its PRNG key (0 for the initial pair, the view index for PnP,
a * 1000 + b for a loop candidate (a, b)), and are the JAX package's own
draws for that key (sfm/prng.py): the port tries the same hypotheses.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import jacfwd

from ..matcher import _guided_gate, _match_core, quantize_descriptors
from ..pyramid import resolve_device
from ..utils.precision import full_f32_matmul
from . import prng
from .ba import (BAProblem, BAState, _residual_fn, bundle_adjust,
                 prune_outliers, so3_exp)
from .distributed_ba import bundle_adjust_sharded
from .twoview import (essential_from_fundamental,
                      ransac_fundamental_from_samples,
                      ransac_pnp_from_samples, recover_pose, triangulate,
                      type_aware_match_mask)


@dataclasses.dataclass
class Reconstruction:
    """Host-side reconstruction state."""
    R: List[np.ndarray]            # per registered camera (3, 3)
    t: List[np.ndarray]            # (3,)
    K: np.ndarray                  # shared intrinsics (3, 3)
    points: np.ndarray             # (P, 3)
    # observations: (cam, pt) -> (u, v)
    obs: List[Tuple[int, int, float, float]]
    # track id per (image, feature index)
    track_of: Dict[Tuple[int, int], int]
    # original sequence index of each registered camera (views can be
    # skipped when registration fails; camera c is view view_ids[c])
    view_ids: Optional[List[int]] = None

    @property
    def num_cameras(self) -> int:
        return len(self.R)

    @property
    def num_points(self) -> int:
        return self.points.shape[0]


def default_intrinsics(width: int, height: int, focal_factor: float = 1.2):
    """COLMAP-style prior: f = focal_factor * max(w, h)."""
    f = focal_factor * max(width, height)
    return np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1.0]])


def sample_indices(seed: int, n: int, shape, probs, device) -> torch.Tensor:
    """RANSAC samples: int64 indices of `shape` in [0, n), drawn with
    replacement with float32 probabilities probs (n,): the draws of
    jax.random.choice(PRNGKey(seed), n, shape, p=probs). Drawn on the host,
    so the card and the CPU see the same hypotheses."""
    return torch.as_tensor(prng.choice(seed, n, shape, probs), device=device)


def _f32(a, device) -> torch.Tensor:
    """A host array on the device as float32 (where the JAX package's
    float64 host arrays became float32 on its device)."""
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _type_gate(feats1, feats2, device):
    return type_aware_match_mask(
        torch.as_tensor(feats1["ftype"], device=device),
        torch.as_tensor(feats2["ftype"], device=device))


def _descriptor_match(feats1, feats2, ratiomax, gate, device) -> np.ndarray:
    """Mutual-best ratio-test matches (M, 2) of two feature dicts."""
    d1 = torch.as_tensor(quantize_descriptors(feats1["desc"]), device=device)
    d2 = torch.as_tensor(quantize_descriptors(feats2["desc"]), device=device)
    v1 = torch.ones(len(d1), dtype=torch.bool, device=device)
    v2 = torch.ones(len(d2), dtype=torch.bool, device=device)
    rm = _host(_match_core(d1, d2, v1, v2, 0.7, ratiomax, mutual_best=True,
                           gate=gate))
    rows = np.nonzero(rm >= 0)[0]
    return np.stack([rows, rm[rows]], 1) if len(rows) else np.zeros((0, 2), int)


def _match_pair(feats1, feats2, device, type_aware=True):
    gate = None
    if type_aware and "ftype" in feats1:
        gate = _type_gate(feats1, feats2, device)
    return _descriptor_match(feats1, feats2, 0.8, gate, device)


def _guided_match_pair(feats1, feats2, R1, t1, R2, t2, K, device,
                       type_aware=True, fdistmax=16.0, ratiomax=0.9):
    """Epipolar-guided re-matching once both poses are known.

    The fundamental matrix from the relative pose gates candidate pairs
    (matcher._guided_gate Sampson test, same kernel as the facade's
    GetGuidedSiftMatch), which lets the ratio test relax from 0.8 to
    `ratiomax`: matches the plain ratio test killed on repetitive texture
    come back wherever the geometry vouches for them - more tracks for
    triangulation at no detection cost (the track-starved failure mode of
    sparse detections)."""
    R_rel = R2 @ R1.T
    t_rel = t2 - R_rel @ t1
    tx = np.array([[0, -t_rel[2], t_rel[1]],
                   [t_rel[2], 0, -t_rel[0]],
                   [-t_rel[1], t_rel[0], 0]])
    Kinv = np.linalg.inv(K)
    F = Kinv.T @ (tx @ R_rel) @ Kinv
    scale = np.abs(F).max()
    if not np.isfinite(scale) or scale < 1e-12:
        return np.zeros((0, 2), int)   # degenerate (zero baseline)
    F = F / scale

    loc1 = _f32(np.stack([feats1["x"], feats1["y"]], 1), device)
    loc2 = _f32(np.stack([feats2["x"], feats2["y"]], 1), device)
    gate = _guided_gate(loc1, loc2, torch.eye(3, device=device), 1.0e20,
                        _f32(F, device), fdistmax)
    if type_aware and "ftype" in feats1:
        gate = gate & _type_gate(feats1, feats2, device)
    return _descriptor_match(feats1, feats2, ratiomax, gate, device)


def _pnp_register(K, pts3d, pts2d, device, threshold=8.0, seed=0):
    """Register a camera from 3D-2D correspondences.

    All RANSAC hypotheses run as one batch on the device
    (twoview.ransac_pnp_from_samples - the same batched-hypothesis pattern
    as the fundamental RANSAC), then a small pose-only Gauss-Newton refines
    on inliers. Correspondence counts are padded to power-of-two buckets,
    as in the JAX package, whose samples are drawn over the bucket.
    """
    n = pts3d.shape[0]
    if n < 6:
        return None
    cap = max(64, 1 << int(np.ceil(np.log2(n))))  # pad bucket
    X = np.zeros((cap, 3), np.float32)
    uv = np.zeros((cap, 2), np.float32)
    X[:n] = pts3d
    uv[:n] = pts2d
    valid = np.arange(cap) < n
    probs = valid.astype(np.float32)
    probs = probs / max(probs.sum(), np.float32(1e-12))
    idx = sample_indices(seed, cap, (256, 6), probs, device)
    res = ransac_pnp_from_samples(idx, _f32(X, device), _f32(uv, device),
                                  torch.as_tensor(valid, device=device),
                                  _f32(K, device), threshold=threshold)
    best_inl = _host(res.inliers)[:n]
    if int(res.num_inliers) < 6:
        return None
    R = _host(res.R).astype(np.float64)
    t = _host(res.t).astype(np.float64)
    # refine on inliers with fixed points: 1-camera BA
    obs_idx = np.nonzero(best_inl)[0]
    prob = BAProblem(
        cam_idx=torch.zeros(len(obs_idx), dtype=torch.int64, device=device),
        pt_idx=torch.arange(len(obs_idx), device=device),
        uv=_f32(pts2d[obs_idx], device),
        weight=torch.ones(len(obs_idx), device=device),
    )
    intr = _f32([[K[0, 0], K[0, 2], K[1, 2]]], device)
    st = BAState(R=_f32(R[None], device), t=_f32(t[None], device),
                 X=_f32(pts3d[obs_idx], device), intr=intr)
    st2 = _refine_pose_only(st, prob)
    return _host(st2.R[0]), _host(st2.t[0]), best_inl


def _refine_pose_only(state: BAState, prob: BAProblem,
                      iters: int = 10) -> BAState:
    """Gauss-Newton on the single camera pose with points fixed."""
    fn = _residual_fn(state, prob)
    dx = torch.zeros_like(state.X)

    def cost_fn(pose6):
        return fn(pose6[None], dx)

    pose = state.R.new_zeros(6)
    eye = torch.eye(6, dtype=pose.dtype, device=pose.device)
    with full_f32_matmul():
        for _ in range(iters):
            r = cost_fn(pose)
            J = jacfwd(cost_fn)(pose).reshape(-1, 6)
            H = J.T @ J + 1e-6 * eye
            pose = pose + torch.linalg.solve_ex(H, -J.T @ r.reshape(-1))[0]
        R = so3_exp(pose[:3]) @ state.R[0]
    t = state.t[0] + pose[3:]
    return state._replace(R=R[None], t=t[None])


def reconstruct_sequence(
    feature_sets: List[dict],
    K: np.ndarray,
    min_matches: int = 30,
    ba_every: int = 3,
    ba_iterations: int = 10,
    lookback: int = 3,
    loop_closure: bool = True,
    loop_gap: int = 8,
    # robust-loss scale (px) for the periodic and final BAs. The JAX
    # package measured ATE 0.0015 at 1.5 px vs 0.1033 at 3.0 on the
    # 100-frame/3-pass default-threshold sequence (docs/evidence/
    # kf_r5.txt) - at 3.0 px the Cauchy weights leave mismatched tracks
    # enough influence to bend the whole trajectory
    huber_delta: float = 1.5,
    mesh=None,
    verbose: bool = False,
    resume: Optional[Reconstruction] = None,
    guided_rematch: bool = True,
    extend_tracks: bool = False,
    merge_tracks: bool = False,
    keyframe_parallax_deg: float = 0.0,
    keyframe_max_gap: int = 8,
    final_rounds: int = 1,
    ba_loss: str = "cauchy",
    polish_prune_px: float = 0.0,
    device="cuda",
) -> Optional[Reconstruction]:
    """Incremental SfM over an ordered list of per-image feature dicts
    (the output of HessianSift.run).

    Robustness measures (round-2):
      * 2D-3D correspondences are gathered against the last `lookback`
        registered views, not just the immediate neighbor;
      * a weak view is skipped (not fatal) unless registration never
        recovers;
      * BA uses a Huber loss + outlier pruning (ba.bundle_adjust);
      * loop closure: candidate pairs found by mean-descriptor retrieval
        are verified with a two-view pose and fed as pose-graph edges
        (sfm/posegraph.py), then poses are re-fed to a final BA.

    extend_tracks / merge_tracks (opt-in): reprojection-gated track
    continuation into views where matching found the feature but the
    track had no observation, and union-find merging of duplicate tracks
    discovered through shared matches. Both are off by default: on the
    synthetic-TUM default-threshold benchmark they MEASURED WORSE (ATE
    0.116 off -> 0.21/0.23 at an 8 px gate, 0.17 at 2.5 px) - early
    wrong associations contaminate the periodic BAs faster than the
    final robust BA can prune them. Available for dense, well-textured
    sequences where association ambiguity is low.

    resume: a checkpointed Reconstruction (sfm.io.load_reconstruction)
    over a PREFIX of the same sequence: registration continues at view
    resume.view_ids[-1] + 1 (feature_sets must cover the full sequence;
    loop closure / re-triangulation / final BA run as usual).

    keyframe_parallax_deg > 0 enables keyframe selection: a registered
    view is promoted to keyframe when the median triangulation parallax
    (angle at the shared 3D points between the last keyframe's center and
    this view's center) reaches the threshold, when 2D-3D connectivity
    weakens, or after `keyframe_max_gap` frames. Fresh tracks are
    triangulated ONLY between keyframes - adjacent video frames have
    near-zero baseline, and depth triangulated from them is noise that
    anchors the periodic BAs in a bad basin (the default-threshold
    ATE-0.116 failure mode of round 2). Non-keyframes are still PnP
    registered and contribute observations to existing tracks, so every
    frame gets a pose and BA keeps full constraints. 0 disables (every
    registered view triangulates, the round-2 behavior).

    mesh: optional parallel.distributed mesh - every periodic and final BA
    ends with a distributed LM polish over it (run_global_ba).
    polish_prune_px > 0 (opt-in; 0 is the JAX package's polish) prunes the
    periodic BAs' observations at that many pixels before their polish.

    device: where the numeric calls run ("cuda" unless the CPU is asked
    for).
    """
    device = resolve_device(device)
    n_img = len(feature_sets)
    if n_img < 2:
        return None

    match_cache: Dict[Tuple[int, int], np.ndarray] = {}

    def matches(a: int, b: int) -> np.ndarray:
        if (a, b) not in match_cache:
            match_cache[(a, b)] = _match_pair(feature_sets[a],
                                             feature_sets[b], device)
        return match_cache[(a, b)]

    if resume is not None:
        rec = resume
        if rec.view_ids is None:
            rec.view_ids = list(range(len(rec.R)))
        return _register_remaining(
            rec, feature_sets, matches, K, rec.view_ids[-1] + 1, n_img,
            min_matches=min_matches, ba_every=ba_every,
            ba_iterations=ba_iterations, lookback=lookback,
            loop_closure=loop_closure, loop_gap=loop_gap,
            huber_delta=huber_delta, mesh=mesh, verbose=verbose,
            guided_rematch=guided_rematch, extend_tracks=extend_tracks,
            merge_tracks=merge_tracks,
            keyframe_parallax_deg=keyframe_parallax_deg,
            keyframe_max_gap=keyframe_max_gap,
            final_rounds=final_rounds, ba_loss=ba_loss,
            polish_prune_px=polish_prune_px, device=device)

    # ---- initialize from the first strong adjacent pair ------------------
    init_b = None
    for a in range(min(n_img - 1, 3)):
        if len(matches(a, a + 1)) >= min_matches:
            init_a, init_b = a, a + 1
            break
    if init_b is None:
        return None
    m01 = matches(init_a, init_b)
    p1 = np.stack([feature_sets[init_a]["x"][m01[:, 0]],
                   feature_sets[init_a]["y"][m01[:, 0]]], 1).astype(np.float32)
    p2 = np.stack([feature_sets[init_b]["x"][m01[:, 1]],
                   feature_sets[init_b]["y"][m01[:, 1]]], 1).astype(np.float32)
    res, R1, t1, X01, front = _two_view(p1, p2, K, 0, device)
    keep = _host(front & res.inliers)
    X01 = _host(X01)

    rec = Reconstruction(
        R=[np.eye(3), _host(R1)],
        t=[np.zeros(3), _host(t1)],
        K=K, points=X01[keep], obs=[], track_of={},
        view_ids=[init_a, init_b],
    )
    kept_idx = np.nonzero(keep)[0]
    for tid, mi in enumerate(kept_idx):
        f0, f1 = m01[mi]
        rec.track_of[(init_a, int(f0))] = tid
        rec.track_of[(init_b, int(f1))] = tid
        rec.obs.append((0, tid, float(p1[mi, 0]), float(p1[mi, 1])))
        rec.obs.append((1, tid, float(p2[mi, 0]), float(p2[mi, 1])))

    return _register_remaining(
        rec, feature_sets, matches, K, init_b + 1, n_img,
        min_matches=min_matches, ba_every=ba_every,
        ba_iterations=ba_iterations, lookback=lookback,
        loop_closure=loop_closure, loop_gap=loop_gap,
        huber_delta=huber_delta, mesh=mesh, verbose=verbose,
        guided_rematch=guided_rematch, extend_tracks=extend_tracks,
        merge_tracks=merge_tracks,
        keyframe_parallax_deg=keyframe_parallax_deg,
        keyframe_max_gap=keyframe_max_gap,
        final_rounds=final_rounds, ba_loss=ba_loss,
        polish_prune_px=polish_prune_px, device=device)


def _two_view(q1, q2, K, seed, device):
    """Fundamental RANSAC (512 hypotheses drawn with `seed`) over matched
    f32 pixels q1, q2 (M, 2), then the relative pose: (ransac result, R,
    t, points, cheirality mask), tensors on the device."""
    n = len(q1)
    probs = np.ones(n, np.float32)
    probs = probs / probs.sum()
    idx = sample_indices(seed, n, (512, 8), probs, device)
    p1, p2 = _f32(q1, device), _f32(q2, device)
    res = ransac_fundamental_from_samples(
        idx, p1, p2, torch.ones(n, dtype=torch.bool, device=device))
    Kt = _f32(K, device)
    E = essential_from_fundamental(res.F, Kt, Kt)
    R, t, X, front = recover_pose(E, p1, p2, Kt, Kt, valid=res.inliers)
    return res, R, t, X, front


# reprojection gate (px) for track extension / merge association; kept
# module-level so experiments can tighten it without API churn
_EXT_GATE_PX = 8.0


def _uf_find(uf: Dict[int, int], x: int) -> int:
    root = x
    while uf.get(root, root) != root:
        root = uf[root]
    while uf.get(x, x) != x:
        uf[x], x = root, uf[x]
    return root


def _apply_track_merges(rec: Reconstruction, uf: Dict[int, int]) -> int:
    """Canonicalize merged track ids (union-find), remap track_of/obs and
    drop duplicate (camera, track) observations. Orphaned point rows keep
    their stale coordinates: they end up with no observations, so
    re-triangulation skips them and BA's lam-damped point blocks stay
    invertible. Returns the number of merge groups applied."""
    if not uf:
        return 0
    rec.track_of = {k: _uf_find(uf, t) for k, t in rec.track_of.items()}
    new_obs, seen = [], set()
    for (c, t, u, v) in rec.obs:
        t2 = _uf_find(uf, t)
        if (c, t2) in seen:
            continue
        seen.add((c, t2))
        new_obs.append((c, t2, u, v))
    rec.obs = new_obs
    return len({_uf_find(uf, t) for t in uf})


def _register_remaining(rec: Reconstruction, feature_sets, matches, K,
                        start: int, n_img: int, *, min_matches, ba_every,
                        ba_iterations, lookback, loop_closure, loop_gap,
                        huber_delta, mesh, verbose,
                        guided_rematch=True,
                        extend_tracks=False,
                        merge_tracks=False,
                        keyframe_parallax_deg=0.0,
                        keyframe_max_gap=8,
                        final_rounds=1,
                        ba_loss="cauchy",
                        polish_prune_px=0.0,
                        device="cuda") -> Reconstruction:
    """Register views [start, n_img) into rec (lookback PnP; skip, don't
    break), then loop closure, re-triangulation, and the final BA. Shared
    by the fresh and checkpoint-resume paths of reconstruct_sequence."""
    # ---- register remaining views (lookback; skip, don't break) ----------
    skipped = 0
    merge_uf: Dict[int, int] = {}
    use_kf = keyframe_parallax_deg > 0
    # cameras promoted to keyframe (all pre-existing cameras count: the
    # init pair defines the gauge and resume checkpoints carry structure)
    kf_cams: List[int] = list(range(rec.num_cameras))
    # one observation per (camera, track): the 2D-3D loop and extensions
    # must not double-book a track in a view through two features
    obs_seen = {(c, t) for c, t, _, _ in rec.obs}
    for i in range(start, n_img):
        # 2D-3D correspondences through tracks of the last `lookback`
        # registered views (nearest first so its matches win duplicates)
        pts3d, pts2d, new_pairs = [], [], []
        seen_fcur = set()
        if use_kf:
            # keyframes hold the track structure; the latest view (even a
            # non-keyframe) is the temporally closest match source
            src_views = [rec.view_ids[c] for c in kf_cams[-lookback:]]
            if rec.view_ids and rec.view_ids[-1] not in src_views:
                src_views.append(rec.view_ids[-1])
        else:
            src_views = rec.view_ids[-lookback:]
        for v in reversed(src_views):
            for fprev, fcur in matches(v, i):
                fcur = int(fcur)
                if fcur in seen_fcur:
                    continue
                tid = rec.track_of.get((v, int(fprev)))
                if tid is not None:
                    seen_fcur.add(fcur)
                    pts3d.append(rec.points[tid])
                    pts2d.append([feature_sets[i]["x"][fcur],
                                  feature_sets[i]["y"][fcur]])
                    new_pairs.append((fcur, tid))
        got = None
        if len(pts3d) >= 6:
            got = _pnp_register(K, np.asarray(pts3d), np.asarray(pts2d),
                                device, seed=i)
        if got is None:
            skipped += 1
            if verbose:
                print(f"view {i}: registration failed "
                      f"({len(pts3d)} 2D-3D), skipping")
            if skipped > lookback:
                if verbose:
                    print(f"view {i}: lost tracking, stopping")
                break
            continue
        skipped = 0
        Ri, ti, inl = got
        cam = len(rec.R)
        rec.R.append(Ri)
        rec.t.append(ti)
        rec.view_ids.append(i)
        for (fcur, tid), ok in zip(new_pairs, inl):
            if ok and (i, fcur) not in rec.track_of:
                rec.track_of[(i, fcur)] = tid
                obs_seen.add((cam, tid))
                rec.obs.append((cam, tid,
                                float(feature_sets[i]["x"][fcur]),
                                float(feature_sets[i]["y"][fcur])))

        # keyframe decision: median triangulation parallax at the shared
        # 3D points between the last keyframe's center and this one
        is_kf = True
        if use_kf and kf_cams:
            ckf = kf_cams[-1]
            gap = i - rec.view_ids[ckf]
            tids = np.asarray([tid for (fc, tid), ok in zip(new_pairs, inl)
                               if ok], int)
            if len(tids) >= 8 and gap < keyframe_max_gap:
                C_kf = -rec.R[ckf].T @ rec.t[ckf]
                C_i = -Ri.T @ ti
                Xs = rec.points[tids]
                a, b = C_kf - Xs, C_i - Xs
                cosang = np.sum(a * b, 1) / np.maximum(
                    np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1),
                    1e-12)
                par = np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))
                is_kf = bool(np.median(par) >= keyframe_parallax_deg
                             or len(tids) < max(30, min_matches))
        if is_kf:
            kf_cams.append(cam)

        # triangulate brand-new tracks between EVERY lookback view and i
        # (nearest first; single-pair triangulation starved the map when
        # adjacent overlap was sparse - the round-2 ATE-0.23 failure mode).
        # Keyframe mode: only keyframes triangulate, and only against
        # previous KEYframes - adjacent-frame baselines are too narrow
        P_cur = K @ np.hstack([Ri, ti[:, None]])
        if use_kf:
            prev_views = ([rec.view_ids[c] for c in kf_cams[-lookback - 1:-1]]
                          if is_kf else [])
        else:
            prev_views = rec.view_ids[-lookback - 1:-1]
        for v_prev in reversed(prev_views):
            cam_prev = rec.view_ids.index(v_prev)
            P_prev = K @ np.hstack([rec.R[cam_prev],
                                    rec.t[cam_prev][:, None]])
            mm = matches(v_prev, i)
            if guided_rematch:
                gm = _guided_match_pair(
                    feature_sets[v_prev], feature_sets[i],
                    rec.R[cam_prev], rec.t[cam_prev], Ri, ti, K, device)
                if len(gm):
                    have = {(int(a), int(b)) for a, b in mm}
                    extra = [p for p in gm
                             if (int(p[0]), int(p[1])) not in have]
                    if extra:
                        mm = np.vstack([mm.reshape(-1, 2),
                                        np.asarray(extra)])
            # classify each match: both endpoints already tracked (a merge
            # candidate - two tracks observed the same physical point),
            # one tracked (extend that track into the untracked view), or
            # neither (triangulate fresh below)
            fresh, ext_cur, ext_prev, merge_cand = [], [], [], []
            for fp_, fc_ in mm:
                ta = rec.track_of.get((v_prev, int(fp_)))
                tb = rec.track_of.get((i, int(fc_)))
                if ta is None and tb is None:
                    fresh.append((fp_, fc_))
                elif ta is not None and tb is not None:
                    if ta != tb:
                        merge_cand.append((ta, tb, int(fp_), int(fc_)))
                elif ta is not None:
                    ext_cur.append((int(fc_), ta))
                else:
                    ext_prev.append((int(fp_), tb))
            if extend_tracks and (ext_cur or ext_prev):
                # reprojection-gated track extension: longer tracks are the
                # scarce resource at sparse detection thresholds
                for flist, Pm, cam_id, view_id, fs in (
                        (ext_cur, P_cur, cam, i, feature_sets[i]),
                        (ext_prev, P_prev, cam_prev, v_prev,
                         feature_sets[v_prev])):
                    if not flist:
                        continue
                    fidx = np.asarray([f for f, _ in flist])
                    tids = np.asarray([t for _, t in flist])
                    q = np.stack([fs["x"][fidx], fs["y"][fidx]], 1)
                    pr = rec.points[tids] @ Pm[:, :3].T + Pm[:, 3]
                    zs = np.where(np.abs(pr[:, 2]) < 1e-9, 1e-9, pr[:, 2])
                    err = np.linalg.norm(pr[:, :2] / zs[:, None] - q, axis=1)
                    ok_e = (pr[:, 2] > 0) & (err < _EXT_GATE_PX)
                    for k in np.nonzero(ok_e)[0]:
                        key = (view_id, int(fidx[k]))
                        tid = int(tids[k])
                        if key in rec.track_of or (cam_id, tid) in obs_seen:
                            continue
                        rec.track_of[key] = tid
                        obs_seen.add((cam_id, tid))
                        rec.obs.append((cam_id, tid,
                                        float(q[k, 0]), float(q[k, 1])))
            if merge_tracks and merge_cand:
                # merge only when each track's point explains the OTHER
                # track's observation (cross-reprojection gate); applied
                # lazily via union-find before loop closure
                ta_ = np.asarray([a for a, _, _, _ in merge_cand])
                tb_ = np.asarray([b for _, b, _, _ in merge_cand])
                fp_ = np.asarray([p for _, _, p, _ in merge_cand])
                fc_ = np.asarray([c_ for _, _, _, c_ in merge_cand])
                qp = np.stack([feature_sets[v_prev]["x"][fp_],
                               feature_sets[v_prev]["y"][fp_]], 1)
                qc = np.stack([feature_sets[i]["x"][fc_],
                               feature_sets[i]["y"][fc_]], 1)
                ok_m = np.ones(len(merge_cand), bool)
                for tids_, Pm, q in ((ta_, P_cur, qc), (tb_, P_prev, qp)):
                    pr = rec.points[tids_] @ Pm[:, :3].T + Pm[:, 3]
                    zs = np.where(np.abs(pr[:, 2]) < 1e-9, 1e-9, pr[:, 2])
                    err = np.linalg.norm(pr[:, :2] / zs[:, None] - q, axis=1)
                    ok_m &= (pr[:, 2] > 0) & (err < _EXT_GATE_PX)
                for k in np.nonzero(ok_m)[0]:
                    ra = _uf_find(merge_uf, int(ta_[k]))
                    rb = _uf_find(merge_uf, int(tb_[k]))
                    if ra != rb:
                        merge_uf[max(ra, rb)] = min(ra, rb)
            if not fresh:
                continue
            fp = np.asarray([f for f, _ in fresh])
            fc = np.asarray([f for _, f in fresh])
            q1 = np.stack([feature_sets[v_prev]["x"][fp],
                           feature_sets[v_prev]["y"][fp]], 1)
            q2 = np.stack([feature_sets[i]["x"][fc],
                           feature_sets[i]["y"][fc]], 1)
            Xn = _host(triangulate(_f32(P_prev, device), _f32(P_cur, device),
                                   _f32(q1, device), _f32(q2, device)))
            z1 = (Xn @ rec.R[cam_prev].T + rec.t[cam_prev])[:, 2]
            z2 = (Xn @ Ri.T + ti)[:, 2]
            ok = (z1 > 0) & (z2 > 0) & np.isfinite(Xn).all(1)
            # reprojection gate (cheirality alone admitted glancing-ray
            # points that Huber BA then had to fight)
            for (Pm, q) in ((P_prev, q1), (P_cur, q2)):
                pr = Xn @ Pm[:, :3].T + Pm[:, 3]
                zs = np.where(np.abs(pr[:, 2]) < 1e-9, 1e-9, pr[:, 2])
                err = np.linalg.norm(pr[:, :2] / zs[:, None] - q, axis=1)
                ok &= err < 8.0
            base = rec.points.shape[0]
            rec.points = np.vstack([rec.points, Xn[ok]])
            tid = base
            for k, (fpk, fck) in enumerate(fresh):
                if ok[k]:
                    rec.track_of[(v_prev, int(fpk))] = tid
                    rec.track_of[(i, int(fck))] = tid
                    obs_seen.add((cam_prev, tid))
                    obs_seen.add((cam, tid))
                    rec.obs.append((cam_prev, tid,
                                    float(q1[k, 0]), float(q1[k, 1])))
                    rec.obs.append((cam, tid,
                                    float(q2[k, 0]), float(q2[k, 1])))
                    tid += 1

        if rec.num_cameras % ba_every == 0:
            rec = run_global_ba(rec, iterations=ba_iterations,
                                huber_delta=huber_delta, mesh=mesh,
                                polish_prune_px=polish_prune_px,
                                device=device)
            if verbose:
                print(f"view {i}: cams={rec.num_cameras} "
                      f"pts={rec.num_points}")

    n_merged = _apply_track_merges(rec, merge_uf)
    if verbose and n_merged:
        print(f"merged {n_merged} duplicate-track groups")

    # ---- loop closure via pose graph -------------------------------------
    if loop_closure and rec.num_cameras >= loop_gap + 2:
        _close_loops(rec, feature_sets, matches, min_matches, loop_gap,
                     device, verbose=verbose)

    # re-triangulate every track from ALL its observations before the
    # final BA (points born from one weak pair otherwise anchor BA in a
    # bad basin - the sparse-detection failure mode). final_rounds > 1
    # alternates retriangulation and global BA: after BA moves the
    # poses, a DLT refit from the corrected geometry gives the next BA a
    # better linearization point (classic resection/intersection
    # alternation).
    for _ in range(max(1, final_rounds)):
        _retriangulate(rec)
        rec = run_global_ba(rec, iterations=ba_iterations,
                            huber_delta=huber_delta, prune_threshold=4.0,
                            loss=ba_loss, mesh=mesh, device=device)
    return rec


def _retriangulate(rec: Reconstruction) -> None:
    """Multi-view linear re-triangulation of each track (DLT least squares
    over every observation, current poses); keeps the refit only when it
    does not worsen the track's mean reprojection error. Mutates
    rec.points in place."""
    K = rec.K
    Ps = [K @ np.hstack([R, t[:, None]]) for R, t in zip(rec.R, rec.t)]
    pts = np.array(rec.points)   # writable copy (may alias device memory)
    by_track: Dict[int, list] = {}
    for (cam, tid, u, v) in rec.obs:
        by_track.setdefault(tid, []).append((cam, u, v))
    for tid, obs in by_track.items():
        if len(obs) < 2:
            continue
        A = np.empty((2 * len(obs), 4))
        for k, (cam, u, v) in enumerate(obs):
            P = Ps[cam]
            A[2 * k] = u * P[2] - P[0]
            A[2 * k + 1] = v * P[2] - P[1]
        sol, *_ = np.linalg.lstsq(A[:, :3], -A[:, 3], rcond=None)

        def mean_err(X):
            e = 0.0
            for (cam, u, v) in obs:
                pr = Ps[cam][:, :3] @ X + Ps[cam][:, 3]
                if pr[2] <= 1e-9:
                    return np.inf
                e += np.hypot(pr[0] / pr[2] - u, pr[1] / pr[2] - v)
            return e / len(obs)

        if mean_err(sol) <= mean_err(pts[tid]):
            pts[tid] = sol
    rec.points = pts


def _close_loops(rec: Reconstruction, feature_sets, matches, min_matches,
                 loop_gap, device, max_candidates: int = 5,
                 verbose=False) -> None:
    """Detect loop closures by mean-descriptor retrieval, verify each with
    a two-view pose, and redistribute drift with the pose graph
    (sfm/posegraph.py). Mutates rec's poses in place.
    """
    from .posegraph import PoseGraph, optimize_pose_graph

    C = rec.num_cameras
    md = np.stack([
        feature_sets[v]["desc"].mean(0) for v in rec.view_ids])
    md /= np.maximum(np.linalg.norm(md, axis=1, keepdims=True), 1e-9)
    sims = md @ md.T

    cands = []
    for a in range(C):
        for b in range(a + loop_gap, C):
            cands.append((sims[a, b], a, b))
    cands.sort(reverse=True)

    Rs = np.stack(rec.R)
    ts = np.stack(rec.t)
    ei, ej, Rm, tm, wt = [], [], [], [], []
    # odometry edges from the current estimates anchor the graph
    for c in range(C - 1):
        Rrel = Rs[c + 1] @ Rs[c].T
        ei.append(c)
        ej.append(c + 1)
        Rm.append(Rrel)
        tm.append(ts[c + 1] - Rrel @ ts[c])
        wt.append(1.0)

    n_loops = 0
    for sim, a, b in cands[:max_candidates * 4]:
        if n_loops >= max_candidates:
            break
        va, vb = rec.view_ids[a], rec.view_ids[b]
        mm = matches(va, vb)
        if len(mm) < min_matches:
            continue
        q1 = np.stack([feature_sets[va]["x"][mm[:, 0]],
                       feature_sets[va]["y"][mm[:, 0]]], 1).astype(np.float32)
        q2 = np.stack([feature_sets[vb]["x"][mm[:, 1]],
                       feature_sets[vb]["y"][mm[:, 1]]], 1).astype(np.float32)
        res, Rab, tab, _, front = _two_view(q1, q2, rec.K, a * 1000 + b,
                                            device)
        if int(res.inliers.sum()) < min_matches:
            continue
        if int((front & res.inliers).sum()) < min_matches // 2:
            continue
        Rab = _host(Rab)
        tab = _host(tab)
        # two-view translation is unit-norm: scale it to the current
        # estimate of |t_b - R_ab t_a| (monocular scale is unobservable
        # from the pair alone)
        scale = float(np.linalg.norm(ts[b] - Rab @ ts[a]))
        ei.append(a)
        ej.append(b)
        Rm.append(Rab)
        tm.append(tab * scale)
        wt.append(1.0)
        n_loops += 1
        if verbose:
            print(f"loop closure: cams {a}<->{b} (views {va}<->{vb}, "
                  f"sim {sim:.3f})")

    if n_loops == 0:
        return
    graph = PoseGraph(
        edge_i=torch.as_tensor(ei, dtype=torch.int64, device=device),
        edge_j=torch.as_tensor(ej, dtype=torch.int64, device=device),
        R_ij=_f32(np.stack(Rm), device),
        t_ij=_f32(np.stack(tm), device),
        weight=_f32(wt, device),
    )
    R_opt, t_opt = optimize_pose_graph(_f32(Rs, device), _f32(ts, device),
                                       graph)
    R_opt, t_opt = _host(R_opt), _host(t_opt)
    rec.R = [np.asarray(R_opt[c], np.float64) for c in range(C)]
    rec.t = [np.asarray(t_opt[c], np.float64) for c in range(C)]


def run_global_ba(rec: Reconstruction, iterations: int = 10,
                  huber_delta: float = 0.0, loss: str = "cauchy",
                  prune_threshold: float = 0.0,
                  mesh=None, polish_prune_px: float = 0.0,
                  device="cuda") -> Reconstruction:
    """Bundle-adjust the whole reconstruction. huber_delta > 0 enables the
    robust loss (Cauchy by default: SfM tracks carry occasional gross
    mismatches, and a redescending loss drives their influence to ~0);
    prune_threshold > 0 additionally zero-weights observations with
    reprojection error above that many pixels and re-solves.

    mesh: optional parallel.distributed mesh - after the robust solve (and
    pruning), the observations are sharded across the mesh and a final
    distributed LM polish runs (distributed_ba.bundle_adjust_sharded,
    matrix-free CG with its sums reduced over the mesh). The polish is a
    plain least-squares solve over every observation, as the JAX
    package's, so gross outliers the robust loss ignored can bend the
    trajectory. polish_prune_px > 0 (opt-in, a departure from the JAX
    package) prunes the observations at that many pixels before the polish
    where the robust solve did not (prune_threshold 0: the periodic BAs).

    device: where BA runs ("cuda" unless the CPU is asked for)."""
    device = resolve_device(device)

    obs = np.asarray([(c, p, u, v) for c, p, u, v in rec.obs
                      if p < rec.points.shape[0]])
    if len(obs) < 10:
        return rec
    prob = BAProblem(
        cam_idx=torch.as_tensor(obs[:, 0].astype(np.int64), device=device),
        pt_idx=torch.as_tensor(obs[:, 1].astype(np.int64), device=device),
        uv=_f32(obs[:, 2:4], device),
        weight=torch.ones(len(obs), device=device),
    )
    C = rec.num_cameras
    intr = _f32([rec.K[0, 0], rec.K[0, 2], rec.K[1, 2]], device) \
        .expand(C, 3).contiguous()
    st = BAState(R=_f32(np.stack(rec.R), device),
                 t=_f32(np.stack(rec.t), device),
                 X=_f32(rec.points, device), intr=intr)
    out, _ = bundle_adjust(st, prob, iterations=iterations,
                           huber_delta=huber_delta, loss=loss)
    if prune_threshold > 0:
        prob, npruned = prune_outliers(out, prob, prune_threshold)
        if npruned:
            out, _ = bundle_adjust(out, prob,
                                   iterations=max(3, iterations // 2),
                                   huber_delta=huber_delta, loss=loss)
    if mesh is not None:
        if prune_threshold <= 0 < polish_prune_px:
            prob, _ = prune_outliers(out, prob, polish_prune_px)
        out, _ = bundle_adjust_sharded(out, prob, mesh,
                                       iterations=max(3, iterations // 2))
    R, t = _host(out.R), _host(out.t)
    rec.R = [R[i] for i in range(C)]
    rec.t = [t[i] for i in range(C)]
    rec.points = _host(out.X)
    return rec
