"""The comparison that decides `correct`: the program's feature tables
against the reference's, frame by frame, on the host.

Numbers (each held to a limit of the cell's limits file):

- kp_unmatched: the most keypoints of one frame, on either side, that have
  no counterpart on the other: the same level, within one pixel, the
  nearest of each other. A keypoint is a distinct (level, x, y, sigma,
  response, ftype) of the valid rows.
- kp_field_gap: over matched keypoints, the widest of |dx|, |dy| (pixels),
  |d sigma| / sigma and |d response| / |response|.
- row_unmatched_share: rows (a keypoint with one orientation) of either side
  with no row of the matched keypoint within 1e-5 radians on the other,
  over all compared frames, as a share of the reference's rows.
- desc_max_gap: the widest gap of one descriptor entry over matched rows.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

THETA_TOL = 1e-5       # radians: rows of one keypoint whose angles match
MATCH_PX = 1.0         # a keypoint's counterpart lies within this distance

FIELDS = ("x", "y", "sigma", "theta", "response", "level", "ftype", "valid",
          "desc")


def to_host(table) -> Dict[str, np.ndarray]:
    """The fields of a (B, N) table (program's or reference's) as NumPy."""
    return {f: getattr(table, f).detach().cpu().numpy() for f in FIELDS}


def _frame(t: Dict[str, np.ndarray], b: int):
    v = t["valid"][b].astype(bool)
    rows = {f: t[f][b][v] for f in FIELDS if f != "valid"}
    kp = np.stack([rows["level"].astype(np.float64),
                   rows["x"].astype(np.float64), rows["y"].astype(np.float64),
                   rows["sigma"].astype(np.float64),
                   rows["response"].astype(np.float64),
                   rows["ftype"].astype(np.float64)], 1)
    uniq, inv = np.unique(kp, axis=0, return_inverse=True)
    return rows, uniq, inv.reshape(-1)


def _mutual_nearest(a: np.ndarray, b: np.ndarray):
    """Pairs (i, j) of keypoints a[i], b[j] (rows level, x, y, ...) of one
    level each other's nearest within MATCH_PX."""
    pairs = []
    for lv in np.intersect1d(a[:, 0], b[:, 0]):
        ia = np.nonzero(a[:, 0] == lv)[0]
        ib = np.nonzero(b[:, 0] == lv)[0]
        d = np.hypot(a[ia, 1][:, None] - b[ib, 1][None, :],
                     a[ia, 2][:, None] - b[ib, 2][None, :])
        na = d.argmin(1)
        nb = d.argmin(0)
        for k, j in enumerate(na):
            if nb[j] == k and d[k, j] < MATCH_PX:
                pairs.append((ia[k], ib[j]))
    return pairs


def _circ(a: float, b: float) -> float:
    d = abs(a - b) % (2.0 * np.pi)
    return min(d, 2.0 * np.pi - d)


def compare_frame(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
                  b: int) -> dict:
    """The numbers of frame b: unmatched keypoints, the widest field gap,
    unmatched rows, the reference's rows, the widest descriptor gap."""
    g_rows, g_kp, g_inv = _frame(got, b)
    w_rows, w_kp, w_inv = _frame(want, b)
    pairs = _mutual_nearest(g_kp, w_kp)
    field_gap = 0.0
    desc_gap = 0.0
    matched_rows = 0
    for i, j in pairs:
        g, w = g_kp[i], w_kp[j]
        field_gap = max(field_gap, abs(g[1] - w[1]), abs(g[2] - w[2]),
                        abs(g[3] - w[3]) / max(abs(w[3]), 1e-12),
                        abs(g[4] - w[4]) / max(abs(w[4]), 1e-12),
                        0.0 if g[5] == w[5] else np.inf)
        gi = np.nonzero(g_inv == i)[0]
        wj = list(np.nonzero(w_inv == j)[0])
        for r in gi:
            best = None
            for s in wj:
                if _circ(g_rows["theta"][r], w_rows["theta"][s]) <= THETA_TOL:
                    best = s
                    break
            if best is None:
                continue
            wj.remove(best)
            matched_rows += 1
            desc_gap = max(desc_gap, float(np.abs(
                g_rows["desc"][r] - w_rows["desc"][best]).max(initial=0.0)))
    n_g, n_w = len(g_rows["x"]), len(w_rows["x"])
    return dict(kp_unmatched=(len(g_kp) - len(pairs)) + (len(w_kp)
                                                          - len(pairs)),
                kp_field_gap=field_gap,
                rows_unmatched=(n_g - matched_rows) + (n_w - matched_rows),
                rows_reference=n_w, desc_max_gap=desc_gap)


def compare(pairs: List[tuple]) -> Dict[str, float]:
    """The cell's numbers over (program table, reference table) pairs of
    host tables, every frame of each."""
    per = [compare_frame(g, w, b) for g, w in pairs
           for b in range(g["x"].shape[0])]
    if not per:
        raise ValueError("nothing to compare")
    rows_ref = sum(p["rows_reference"] for p in per)
    return dict(
        kp_unmatched=float(max(p["kp_unmatched"] for p in per)),
        kp_field_gap=float(max(p["kp_field_gap"] for p in per)),
        row_unmatched_share=float(sum(p["rows_unmatched"] for p in per)
                                  / max(rows_ref, 1)),
        desc_max_gap=float(max(p["desc_max_gap"] for p in per)),
        frames=float(len(per)), rows=float(rows_ref))


def judge(numbers: Dict[str, float], limits: Dict[str, dict]):
    """(correct, [(name, value, limit)]) - every number of the limits file
    at or under its limit."""
    checks = [(k, float(numbers[k]), float(spec["limit"]))
              for k, spec in limits.items()]
    return all(v <= lim for _, v, lim in checks), checks
