"""Pose-graph optimization: SE(3) relative-pose constraints, Gauss-Newton
(counterpart of hessgpu_tpu/sfm/posegraph.py).

Given odometry/loop-closure edges (i, j, R_ij, t_ij) measuring camera j's
pose in camera i's frame, refine absolute poses. Vectorized over edges; the
normal equations are solved matrix-free by plain CG (40 fixed steps) on
J^T J v, J held as its per-edge 6x6 blocks for the edge's two cameras
(torch.func.jacfwd at the linearization point, as ba.py holds its
Jacobian).

Convention: world->camera poses (R_c, t_c); the relative measurement
predicts R_ij = R_j R_i^T, t_ij = t_j - R_j R_i^T t_i.

A Gauss-Newton step is the JAX package's jitted `step`: on the card it
replays one captured CUDA graph per (C, E, lam, fix_first, device), which
optimize_pose_graph replays `iterations` times; it reads nothing back. On
the CPU, and inside utils.graphs.disable_graphs(), it runs _step.
optimize_pose_graph.clear_cache() frees the graphs.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import jacfwd, vmap

from ..utils.graphs import GraphCache, graphs_enabled
from ..utils.precision import full_f32_matmul
from .ba import segment_sum, so3_exp

CG_STEPS = 40

# The bytes the captured steps may reserve, the least recently used dropped
# first (PERF.md, chip_smoke.py's compiled phase).
POSE_GRAPH_BYTES = 1 << 30
_STEP_GRAPHS = GraphCache(POSE_GRAPH_BYTES)


class PoseGraph(NamedTuple):
    edge_i: torch.Tensor     # int64 (E,)
    edge_j: torch.Tensor     # int64 (E,)
    R_ij: torch.Tensor       # f32 (E, 3, 3) measured relative rotations
    t_ij: torch.Tensor       # f32 (E, 3)
    weight: torch.Tensor     # f32 (E,)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3), Taylor-safe."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    small = theta < 1e-5
    # scale = theta / (2 sin theta); -> 1/2 as theta -> 0
    sin_safe = torch.where(small, torch.ones_like(theta), torch.sin(theta))
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * sin_safe))
    return w * scale[..., None]


def _residuals(R, t, delta, graph: PoseGraph):
    """Edge residuals (E, 6): [rotation log | translation]."""
    Rn = so3_exp(delta[:, :3]) @ R
    tn = t + delta[:, 3:]
    Ri = Rn[graph.edge_i]
    Rj = Rn[graph.edge_j]
    ti = tn[graph.edge_i]
    tj = tn[graph.edge_j]
    R_rel = Rj @ Ri.mT
    t_rel = tj - torch.einsum("eij,ej->ei", R_rel, ti)
    r_rot = so3_log(graph.R_ij.mT @ R_rel)
    r_t = t_rel - graph.t_ij
    return torch.cat([r_rot, r_t], 1) * graph.weight[:, None]


def _edge_jacobians(R, t, graph: PoseGraph):
    """Jacobians (E, 6, 6) of each edge's residual with respect to the
    increments of its cameras i and j, at the zero increment."""
    ei, ej = graph.edge_i, graph.edge_j

    def per_edge(Ri, ti, Rj, tj, Rm, tm, w):
        def res_one(di, dj):
            Rn_i = so3_exp(di[:3]) @ Ri
            Rn_j = so3_exp(dj[:3]) @ Rj
            R_rel = Rn_j @ Rn_i.T
            t_rel = (tj + dj[3:]) - R_rel @ (ti + di[3:])
            r_rot = so3_log((Rm.T @ R_rel)[None])[0]
            return torch.cat([r_rot, t_rel - tm]) * w

        z = Ri.new_zeros(6)
        return jacfwd(res_one, argnums=(0, 1))(z, z)

    return vmap(per_edge)(R[ei], t[ei], R[ej], t[ej], graph.R_ij,
                          graph.t_ij, graph.weight)


def _step(R, t, graph: PoseGraph, mask, lam: float):
    """One Gauss-Newton step, kept only if it lowers the cost."""
    ei, ej = graph.edge_i, graph.edge_j
    Ji, Jj = _edge_jacobians(R, t, graph)
    zero = R.new_zeros((R.shape[0], 6))
    res = _residuals(R, t, zero, graph)

    def vjp(u):                                  # J^T u: (C, 6)
        u = u[..., None]
        C = zero.shape[0]
        return (segment_sum((Ji.mT @ u)[..., 0], ei, C)
                + segment_sum((Jj.mT @ u)[..., 0], ej, C))

    def hvp(v):
        jv = (Ji @ v.index_select(0, ei)[..., None]
              + Jj @ v.index_select(0, ej)[..., None])[..., 0]
        return vjp(jv) * mask + lam * v

    grad = vjp(res) * mask

    # plain CG (the system is small: 6C unknowns)
    b = -grad
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = (r * r).sum()
    for _ in range(CG_STEPS):
        hp = hvp(p)
        alpha = rs / ((p * hp).sum() + 1e-20)
        x = x + alpha * p
        r = r - alpha * hp
        rs_new = (r * r).sum()
        p = r + (rs_new / (rs + 1e-20)) * p
        rs = rs_new
    x = x * mask
    Rn = so3_exp(x[:, :3]) @ R
    tn = t + x[:, 3:]
    c0 = (res ** 2).sum()
    c1 = (_residuals(Rn, tn, zero, graph) ** 2).sum()
    ok = c1 < c0
    return torch.where(ok, Rn, R), torch.where(ok, tn, t)


def _free_mask(R, fix_first: bool):
    """(C, 1): 1 for a camera the step moves, 0 for a fixed one."""
    mask = R.new_ones((R.shape[0], 1))
    if fix_first:
        mask[:1].fill_(0.0)
    return mask


def step(R, t, graph: PoseGraph, lam: float = 1e-4, fix_first: bool = True):
    """One Gauss-Newton step (_step with the first camera fixed or not), run
    with TF32 off. On the card: the graph of (C, E, lam, fix_first)."""
    with full_f32_matmul():
        if R.is_cuda and graphs_enabled(_STEP_GRAPHS):
            return _STEP_GRAPHS(
                (float(lam), bool(fix_first)),
                lambda R, t, g: _step(R, t, g, _free_mask(R, fix_first),
                                      lam),
                R, t, graph)
        return _step(R, t, graph, _free_mask(R, fix_first), lam)


def optimize_pose_graph(R0, t0, graph: PoseGraph, iterations: int = 20,
                        lam: float = 1e-4, fix_first: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton on the pose graph. R0: (C, 3, 3), t0: (C, 3), float32,
    placed on the graph's device."""
    dev = graph.edge_i.device
    R = torch.as_tensor(R0, dtype=torch.float32, device=dev)
    t = torch.as_tensor(t0, dtype=torch.float32, device=dev)
    for _ in range(iterations):
        R, t = step(R, t, graph, lam, fix_first)
    return R, t


optimize_pose_graph.clear_cache = _STEP_GRAPHS.clear


def graph_cost(R, t, graph: PoseGraph) -> float:
    dev = graph.edge_i.device
    R = torch.as_tensor(R, dtype=torch.float32, device=dev)
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    with full_f32_matmul():
        res = _residuals(R, t, R.new_zeros((R.shape[0], 6)), graph)
    return float((res ** 2).sum())
