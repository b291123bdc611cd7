"""Bundle adjustment: Levenberg-Marquardt with matrix-free PCG (counterpart
of hessgpu_tpu/sfm/ba.py).

  * residuals are vectorized over the observation list (cam_idx, pt_idx,
    uv): each observation gathers its camera and point rows
    (index_select);
  * the Gauss-Newton system is solved matrix-free, H v = J^T (J v),
    preconditioned by the block-diagonal (6x6 pose / 3x3 point) blocks of
    H. J is held as its per-observation blocks (2x6 for the observation's
    camera, 2x3 for its point), from torch.func.jacfwd once per LM step at
    the linearization point: the Jacobian that the JAX package's jvp and
    vjp apply, and the one both packages build the preconditioner from.
    J v is a gather and a batched product per side, J^T u a batched
    product and a segment sum per side. (torch.func.jvp of the residual
    function, 30 calls an LM step, sends products with scalars and
    broadcasts through Python decompositions in PyTorch 2.13's forward
    mode: milliseconds of host time a call.)
  * rotations live on the manifold: increments are axis-angle deltas
    composed by the exponential map each LM step.

Every product here runs in IEEE float32 (TF32 off on the card), as the JAX
package asks XLA for Precision.HIGHEST: the products feed a Krylov solver,
which reduced precision stalls. The PCG runs a fixed number of steps with
its scalars on the device, so a step syncs with the host nowhere.

On the card lm_step replays one captured CUDA graph per problem and state
shape, cg_iters and fix_first_cam (utils/graphs.py), the counterpart of the
JAX package's jitted lm_step: the ~2800 launches of a step leave the host as
one. bundle_adjust reads the costs back once per step, outside the graph.

Segment sums (the transposes of the gathers) go through index_put_ with
accumulate=True, which PyTorch runs on the card as a sort by index and an
ordered sum of each run: a step is bit-for-bit repeatable there.
index_add_ adds atomically in no fixed order, and an incremental
reconstruction carries those last bits into other hypotheses and tracks.

State convention: camera c maps world points X to camera frame via
x_cam = R_c @ X + t_c; projection is pinhole with per-camera (f, cx, cy).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import jacfwd, vmap

from ..utils.graphs import GraphCache, graphs_enabled
from ..utils.precision import full_f32_matmul


class BAProblem(NamedTuple):
    """Static observation structure."""
    cam_idx: torch.Tensor   # int64 (O,)
    pt_idx: torch.Tensor    # int64 (O,)
    uv: torch.Tensor        # f32 (O, 2) observed pixels
    weight: torch.Tensor    # f32 (O,) 0 masks an observation out


class BAState(NamedTuple):
    R: torch.Tensor         # (C, 3, 3) world->camera rotations
    t: torch.Tensor         # (C, 3)
    X: torch.Tensor         # (P, 3) points
    intr: torch.Tensor      # (C, 3) f, cx, cy


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3).

    Taylor-safe at w = 0 (the solver differentiates through this at the
    zero increment, so the formulation must be smooth there - the naive
    normalize-then-rodrigues form has NaN gradients at the origin)."""
    if w.dim() == 1:
        # torch.func's forward mode gives a 0-d tensor's products with
        # Python scalars float64 tangents; a batch of one keeps float32
        return so3_exp(w[None])[0]
    theta2 = (w * w).sum(-1)
    small = theta2 < 1e-10
    # double-where: keep the exact branch finite where unused
    t2safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / t2safe)
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    K = torch.stack([
        torch.stack([zero, -wz, wy], -1),
        torch.stack([wz, zero, -wx], -1),
        torch.stack([-wy, wx, zero], -1),
    ], -2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def _zero_increment(state: BAState):
    return (state.R.new_zeros((state.R.shape[0], 6)),
            torch.zeros_like(state.X))


def _residuals(state: BAState, prob: BAProblem) -> torch.Tensor:
    """The (weighted) residuals at the state itself."""
    with full_f32_matmul():
        return _project(state, *_zero_increment(state), prob)


def _project(state: BAState, delta_pose, delta_pt, prob: BAProblem):
    """Residuals (O, 2) with tangent-space increments applied.

    delta_pose: (C, 6) [axis-angle | dt]; delta_pt: (P, 3)."""
    R = so3_exp(delta_pose[:, :3]) @ state.R
    t = state.t + delta_pose[:, 3:]
    X = state.X + delta_pt
    Rc = R.index_select(0, prob.cam_idx)
    tc = t.index_select(0, prob.cam_idx)
    intr = state.intr.index_select(0, prob.cam_idx)
    Xp = X.index_select(0, prob.pt_idx)
    xc = torch.einsum("oij,oj->oi", Rc, Xp) + tc
    z = torch.clamp(xc[:, 2], min=1e-6)
    u = intr[:, 0] * xc[:, 0] / z + intr[:, 1]
    v = intr[:, 0] * xc[:, 1] / z + intr[:, 2]
    res = torch.stack([u, v], 1) - prob.uv
    return res * prob.weight[:, None]


def _residual_fn(state: BAState, prob: BAProblem):
    """The residuals as a function of the increments (delta_pose,
    delta_pt)."""
    def fn(dp, dx):
        return _project(state, dp, dx, prob)
    return fn


def _jacobian_blocks(state: BAState, prob: BAProblem):
    """Per-observation Jacobians of the residuals at the zero increment:
    (O, 2, 6) with respect to the observation's camera increment and
    (O, 2, 3) with respect to its point's."""
    z6 = state.R.new_zeros(6)
    z3 = state.R.new_zeros(3)

    def per_obs(Rc, tc, intr, Xp, uv, wt):
        def res_one(dp6, dx3):
            R = so3_exp(dp6[:3]) @ Rc
            xc = R @ (Xp + dx3) + (tc + dp6[3:])
            z = torch.clamp(xc[2], min=1e-6)
            u = intr[0] * xc[0] / z + intr[1]
            v = intr[0] * xc[1] / z + intr[2]
            return (torch.stack([u, v]) - uv) * wt

        return jacfwd(res_one, argnums=(0, 1))(z6, z3)

    ci, pi = prob.cam_idx, prob.pt_idx
    return vmap(per_obs)(state.R[ci], state.t[ci], state.intr[ci],
                         state.X[pi], prob.uv, prob.weight)


def segment_sum(values: torch.Tensor, index: torch.Tensor, n: int):
    """Rows of values (O, ...) summed into n rows by index (O,), in a fixed
    order on every device."""
    return values.new_zeros((n,) + values.shape[1:]).index_put_(
        (index,), values, accumulate=True)


def _block_jacobi(state: BAState, prob: BAProblem, lam, blocks=None,
                  seg=segment_sum):
    """Inverse block-diagonal preconditioner from per-observation
    Jacobians (`blocks`, else _jacobian_blocks): (C, 6, 6) and (P, 3, 3).
    seg: the segment sum (a sharded step sums over the mesh too)."""
    with full_f32_matmul():
        Jp, Jx = _jacobian_blocks(state, prob) if blocks is None else blocks
        ci, pi = prob.cam_idx, prob.pt_idx
        Hc = seg(Jp.mT @ Jp, ci, state.R.shape[0])
        Hp = seg(Jx.mT @ Jx, pi, state.X.shape[0])
    Hc = Hc + lam * torch.eye(6, dtype=Hc.dtype, device=Hc.device)[None]
    Hp = Hp + lam * torch.eye(3, dtype=Hp.dtype, device=Hp.device)[None]
    # inv_ex: no host sync for the singularity check
    return torch.linalg.inv_ex(Hc)[0], torch.linalg.inv_ex(Hp)[0]


def robust_weights(state: BAState, prob: BAProblem, delta: float,
                   loss: str = "huber") -> torch.Tensor:
    """IRLS sqrt-weights for a robust loss of width `delta` pixels,
    evaluated at the current state and held fixed for one LM step.

    huber:  w = 1 in the quadratic zone, sqrt(delta/|r|) outside -
            bounds but does not eliminate outlier influence.
    cauchy: w = 1/sqrt(1 + (r/delta)^2) - redescending, gross outliers'
            influence decays to ~0, right for contaminated SfM tracks.
    """
    if loss not in ("huber", "cauchy"):
        raise ValueError(f"unknown robust loss {loss!r}")
    rn = torch.linalg.vector_norm(_residuals(state, prob), dim=1)
    if loss == "huber":
        w = torch.sqrt(torch.clamp(
            rn.new_tensor(delta) / torch.clamp(rn, min=1e-9), max=1.0))
    else:
        w = torch.rsqrt(1.0 + (rn / delta) ** 2)
    return w.detach()


def huber_weights(state: BAState, prob: BAProblem, delta: float):
    return robust_weights(state, prob, delta, loss="huber")


# The bytes the captured LM steps may reserve, the least recently used
# dropped first. An incremental reconstruction meets a new problem shape at
# every BA (14 on chip_smoke.py's 40-frame sequence); PERF.md gives the
# pools (chip_smoke.py's compiled phase): all of that sequence's fit.
LM_GRAPH_BYTES = 2 << 30
_LM_GRAPHS = GraphCache(LM_GRAPH_BYTES)


def lm_step(state: BAState, prob: BAProblem, lam: torch.Tensor,
            cg_iters: int = 30, fix_first_cam: bool = True):
    """One Levenberg-Marquardt step. Returns (new_state, new_lam, cost,
    new_cost, accepted), the last four 0-d tensors on the state's device.

    lam: 0-d float32 tensor on the state's device. On the card the step
    replays the CUDA graph of _lm_step for (the shapes and dtypes of state,
    prob and lam, cg_iters, fix_first_cam), captured at its first call with
    TF32 off, and returns fresh tensors; on the CPU, and inside
    utils.graphs.disable_graphs(), it runs _lm_step. lm_step.clear_cache()
    frees the graphs."""
    with full_f32_matmul():
        if state.R.is_cuda and graphs_enabled():
            return _LM_GRAPHS(
                (cg_iters, fix_first_cam),
                lambda st, pr, lm: _lm_step(st, pr, lm, cg_iters,
                                            fix_first_cam),
                state, prob, lam)
        return _lm_step(state, prob, lam, cg_iters, fix_first_cam)


lm_step.clear_cache = _LM_GRAPHS.clear


def _lm_step(state, prob, lam, cg_iters, fix_first_cam, seg=segment_sum,
             total=torch.sum):
    """The LM step. seg(values, index, n) is the segment sum of the
    Jacobian's transpose and of the preconditioner blocks, total(x) the sum
    of the squared residuals: a sharded step (sfm/distributed_ba.py) passes
    its shard-local sums followed by a sum over the mesh."""
    fn = _residual_fn(state, prob)
    blocks = Jp, Jx = _jacobian_blocks(state, prob)
    ci, pi = prob.cam_idx, prob.pt_idx
    vp0, vx0 = _zero_increment(state)
    C, P = vp0.shape[0], vx0.shape[0]

    # gauge fixing: camera 0 stays put by projecting it out of the Krylov
    # subspace (post-hoc snapping would invalidate the accepted cost)
    cam_mask = state.R.new_ones((state.R.shape[0], 1))
    if fix_first_cam:
        cam_mask[0] = 0.0

    def jvp(vp, vx):                          # J v: (O, 2)
        return (Jp @ vp.index_select(0, ci)[..., None]
                + Jx @ vx.index_select(0, pi)[..., None])[..., 0]

    def vjp(u):                               # J^T u: (C, 6), (P, 3)
        u = u[..., None]
        return (seg((Jp.mT @ u)[..., 0], ci, C),
                seg((Jx.mT @ u)[..., 0], pi, P))

    res0 = fn(vp0, vx0)
    cost0 = 0.5 * total(res0 ** 2)
    grad = vjp(res0)             # J^T r, (dpose, dpoint)

    def hvp(vp, vx):
        hp, hx = vjp(jvp(vp, vx))
        return (hp + lam * vp) * cam_mask, hx + lam * vx

    Mc, Mp = _block_jacobi(state, prob, lam, blocks, seg)

    def precond(rp, rx):
        return (torch.einsum("cij,cj->ci", Mc, rp) * cam_mask,
                torch.einsum("pij,pj->pi", Mp, rx))

    def dot(ap, ax, bp, bx):
        return (ap * bp).sum() + (ax * bx).sum()

    # PCG for H dx = -grad: cg_iters steps, no early exit
    rp, rx = -grad[0] * cam_mask, -grad[1]
    xp, xx = torch.zeros_like(rp), torch.zeros_like(rx)
    zp_, zx_ = precond(rp, rx)
    pp, px = zp_, zx_
    rz = dot(rp, rx, zp_, zx_)
    for _ in range(cg_iters):
        hp, hx = hvp(pp, px)
        alpha = rz / (dot(pp, px, hp, hx) + 1e-20)
        xp, xx = xp + alpha * pp, xx + alpha * px
        rp, rx = rp - alpha * hp, rx - alpha * hx
        zp_, zx_ = precond(rp, rx)
        rz_new = dot(rp, rx, zp_, zx_)
        beta = rz_new / (rz + 1e-20)
        pp, px = zp_ + beta * pp, zx_ + beta * px
        rz = rz_new

    # evaluate the step
    res1 = fn(xp, xx)
    cost1 = 0.5 * total(res1 ** 2)
    accept = cost1 < cost0

    newR = torch.where(accept, so3_exp(xp[:, :3]) @ state.R, state.R)
    newt = torch.where(accept, state.t + xp[:, 3:], state.t)
    newX = torch.where(accept, state.X + xx, state.X)
    new_lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                          1e-8, 1e6)
    return (BAState(R=newR, t=newt, X=newX, intr=state.intr),
            new_lam, cost0, cost1, accept)


def bundle_adjust(state: BAState, prob: BAProblem, iterations: int = 20,
                  lam0: float = 1e-3, cg_iters: int = 30,
                  fix_first_cam: bool = True,
                  huber_delta: float = 0.0, loss: str = "huber",
                  verbose: bool = False) -> Tuple[BAState, float]:
    """Run LM for a fixed iteration budget.

    fix_first_cam gauges the problem by projecting the first camera's
    update out of the solve. huber_delta > 0 enables a robust loss of that
    width (pixels) via per-step IRLS reweighting (`loss` picks huber or
    cauchy) - outliers stop dominating the normal equations.
    """
    lam = torch.tensor(lam0, dtype=state.R.dtype, device=state.R.device)
    cost = None
    for _ in range(iterations):
        if huber_delta > 0:
            w = robust_weights(state, prob, huber_delta, loss=loss)
            prob_it = prob._replace(weight=prob.weight * w)
        else:
            prob_it = prob
        state, lam, c0, c1, acc = lm_step(state, prob_it, lam,
                                          cg_iters=cg_iters,
                                          fix_first_cam=fix_first_cam)
        cost = float(torch.minimum(c0, c1))
        if verbose:
            print(f"LM cost {float(c0):.6f} -> {float(c1):.6f} "
                  f"accept={bool(acc)} lam={float(lam):.2e}")
    return state, cost


def prune_outliers(state: BAState, prob: BAProblem,
                   threshold: float = 4.0) -> Tuple[BAProblem, int]:
    """Zero-weight observations whose reprojection error exceeds threshold
    (pixels). Returns (pruned problem, number pruned)."""
    res = _residuals(state, prob)
    safew = torch.where(prob.weight > 0, prob.weight,
                        torch.ones_like(prob.weight))
    rn = torch.linalg.vector_norm(res, dim=1) / safew
    keep = (rn < threshold) & (prob.weight > 0)
    pruned = int(((prob.weight > 0) & ~keep).sum())
    return prob._replace(weight=torch.where(
        keep, prob.weight, torch.zeros_like(prob.weight))), pruned


def reprojection_rmse(state: BAState, prob: BAProblem) -> float:
    res = _residuals(state, prob)
    nobs = (prob.weight > 0).sum()
    return float(torch.sqrt((res ** 2).sum() / torch.clamp(2 * nobs, min=1)))
