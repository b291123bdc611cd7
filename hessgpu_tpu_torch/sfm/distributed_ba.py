"""Distributed bundle adjustment: observations sharded over a mesh
(counterpart of hessgpu_tpu/sfm/distributed_ba.py).

The Gauss-Newton system is solved by the same matrix-free PCG as sfm/ba.py:
the state (poses, points) is replicated, each shard holds a contiguous
block of the observation list, and every segment sum (the transposed
Jacobian's products and the preconditioner's blocks) and every cost sum is
taken over the shard's own observations and then summed over the mesh
(parallel.distributed.psum). Gauge projection, PCG, accept rule and lambda
update are the one-device step's, so a sharded step differs from it only
in the order of its sums.

On the in-process mesh the shards ride one segment sum over (shard, row)
indices, reshaped to (n, rows, ...), and are added in shard order. The
segment sums are sfm/ba.py's ordered index_put_ (no atomics), so a run
repeats itself bit for bit on one device.

The observation list is padded to a multiple of the mesh size with
zero-weight entries, so sharding is exact.

On the card an in-process mesh's step replays one captured CUDA graph
(utils/graphs.py) of the whole step - every shard's segment sums, the
psums in shard order, PCG and the accept rule - per (mesh size, cg_iters,
fix_first_cam) and the padded problem's shapes: the counterpart of the JAX
package's jit(shard_map(step)). A process group's step runs eagerly (its
psums are collective calls), and so does every step on the CPU and inside
utils.graphs.disable_graphs(). make_sharded_lm_step.clear_cache() frees
the graphs.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..parallel.distributed import DeviceMesh, mesh_shards, psum
from ..utils.graphs import GraphCache, on_graph_route
from ..utils.precision import full_f32_matmul
from .ba import LM_GRAPH_BYTES, BAProblem, BAState, _lm_step, segment_sum

# The bytes the captured sharded LM steps may reserve, the least recently
# used dropped first: a reconstruction meets a new problem shape at every
# BA, as lm_step's graphs do (sfm/ba.py LM_GRAPH_BYTES).
SHARDED_LM_GRAPH_BYTES = LM_GRAPH_BYTES
_SHARDED_LM_GRAPHS = GraphCache(SHARDED_LM_GRAPH_BYTES)


def pad_problem(prob: BAProblem, multiple: int) -> BAProblem:
    """Pad the observation list with zero-weight entries (camera 0, point
    0, uv 0) to a multiple of `multiple`."""
    n = prob.cam_idx.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return prob
    return BAProblem(
        cam_idx=F.pad(prob.cam_idx, (0, pad)),
        pt_idx=F.pad(prob.pt_idx, (0, pad)),
        uv=F.pad(prob.uv, (0, 0, 0, pad)),
        weight=F.pad(prob.weight, (0, pad)),
    )


def make_sharded_lm_step(mesh: DeviceMesh, cg_iters: int = 30,
                         fix_first_cam: bool = True):
    """An LM step with the observations sharded over the mesh:
    step(state, lam, prob) -> (new_state, new_lam, cost0, cost1), the last
    three 0-d tensors. prob: the whole padded problem (its length a
    multiple of mesh.size); each process takes its shards' blocks. lam: a
    0-d tensor on the state's device.

    On an in-process mesh with the card's tensors the step replays its
    graph (the module's docstring); on a process group's mesh, on the CPU
    and inside disable_graphs() it runs eagerly."""
    own = mesh_shards(mesh)
    k = len(own)

    def step(state: BAState, lam: torch.Tensor, prob: BAProblem):
        n_obs = prob.cam_idx.shape[0]
        if n_obs % mesh.size:
            raise ValueError(f"{n_obs} observations do not split over "
                             f"{mesh.size} shards: pad_problem first")
        if on_graph_route(_SHARDED_LM_GRAPHS, state.R, mesh):
            return _SHARDED_LM_GRAPHS((mesh.size, cg_iters, fix_first_cam),
                                      body, state, lam, prob)
        return body(state, lam, prob)

    def body(state: BAState, lam: torch.Tensor, prob: BAProblem):
        per = prob.cam_idx.shape[0] // mesh.size
        local = BAProblem(*(a[own.start * per:own.stop * per] for a in prob))
        shard_of = torch.arange(k, device=prob.cam_idx.device) \
            .repeat_interleave(per)

        def seg(values, index, n):
            sums = segment_sum(values, shard_of * n + index, k * n)
            return psum(sums.reshape((k, n) + values.shape[1:]), mesh)

        def total(x):
            return psum(x.reshape(k, -1).sum(1), mesh)

        with full_f32_matmul():
            new_state, new_lam, cost0, cost1, _ = _lm_step(
                state, local, lam, cg_iters, fix_first_cam, seg, total)
        return new_state, new_lam, cost0, cost1

    return step


make_sharded_lm_step.clear_cache = _SHARDED_LM_GRAPHS.clear


def bundle_adjust_sharded(state: BAState, prob: BAProblem, mesh: DeviceMesh,
                          iterations: int = 15, lam0: float = 1e-3,
                          cg_iters: int = 30,
                          fix_first_cam: bool = True) -> Tuple[BAState, float]:
    """Run distributed LM over observation shards for a fixed iteration
    budget. Returns (state, the last step's min(cost0, cost1))."""
    prob = pad_problem(prob, mesh.size)
    step = make_sharded_lm_step(mesh, cg_iters=cg_iters,
                                fix_first_cam=fix_first_cam)
    lam = torch.tensor(lam0, dtype=state.R.dtype, device=state.R.device)
    cost = None
    for _ in range(iterations):
        state, lam, c0, c1 = step(state, lam, prob)
        cost = float(torch.minimum(c0, c1))
    return state, cost
