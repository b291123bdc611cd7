"""Small batched SVDs that read nothing back to the host: the plain PyTorch
versions of the two kernels of csrc/linalg.cu (wrappers in
ops/cuda/linalg.py), step for step the same algorithm - the same sweeps in
the same order, the same sums in the same order, the same expressions, the
same convergence test, the same sign rule - so that a kernel equals its
plain version bit for bit on the card, sweeps run included.

The JAX package runs jnp.linalg.svd inside its jitted RANSACs
(hessgpu_tpu/sfm/twoview.py:52,55,127,129,234,237), inside one XLA
program. On the card torch.linalg.svd reads cuSOLVER's convergence info
back to the host, which no CUDA graph can hold; these stop by a test made
on the card and return no flag. The RANSAC cores (sfm/twoview.py) call
the kernels on a CUDA tensor and LAPACK on a CPU one; the plain versions
are the tests' yardstick (and, behind twoview.PLAIN_JACOBI_ON_CPU, the
cores' CPU route in the tests), on nobody's path on the card.

null_vector_plain(A), A (..., M, n) float32, n <= 12: the unit right
singular vector of A's smallest singular value, the last row of
torch.linalg.svd(A, full_matrices=True).Vh up to its sign. The Gram matrix
A^T A is formed in float64 (a float32 one squares the condition number: an
8 x 9 eight-point system after Hartley normalisation has kappa ~1e2-1e3,
and its null vector would be off by ~1e-1), then sweeps of cyclic Jacobi in
float64 diagonalise it; the eigenvector of the smallest diagonal entry (the
lowest index among equal ones) is rounded to float32. The Gram sums: the
rows are dealt to gram_slices(M, n) slices (row r to slice r mod S), each
slice adds its rows' products in row order from 0.0, then the slices are
added in slice order. A sweep is m - 1 rounds of the round-robin (circle)
ordering over m = n rounded up to even indices; a round's m / 2 rotations
act on disjoint index pairs, so they run at once: first on the columns of G
(and V), then on its rows, then each pair's 2 x 2 block is set to its
rotated diagonal and zero. A padded index (odd n) has a zero row and
column: its rotations are skipped.

The convergence test (both): a rotation of (p, q) is skipped where |g_pq|
<= tol sqrt(|g_pp g_qq|), tol = JACOBI_TOL, evaluated squared (g_pq^2 <=
tol^2 |g_pp g_qq|:
no square root on the kernels' chain), for svd3 g the Gram entries of W's
columns p and q. A matrix is done after the first sweep in which every
rotation was skipped - its state did not move, so the test is the same at
each round of that sweep and its order does not matter - and a done matrix
is frozen (its rotations skipped) while the others of its batch go on. A
kernel's warp (svd3: thread) stops when its matrices are done or after
max_sweeps sweeps (the cap); the plain versions run the cap's sweeps with
the done matrices frozen, which gives the same bits and reads nothing back
to the host (so a RANSAC core on the plain route reads nothing either).
The sweeps run (that last sweep included; the cap where a matrix is never
done) and the rotations applied (skipped ones not counted) come back with
return_counts. tol = 8 float64 eps (JACOBI_TOL; the wrappers pass it to
the kernels): the relative-accuracy test of Demmel and Veselic for positive
definite matrices, which holds a graded system (a DLT of far points: Gram
entries from 1 to 1e11) to each entry's own scale. The cores' systems
(tests/test_torch_small_svd.py) are done after 6-9 sweeps (null_vector)
and 3-5 (svd3); a rank-deficient draw (a repeated point: a null space of 2
or more dimensions, whose noise-level entries the rotations keep stirring)
can take the cap's 10, and a launch lasts as long as its slowest matrix.
An absolute floor (skip where |g_pq| <= tol trace(G)) would stop those
after 8 but leaves a graded system's small entries unrotated; it is not
used.

A rotation (both): with d = g_qq - g_pp and e = 2 g_pq, r = sqrt(d^2 +
e^2), q = |d| + r, w = rsqrt(2 r q) (= 1 / sqrt(q^2 + e^2)): c = q w, s =
sign(d) e w, t = s / c = sign(d) e / q (sign(0) = +1), the root |t| <= 1
of t^2 + 2 (d / e) t - 1 = 0. One square root and one reciprocal square
root on the chain (t's division beside them) where 1 / sqrt(1 + t^2) needs
two square roots and two divisions. On the card torch.rsqrt and the
kernels' rsqrt give the same bits (checked over 5.2e6 doubles on an NVIDIA
H100); on the CPU torch.rsqrt is 1 / sqrt. The diagonal becomes g_pp -
t g_pq, g_qq + t g_pq.

svd3_plain(A), A (..., 3, 3) float32: U, S (descending, >= 0), Vh as
torch.linalg.svd gives them, by one-sided Jacobi on A itself in float64
(cyclic sweeps over the column pairs (0,1), (0,2), (1,2), each rotation
from the dot products of W's columns p and q), singular values the column
norms, sorted descending (stable). u_i = w_i / s_i; where s_i <=
SVD3_RANK_TOL * s_0 the column is completed: u_0 = e_0 (A = 0), u_1 a unit
vector orthogonal to u_0 (from the axis where u_0 is smallest), u_2 = u_0 x
u_1. So a rank-deficient matrix - a collision among a RANSAC's draws -
gives no NaN.

Sign rule (both): each right singular vector's first nonzero entry is
positive; svd3 flips u_i with v_i. The null vector's sign reaches one
result: the scale of a 6-point DLT pose (sfm/twoview.py _dlt_pose6), whose
null vector is s [R | t] with R[0, 0] first, and whose R is wrong where s <
0 (the reference's formula; ROADMAP's reference-side caveats). The JAX
package takes LAPACK's sign, whatever it is. The rule "largest entry
positive" loses the PnP of tests/test_torch_sfm_twoview.py's scene, whose
translation's x, -2 s, is the largest entry of most hypotheses; the first
entry keeps most of its 256 hypotheses (LAPACK about half; that test pins
both) and picks the JAX package's pose.

What bounds the kernels on the card, and what their design does about it:
csrc/linalg.cu's header.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# the caps on the sweeps; the convergence test ends the cores' systems
# before them (module docstring)
NULL_VECTOR_SWEEPS = 10
SVD3_SWEEPS = 6
# the convergence test's relative tolerance, 8 float64 eps (the wrappers
# pass it to the kernels)
JACOBI_TOL = 8 * 2.0 ** -52
# singular values at most this times the largest count as zero in U
SVD3_RANK_TOL = 1e-12
# rows up to which one warp takes a matrix (one slice); above it a block of
# BLOCK_THREADS threads, BLOCK_THREADS // (n (n + 1) / 2) slices
WARP_ROWS = 32
BLOCK_THREADS = 256
MAX_COLUMNS = 12


def gram_slices(rows: int, cols: int) -> int:
    """The slices the Gram sums deal the rows to (csrc/linalg.cu's
    layout: one warp a matrix, or one block)."""
    if rows <= WARP_ROWS:
        return 1
    return max(1, BLOCK_THREADS // (cols * (cols + 1) // 2))


def check_null_vector_input(A: torch.Tensor):
    """(batch, rows, cols) of a null_vector input; raises on what the
    kernel does not take."""
    if A.dtype != torch.float32:
        raise TypeError(f"null_vector: expected float32, got {A.dtype}")
    if A.ndim < 2:
        raise ValueError(f"null_vector: expected (..., M, n), got "
                         f"{tuple(A.shape)}")
    M, n = A.shape[-2:]
    if not 1 <= n <= MAX_COLUMNS or M < 1:
        raise ValueError(f"null_vector: M >= 1 rows and 1..{MAX_COLUMNS} "
                         f"columns expected, got {tuple(A.shape)}")
    batch = 1
    for d in A.shape[:-2]:
        batch *= d
    return batch, M, n


def check_svd3_input(A: torch.Tensor) -> int:
    """The batch of an svd3 input; raises on what the kernel does not
    take."""
    if A.dtype != torch.float32:
        raise TypeError(f"svd3: expected float32, got {A.dtype}")
    if A.ndim < 2 or tuple(A.shape[-2:]) != (3, 3):
        raise ValueError(f"svd3: expected (..., 3, 3), got "
                         f"{tuple(A.shape)}")
    return A[..., 0, 0].numel()


def check_max_sweeps(max_sweeps: int) -> None:
    if max_sweeps < 0:
        raise ValueError(f"expected max_sweeps >= 0, got {max_sweeps}")


def _round_robin(m: int, device):
    """(P, Q), each (m - 1, m // 2): round r rotates the index pairs
    (P[r, k], Q[r, k]), P < Q. Round r places index 0 first and index
    1 + (j - 1 + r) mod (m - 1) at place j; place k pairs with place
    m - 1 - k."""
    j = torch.arange(m, device=device)
    r = torch.arange(m - 1, device=device)[:, None]
    place = torch.where(j == 0, 0, 1 + (j - 1 + r) % (m - 1))
    a, b = place[:, :m // 2], place.flip(1)[:, :m // 2]
    return torch.minimum(a, b), torch.maximum(a, b)


def _skipped(app, aqq, apq):
    """The convergence test (module docstring), squared: apq^2 <=
    JACOBI_TOL^2 |app aqq|."""
    return apq * apq <= (JACOBI_TOL * JACOBI_TOL) * (app * aqq).abs()


def _rotation(app, aqq, apq, skip):
    """(c, s, t) of the Jacobi rotation that zeroes apq (module docstring);
    where skip, values that are not used."""
    d = aqq - app
    e = 2.0 * torch.where(skip, 1.0, apq)
    r = torch.sqrt(d * d + e * e)
    q = d.abs() + r
    w = torch.rsqrt((2.0 * r) * q)
    se = torch.where(d >= 0, e, -e)
    return q * w, se * w, se / q


def _gram(a: torch.Tensor, slices: int) -> torch.Tensor:
    """The upper triangle (row-major) of a^T a for a (B, M, n) float64, in
    the kernel's order (see the module docstring)."""
    B, M, n = a.shape
    K = -(-M // slices)
    rows = torch.nn.functional.pad(a, (0, 0, 0, K * slices - M))
    rows = rows.reshape(B, K, slices, n)
    iu, ju = torch.triu_indices(n, n, device=a.device)
    part = a.new_zeros(B, slices, iu.numel())
    for k in range(K):
        r = rows[:, k]
        part = part + r[..., iu] * r[..., ju]
    g = part[:, 0]
    for s in range(1, slices):
        g = g + part[:, s]
    return g


class JacobiCounts(NamedTuple):
    """What each matrix of a batch ran, (...) int32 each: its sweeps and the
    rotations it applied (a skipped one not counted)."""
    sweeps: torch.Tensor
    rotations: torch.Tensor


class _Sweeps:
    """The convergence stop of a batch of B matrices: done (frozen), the
    sweeps each ran and the rotations it applied."""

    def __init__(self, B: int, device):
        self.done = torch.zeros(B, dtype=torch.bool, device=device)
        self.ran = torch.zeros(B, dtype=torch.int32, device=device)
        self.rotations = torch.zeros(B, dtype=torch.int32, device=device)

    def start(self) -> None:
        self.all_skipped = torch.ones_like(self.done)

    def test(self, app, aqq, apq):
        """The skip mask of B rotations (B,) or (B, k); a done matrix skips
        all."""
        per = (-1,) + (1,) * (apq.ndim - 1)
        skip = (_skipped(app, aqq, apq) | self.done.view(per)).reshape(
            apq.shape[0], -1)
        self.all_skipped &= skip.all(1)
        self.rotations += (~skip).sum(1, dtype=torch.int32)
        return skip.reshape(apq.shape)

    def end(self, sweep: int) -> None:
        self.ran = torch.where(self.done, self.ran, sweep + 1)
        self.done = self.done | self.all_skipped

    def counts(self, lead) -> JacobiCounts:
        return JacobiCounts(self.ran.reshape(lead),
                            self.rotations.reshape(lead))


def null_vector_plain(A: torch.Tensor, max_sweeps: int = NULL_VECTOR_SWEEPS,
                      return_counts: bool = False):
    """(..., n) float32: the unit null vector (right singular vector of the
    smallest singular value) of each (M, n) matrix of A (..., M, n)
    float32, n <= 12, by float64 Jacobi on A^T A (module docstring). With
    return_counts, also the JacobiCounts of each matrix."""
    _, M, n = check_null_vector_input(A)
    check_max_sweeps(max_sweeps)
    lead = A.shape[:-2]
    a = A.reshape(-1, M, n).double()
    B = a.shape[0]
    m = n + (n & 1)
    iu, ju = torch.triu_indices(n, n, device=A.device)
    g = _gram(a, gram_slices(M, n))
    G = a.new_zeros(B, m, m)
    G[:, iu, ju] = g
    G[:, ju, iu] = g
    V = torch.eye(m, dtype=a.dtype, device=a.device).expand(B, m, m).clone()
    P, Q = _round_robin(m, A.device)
    stop = _Sweeps(B, A.device)
    for sweep in range(max_sweeps):
        stop.start()
        for r in range(m - 1):
            p, q = P[r], Q[r]
            app, aqq, apq = G[:, p, p], G[:, q, q], G[:, p, q]
            skip = stop.test(app, aqq, apq)
            c, s, t = _rotation(app, aqq, apq, skip)
            cc, sc, kc = c[:, None, :], s[:, None, :], skip[:, None, :]
            for X in (G, V):                 # the columns
                xp, xq = X[:, :, p], X[:, :, q]
                X[:, :, p] = torch.where(kc, xp, cc * xp - sc * xq)
                X[:, :, q] = torch.where(kc, xq, sc * xp + cc * xq)
            cr, sr, kr = c[..., None], s[..., None], skip[..., None]
            gp, gq = G[:, p, :], G[:, q, :]    # the rows
            G[:, p, :] = torch.where(kr, gp, cr * gp - sr * gq)
            G[:, q, :] = torch.where(kr, gq, sr * gp + cr * gq)
            gqp = G[:, q, p]
            G[:, p, p] = torch.where(skip, app, app - t * apq)
            G[:, q, q] = torch.where(skip, aqq, aqq + t * apq)
            G[:, p, q] = torch.where(skip, apq, 0.0)
            G[:, q, p] = torch.where(skip, gqp, 0.0)
        stop.end(sweep)
    k = G.diagonal(dim1=1, dim2=2)[:, :n].argmin(1)
    v = V[:, :n, :].gather(2, k[:, None, None].expand(B, n, 1))[..., 0]
    v = (v * _first_sign(v, 1)).float().reshape(*lead, n)
    return (v, stop.counts(lead)) if return_counts else v


def _first_sign(x, dim):
    """-1.0 where x's first nonzero entry along dim is negative, else 1.0
    (kept as a dim of 1)."""
    first = (x != 0).to(x.dtype).argmax(dim, keepdim=True)
    return torch.where(x.gather(dim, first) < 0, -1.0, 1.0)


def _dot3(x, y):
    """x . y over the last axis of 3, added in index order."""
    return (x[..., 0] * y[..., 0] + x[..., 1] * y[..., 1]
            + x[..., 2] * y[..., 2])


def svd3_plain(A: torch.Tensor, max_sweeps: int = SVD3_SWEEPS,
               return_counts: bool = False):
    """(U, S, Vh) of each 3 x 3 matrix of A (..., 3, 3) float32, as
    torch.linalg.svd gives them, by float64 one-sided Jacobi (module
    docstring). With return_counts, also the JacobiCounts of each matrix,
    as a fourth result."""
    check_svd3_input(A)
    check_max_sweeps(max_sweeps)
    lead = A.shape[:-2]
    W = A.reshape(-1, 3, 3).double()
    B = W.shape[0]
    V = torch.eye(3, dtype=W.dtype, device=W.device).expand(B, 3, 3).clone()
    stop = _Sweeps(B, A.device)
    for sweep in range(max_sweeps):
        stop.start()
        for p, q in ((0, 1), (0, 2), (1, 2)):
            wp, wq = W[:, :, p], W[:, :, q]
            alpha, beta, gamma = _dot3(wp, wp), _dot3(wq, wq), _dot3(wp, wq)
            skip = stop.test(alpha, beta, gamma)
            c, s, _ = _rotation(alpha, beta, gamma, skip)
            c, s, skip = c[:, None], s[:, None], skip[:, None]
            for X in (W, V):
                xp, xq = X[:, :, p], X[:, :, q]
                new_p = torch.where(skip, xp, c * xp - s * xq)
                new_q = torch.where(skip, xq, s * xp + c * xq)
                X[:, :, p], X[:, :, q] = new_p, new_q
        stop.end(sweep)
    sv = torch.sqrt(_dot3(W.mT, W.mT))                      # column norms
    order = torch.sort(sv, dim=1, descending=True, stable=True).indices
    sv = sv.gather(1, order)
    cols = order[:, None, :].expand(B, 3, 3)
    W, V = W.gather(2, cols), V.gather(2, cols)
    sign = _first_sign(V, 1)                                 # (B, 1, 3)
    V, W = V * sign, W * sign
    eye = torch.eye(3, dtype=W.dtype, device=W.device)
    rank_tol = sv[:, 0] * SVD3_RANK_TOL
    s0, s1, s2 = sv[:, 0, None], sv[:, 1, None], sv[:, 2, None]
    u0 = torch.where(s0 > 0, W[:, :, 0] / s0, eye[0])
    k = u0.abs().argmin(1)
    e = eye[k] - u0.gather(1, k[:, None]) * u0
    perp = e / torch.sqrt(_dot3(e, e))[:, None]
    u1 = torch.where(s1 > rank_tol[:, None], W[:, :, 1] / s1, perp)
    cross = torch.stack([u0[:, 1] * u1[:, 2] - u0[:, 2] * u1[:, 1],
                         u0[:, 2] * u1[:, 0] - u0[:, 0] * u1[:, 2],
                         u0[:, 0] * u1[:, 1] - u0[:, 1] * u1[:, 0]], 1)
    u2 = torch.where(s2 > rank_tol[:, None], W[:, :, 2] / s2, cross)
    U = torch.stack([u0, u1, u2], -1)
    out = (U.float().reshape(*lead, 3, 3), sv.float().reshape(*lead, 3),
           V.mT.float().reshape(*lead, 3, 3))
    return out + (stop.counts(lead),) if return_counts else out
