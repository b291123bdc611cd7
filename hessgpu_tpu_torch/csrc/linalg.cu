// Small batched SVDs for the RANSAC cores on Hopper (sm_90a), with nothing
// read back to the host. Plain C interface, loaded with ctypes
// (hessgpu_tpu_torch/ops/cuda/linalg.py).
//
// Replaces no TPU kernel: the JAX package runs jnp.linalg.svd inside its
// jitted ransac_fundamental and ransac_pnp
// (hessgpu_tpu/sfm/twoview.py:52,55,127,129,234,237), where XLA keeps the
// SVDs in one program. torch.linalg.svd on the card reads cuSOLVER's
// convergence info back to the host, which no CUDA graph holds, so each
// core was a chain of graphs with its SVDs run eagerly between them. These
// two kernels decide on the card when to stop and write no flag, so a core
// is one graph.
//
//  * hg_null_vector: A (B, M, n) f32, n <= 12 -> out (B, n) f32, the unit
//    null vector (right singular vector of the smallest singular value).
//    The Gram matrix A^T A is formed in double (a float one squares the
//    condition number and loses the null vector), diagonalised by cyclic
//    Jacobi sweeps in double until a sweep skips every rotation (at most
//    max_sweeps; the test's tolerance tol is ops/linalg.py's JACOBI_TOL,
//    which the wrappers pass), and the eigenvector of the smallest
//    diagonal entry (lowest index among equal ones) is rounded to float.
//  * hg_svd3: A (B, 3, 3) f32 -> U, S, Vh f32 as torch.linalg.svd gives
//    them, by one-sided Jacobi in double on A itself, with the same stop;
//    singular values sorted descending (stable); a U column whose singular
//    value is at most rank_tol times the largest is completed to an
//    orthonormal basis (a rank-deficient hypothesis gives no NaN).
//  Both write the sweeps each matrix ran to `sweeps` where it is not null.
//
// The plain PyTorch versions (ops/linalg.py, whose docstring states the
// algorithm: the convergence test, the rotation's formula, the sign rule)
// run the same algorithm step by step: the Gram sums in the same order
// (rows dealt to `slices` slices, row r to slice r mod S, each slice adding
// its rows' products in row order from 0.0, then the slices added in slice
// order), the same round-robin rotation order, the same expressions, and
// this file is compiled with -fmad=false, so the kernels equal them bit for
// bit, sweeps run included.
//
// What bounds them on this card: neither bytes (a few hundred KB) nor the
// FP64 rate (some 10^7-10^8 operations: a few us at 34 TFLOP/s) but the
// latency of each matrix's chain of dependent rotations, and a launch
// lasts as long as its slowest matrix. On that chain a float64 square root
// or division costs far more than a multiply or a shuffle. The design:
//  * null_vector keeps its state in registers. Lane k of a 16-lane segment
//    owns column k of G and of V (m = n rounded up to even <= 12, so two
//    matrices share a warp, one a segment, in blocks of one warp). A round
//    rotates m / 2 disjoint pairs at once: the two lanes of a pair swap
//    their diagonal and off-diagonal entries by shuffles, both compute the
//    pair's rotation, swap their whole columns, each keeps its rotated
//    column; then every lane rotates the two rows of each pair in its own
//    column with that pair's c, s, broadcast by shuffles; the 2 x 2 block
//    is set by the pair's lanes. No shared memory and no barrier inside the
//    sweeps. A lane keeps its column's rows by place of the round-robin
//    (jacobi_null_vector), so every register index is a constant while the
//    round loop stays rolled: unrolled, the rounds' code overflowed the
//    instruction cache.
//  * The rotation takes one square root and one reciprocal square root on
//    the chain (1 / sqrt(1 + t^2) took two square roots and two
//    divisions), the convergence test none (it compares squares), and a
//    converged pair computes no rotation (its tiny entries would send the
//    divisions down their slow paths).
//  * The sweeps stop when a sweep skipped every rotation (a warp vote),
//    where a fixed count ran the worst case on every matrix.
//  * The Gram sums read the matrix once, coalesced, into shared memory:
//    one pass a segment for the small systems; for the tall ones (the
//    weighted refit, (1, N, 9)) one block of 256 threads a matrix, a chunk
//    of kChunkRows rows at a time, thread (slice, entry) adding its
//    slice's rows for one of the n (n + 1) / 2 entries; then the lanes of
//    warp 0 add the slices of their columns and run the sweeps.
//  * svd3: one thread a matrix in blocks of 32 (512 matrices on 16 SMs),
//    state in registers with every index a constant, the same rotation,
//    test and stop per thread.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 12;                 // columns of a null-vector input
constexpr int kWarpRows = 32;             // a warp segment a matrix up to this
constexpr int kSegment = 16;              // lanes a matrix: two a warp
constexpr int kBlockThreads = 256;        // a block a matrix above it
constexpr int kChunkRows = 256;           // rows a block stages at a time
constexpr int kSvd3Threads = 32;
constexpr unsigned kFull = 0xffffffffu;

// (i, j), i <= j, of upper-triangle entry e in row-major order
__device__ __forceinline__ void entry_ij(int e, int n, int& i, int& j) {
    i = 0;
    while (e >= n - i) {
        e -= n - i;
        ++i;
    }
    j = i + e;
}

__device__ __forceinline__ int entry_of(int i, int j, int n) {
    return i * n - i * (i - 1) / 2 + (j - i);
}

// the convergence test, squared: apq^2 <= tol2 |app aqq| (tol2 = tol^2)
__device__ __forceinline__ bool relative_skip(double app, double aqq,
                                              double apq, double tol2) {
    return apq * apq <= tol2 * fabs(app * aqq);
}

// (c, s, t) of the rotation that zeroes apq: d = aqq - app, e = 2 apq,
// r = sqrt(d^2 + e^2), q = |d| + r, w = rsqrt(2 r q), c = q w,
// s = sign(d) e w, t = sign(d) e / q (rsqrt gives torch.rsqrt's bits on
// the card)
__device__ __forceinline__ void rotation(double app, double aqq, double apq,
                                         double& c, double& s, double& t) {
    const double d = aqq - app;
    const double e = 2.0 * apq;
    const double r = sqrt(d * d + e * e);
    const double q = fabs(d) + r;
    const double w = rsqrt((2.0 * r) * q);
    const double se = d >= 0.0 ? e : -e;
    c = q * w;
    s = se * w;
    t = se / q;
}

__device__ __forceinline__ double shfl(double x, int src) {
    return __shfl_sync(kFull, x, src, kSegment);
}

// One segment's matrix: lane k (< kSegment) holds g = column k of the Gram
// matrix and v = column k of V = I (zeros at k >= m; live false for a
// segment without a matrix). Runs the sweeps and writes the null vector
// (n floats) and the sweeps run. Every lane of the warp calls it.
//
// Lane k keeps index k's columns for good; g's rows are kept by place of
// the round-robin: at round r, g[j] holds the row of the index at place j
// (index 0 at place 0, index 1 + (j - 1 + r) mod (m - 1) at place j; place
// x pairs with place m - 1 - x), so a round's pairs are always the
// registers (x, m - 1 - x), and the round loop stays rolled (its code fits
// the instruction cache) with every register index a constant. Between
// rounds the rows move one place (a register rotation); after the m - 1
// rounds of a sweep they are back in index order.
template <int M>
__device__ __forceinline__ void jacobi_null_vector(
        double (&g)[M], double (&v)[M], int k, int n, bool live, double tol,
        int max_sweeps, float* out, int* sweeps_out) {
    const double tol2 = tol * tol;
    bool done = !live;
    int ran = 0;
    for (int sweep = 0; sweep < max_sweeps; ++sweep) {
        if (__all_sync(kFull, done)) break;
        bool all_skipped = true;
#pragma unroll 1
        for (int r = 0; r < M - 1; ++r) {
            // the index at each place; this lane's partner, its diagonal
            // entry and its entry at the partner's row (lanes >= m: none)
            int at[M];
#pragma unroll
            for (int j = 0; j < M; ++j)
                at[j] = j == 0 ? 0 : 1 + (j - 1 + r) % (M - 1);
            int partner = k;
            double my_diag = 0.0, my_off = 0.0;
#pragma unroll
            for (int x = 0; x < M / 2; ++x) {
                const int y = M - 1 - x;
                if (k == at[x]) {
                    partner = at[y]; my_diag = g[x]; my_off = g[y];
                }
                if (k == at[y]) {
                    partner = at[x]; my_diag = g[y]; my_off = g[x];
                }
            }
            const bool in_pair = partner != k;
            const bool is_p = k < partner;
            const double th_diag = shfl(my_diag, partner);
            const double th_off = shfl(my_off, partner);
            // app = G[p][p], aqq = G[q][q], apq = G[p][q] (lane q's row p)
            const double app = is_p ? my_diag : th_diag;
            const double aqq = is_p ? th_diag : my_diag;
            const double apq = is_p ? th_off : my_off;
            const bool skip = done || !in_pair
                || relative_skip(app, aqq, apq, tol2);
            // only where it is used: a converged pair's tiny entries would
            // send the divisions and square roots down their slow paths
            double c = 1.0, s = 0.0, t = 0.0;
            if (!skip) rotation(app, aqq, apq, c, s, t);
            // the columns: p <- c gp - s gq, q <- s gp + c gq
            const double sl = is_p ? -s : s;
#pragma unroll
            for (int i = 0; i < M; ++i) {
                const double tg = shfl(g[i], partner);
                const double tv = shfl(v[i], partner);
                g[i] = skip ? g[i] : c * g[i] + sl * tg;
                v[i] = skip ? v[i] : c * v[i] + sl * tv;
            }
            // the rows of this lane's column: places x and m - 1 - x, each
            // pair's c, s from the lane of the index at place x
#pragma unroll
            for (int x = 0; x < M / 2; ++x) {
                const int y = M - 1 - x, src = at[x];
                const bool px = at[x] < at[y];
                const double cx = shfl(c, src), sx = shfl(s, src);
                const bool kx = __shfl_sync(kFull, (int)skip, src, kSegment);
                all_skipped = all_skipped && kx;
                const double gp = px ? g[x] : g[y], gq = px ? g[y] : g[x];
                const double np = kx ? gp : cx * gp - sx * gq;
                const double nq = kx ? gq : sx * gp + cx * gq;
                g[x] = px ? np : nq;
                g[y] = px ? nq : np;
            }
            // the pair's 2 x 2 block: its rotated diagonal and zero
            if (!skip) {
                const double nd = is_p ? app - t * apq : aqq + t * apq;
#pragma unroll
                for (int x = 0; x < M / 2; ++x) {
                    const int y = M - 1 - x;
                    if (k == at[x]) { g[x] = nd; g[y] = 0.0; }
                    if (k == at[y]) { g[y] = nd; g[x] = 0.0; }
                }
            }
            // the next round's places: place j takes the row of place j + 1
            // (place m - 1 that of place 1; place 0 stays)
            const double g1 = g[1];
#pragma unroll
            for (int j = 1; j < M - 1; ++j) g[j] = g[j + 1];
            g[M - 1] = g1;
        }
        if (!done) {
            ran = sweep + 1;
            done = all_skipped;
        }
    }
    // the smallest diagonal entry (the first of equal ones); the rows are
    // in index order again
    double diag = 0.0;
#pragma unroll
    for (int i = 0; i < M; ++i)
        if (k == i) diag = g[i];
    double best = shfl(diag, 0);
    int kmin = 0;
#pragma unroll
    for (int i = 1; i < M; ++i) {
        const double di = shfl(diag, i);
        if (i < n && di < best) {
            best = di;
            kmin = i;
        }
    }
    if (!live) return;
    if (k == kmin) {   // its column of V, first nonzero entry positive
        double sign = 1.0;
        bool found = false;
#pragma unroll
        for (int i = 0; i < M; ++i)
            if (i < n && !found && v[i] != 0.0) {
                found = true;
                sign = v[i] < 0.0 ? -1.0 : 1.0;
            }
#pragma unroll
        for (int i = 0; i < M; ++i)
            if (i < n) out[i] = (float)(v[i] * sign);
    }
    if (k == 0 && sweeps_out) *sweeps_out = ran;
}

// M <= kWarpRows: two matrices a warp (one a 16-lane segment), one slice;
// a segment copies its matrix to shared memory in one coalesced pass, then
// lane k sums its own column
template <int M>
__global__ void __launch_bounds__(32)
null_vector_warp_kernel(const float* __restrict__ A, float* __restrict__ out,
                        int* __restrict__ sweeps, int B, int rows, int n,
                        double tol, int max_sweeps) {
    __shared__ float tile[2][kWarpRows * kMaxN];
    const int seg = threadIdx.x / kSegment, k = threadIdx.x % kSegment;
    const int b = blockIdx.x * 2 + seg;
    const bool live = b < B;
    float* t = tile[seg];
    if (live) {
        const float* a = A + (size_t)b * rows * n;
        for (int i = k; i < rows * n; i += kSegment) t[i] = a[i];
    }
    __syncwarp();
    double g[M], v[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
        double acc = 0.0;
        if (live && k < n && i < n)
            for (int r = 0; r < rows; ++r)
                acc = acc + (double)t[r * n + i] * (double)t[r * n + k];
        g[i] = acc;
        v[i] = i == k ? 1.0 : 0.0;
    }
    jacobi_null_vector<M>(g, v, k, n, live, tol, max_sweeps,
                          out + (size_t)b * n,
                          sweeps ? sweeps + b : nullptr);
}

// M > kWarpRows: one matrix a block of kBlockThreads threads, S slices. The
// block copies kChunkRows rows at a time to shared memory (coalesced, all
// loads of a chunk in flight at once); thread (slice, entry) adds its
// slice's rows of the chunk, in row order, for one of the n (n + 1) / 2
// Gram entries; then the lanes of warp 0 add the slices of their columns
// and run the sweeps.
template <int M>
__global__ void __launch_bounds__(kBlockThreads)
null_vector_block_kernel(const float* __restrict__ A, float* __restrict__ out,
                         int* __restrict__ sweeps, int rows, int n, int S,
                         double tol, int max_sweeps) {
    __shared__ float chunk[kChunkRows * kMaxN];
    __shared__ double part[kBlockThreads];
    const int b = blockIdx.x, tid = threadIdx.x;
    const float* a = A + (size_t)b * rows * n;
    const int E = n * (n + 1) / 2;
    const bool sums = tid < S * E;
    const int e = tid % E, slice = tid / E;
    int ei = 0, ej = 0;
    if (sums) entry_ij(e, n, ei, ej);
    double acc = 0.0;
    for (int base = 0; base < rows; base += kChunkRows) {
        const int cnt = min(kChunkRows, rows - base);
        __syncthreads();                  // the previous chunk is used up
        for (int i = tid; i < cnt * n; i += kBlockThreads)
            chunk[i] = a[(size_t)base * n + i];
        __syncthreads();
        if (sums) {
            // this slice's rows base + r, r = slice - base (mod S), ...
#pragma unroll 4
            for (int r = (slice - base % S + S) % S; r < cnt; r += S)
                acc = acc + (double)chunk[r * n + ei]
                                * (double)chunk[r * n + ej];
        }
    }
    if (sums) part[slice * E + e] = acc;
    __syncthreads();
    if (tid >= 32) return;
    const int k = tid % kSegment;
    const bool live = tid < kSegment;
    double g[M], v[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
        double x = 0.0;
        if (live && k < n && i < n) {
            const int ek = i <= k ? entry_of(i, k, n) : entry_of(k, i, n);
            x = part[ek];
            for (int sl = 1; sl < S; ++sl) x = x + part[sl * E + ek];
        }
        g[i] = x;
        v[i] = i == k ? 1.0 : 0.0;
    }
    jacobi_null_vector<M>(g, v, k, n, live, tol, max_sweeps,
                          out + (size_t)b * n,
                          sweeps ? sweeps + b : nullptr);
}

template <int M>
int launch_null_vector(const float* A, float* out, int* sweeps, int B,
                       int rows, int n, int slices, double tol,
                       int max_sweeps, cudaStream_t stream) {
    if (rows <= kWarpRows) {
        if (slices != 1) return (int)cudaErrorInvalidValue;
        null_vector_warp_kernel<M><<<(B + 1) / 2, 32, 0, stream>>>(
            A, out, sweeps, B, rows, n, tol, max_sweeps);
    } else {
        if (slices * (n * (n + 1) / 2) > kBlockThreads)
            return (int)cudaErrorInvalidValue;
        null_vector_block_kernel<M><<<B, kBlockThreads, 0, stream>>>(
            A, out, sweeps, rows, n, slices, tol, max_sweeps);
    }
    return (int)cudaGetLastError();
}

__device__ __forceinline__ double dot3col(const double (&w)[3][3], int x,
                                          int y) {
    return w[0][x] * w[0][y] + w[1][x] * w[1][y] + w[2][x] * w[2][y];
}

// the stable descending sort's step: column J before column I (I < J)
// where its value is strictly larger
template <int I, int J>
__device__ __forceinline__ void order_columns(double (&sv)[3],
                                              double (&w)[3][3],
                                              double (&v)[3][3]) {
    const bool swap = sv[J] > sv[I];
    const double a = sv[I], b = sv[J];
    sv[I] = swap ? b : a;
    sv[J] = swap ? a : b;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        const double wi = w[r][I], wj = w[r][J], vi = v[r][I], vj = v[r][J];
        w[r][I] = swap ? wj : wi;
        w[r][J] = swap ? wi : wj;
        v[r][I] = swap ? vj : vi;
        v[r][J] = swap ? vi : vj;
    }
}

// -1.0 where the first nonzero of (x0, x1, x2) is negative, else 1.0
__device__ __forceinline__ double first_sign3(double x0, double x1,
                                              double x2) {
    const double f = x0 != 0.0 ? x0 : (x1 != 0.0 ? x1 : x2);
    return f < 0.0 ? -1.0 : 1.0;
}

__global__ void __launch_bounds__(kSvd3Threads)
svd3_kernel(const float* __restrict__ A, float* __restrict__ U,
            float* __restrict__ S, float* __restrict__ Vh,
            int* __restrict__ sweeps, int B, double tol, int max_sweeps,
            double rank_tol) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    double w[3][3], v[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            w[r][c] = (double)A[(size_t)b * 9 + r * 3 + c];
            v[r][c] = r == c ? 1.0 : 0.0;
        }
    const double tol2 = tol * tol;
    bool done = false;
    int ran = 0;
    for (int sweep = 0; sweep < max_sweeps && !done; ++sweep) {
        bool all_skipped = true;
#pragma unroll
        for (int pair = 0; pair < 3; ++pair) {
            const int p = pair == 2 ? 1 : 0, q = pair == 0 ? 1 : 2;
            const double alpha = dot3col(w, p, p), beta = dot3col(w, q, q);
            const double gamma = dot3col(w, p, q);
            if (relative_skip(alpha, beta, gamma, tol2)) continue;
            all_skipped = false;
            double c, s, t;
            rotation(alpha, beta, gamma, c, s, t);
#pragma unroll
            for (int r = 0; r < 3; ++r) {
                const double wp = w[r][p], wq = w[r][q];
                w[r][p] = c * wp - s * wq;
                w[r][q] = s * wp + c * wq;
                const double vp = v[r][p], vq = v[r][q];
                v[r][p] = c * vp - s * vq;
                v[r][q] = s * vp + c * vq;
            }
        }
        ran = sweep + 1;
        done = all_skipped;
    }
    if (sweeps) sweeps[b] = ran;
    double sv[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) sv[i] = sqrt(dot3col(w, i, i));
    // stable descending sort (insertion sort's exchanges: a value moves
    // left past strictly smaller ones)
    order_columns<0, 1>(sv, w, v);
    order_columns<1, 2>(sv, w, v);
    order_columns<0, 1>(sv, w, v);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const double sign = first_sign3(v[0][i], v[1][i], v[2][i]);
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            v[r][i] = v[r][i] * sign;
            w[r][i] = w[r][i] * sign;
        }
    }
    const double tol_rank = sv[0] * rank_tol;
    double u0[3], u1[3], u2[3];           // the columns of U
#pragma unroll
    for (int r = 0; r < 3; ++r)
        u0[r] = sv[0] > 0.0 ? w[r][0] / sv[0] : (r == 0 ? 1.0 : 0.0);
    if (sv[1] > tol_rank) {
#pragma unroll
        for (int r = 0; r < 3; ++r) u1[r] = w[r][1] / sv[1];
    } else {                              // orthogonal to u0, from the axis
        int k = 0;                        // where u0 is smallest
        double uk = u0[0];
        if (fabs(u0[1]) < fabs(uk)) { k = 1; uk = u0[1]; }
        if (fabs(u0[2]) < fabs(uk)) { k = 2; uk = u0[2]; }
        double e[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) e[r] = (r == k ? 1.0 : 0.0) - uk * u0[r];
        const double nrm = sqrt(e[0] * e[0] + e[1] * e[1] + e[2] * e[2]);
#pragma unroll
        for (int r = 0; r < 3; ++r) u1[r] = e[r] / nrm;
    }
    if (sv[2] > tol_rank) {
#pragma unroll
        for (int r = 0; r < 3; ++r) u2[r] = w[r][2] / sv[2];
    } else {                              // u0 x u1
        u2[0] = u0[1] * u1[2] - u0[2] * u1[1];
        u2[1] = u0[2] * u1[0] - u0[0] * u1[2];
        u2[2] = u0[0] * u1[1] - u0[1] * u1[0];
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        S[(size_t)b * 3 + r] = (float)sv[r];
        U[(size_t)b * 9 + r * 3 + 0] = (float)u0[r];
        U[(size_t)b * 9 + r * 3 + 1] = (float)u1[r];
        U[(size_t)b * 9 + r * 3 + 2] = (float)u2[r];
#pragma unroll
        for (int i = 0; i < 3; ++i)
            Vh[(size_t)b * 9 + i * 3 + r] = (float)v[r][i];
    }
}

}  // namespace

extern "C" {

// A (B, M, n) f32 contiguous -> out (B, n) f32; sweeps (B,) int32 or null.
// slices: the Gram sums' slices (1 where M <= 32); tol: the convergence
// test's tolerance (the wrappers pass JACOBI_TOL, its one home; baked in
// here as a constant, it compiled to slower code at n = 12: 0.105 against
// 0.093 ms at (256, 12, 12) on an H100); max_sweeps: the cap on the
// Jacobi sweeps.
int hg_null_vector(const float* A, float* out, int* sweeps, int B, int M,
                   int n, int slices, double tol, int max_sweeps,
                   void* stream) {
    if (B < 1 || M < 1 || n < 1 || n > kMaxN || max_sweeps < 0 || slices < 1
            || !(tol >= 0.0))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (n + (n & 1)) {
        case 2: return launch_null_vector<2>(A, out, sweeps, B, M, n, slices,
                                             tol, max_sweeps, s);
        case 4: return launch_null_vector<4>(A, out, sweeps, B, M, n, slices,
                                             tol, max_sweeps, s);
        case 6: return launch_null_vector<6>(A, out, sweeps, B, M, n, slices,
                                             tol, max_sweeps, s);
        case 8: return launch_null_vector<8>(A, out, sweeps, B, M, n, slices,
                                             tol, max_sweeps, s);
        case 10: return launch_null_vector<10>(A, out, sweeps, B, M, n,
                                               slices, tol, max_sweeps, s);
        default: return launch_null_vector<12>(A, out, sweeps, B, M, n,
                                               slices, tol, max_sweeps, s);
    }
}

// A (B, 3, 3) f32 contiguous -> U (B, 3, 3), S (B, 3), Vh (B, 3, 3) f32;
// sweeps (B,) int32 or null.
int hg_svd3(const float* A, float* U, float* S, float* Vh, int* sweeps,
            int B, double tol, int max_sweeps, double rank_tol,
            void* stream) {
    if (B < 1 || max_sweeps < 0 || !(tol >= 0.0))
        return (int)cudaErrorInvalidValue;
    svd3_kernel<<<(B + kSvd3Threads - 1) / kSvd3Threads, kSvd3Threads, 0,
                  (cudaStream_t)stream>>>(A, U, S, Vh, sweeps, B, tol,
                                          max_sweeps, rank_tol);
    return (int)cudaGetLastError();
}

}  // extern "C"
