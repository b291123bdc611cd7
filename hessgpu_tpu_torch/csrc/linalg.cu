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
// two kernels run a fixed number of Jacobi sweeps and write no flag, so a
// core is one graph.
//
//  * hg_null_vector: A (B, M, n) f32, n <= 12 -> out (B, n) f32, the unit
//    null vector (right singular vector of the smallest singular value).
//    The Gram matrix A^T A is formed in double (a float one squares the
//    condition number and loses the null vector), diagonalised by
//    `sweeps` sweeps of cyclic Jacobi in double, and the eigenvector of
//    the smallest diagonal entry (lowest index among equal ones) is
//    rounded to float.
//  * hg_svd3: A (B, 3, 3) f32 -> U, S, Vh f32 as torch.linalg.svd gives
//    them, by one-sided Jacobi in double on A itself; singular values
//    sorted descending (stable); a U column whose singular value is at most
//    rank_tol times the largest is completed to an orthonormal basis (a
//    rank-deficient hypothesis gives no NaN).
//
// The plain PyTorch versions (ops/linalg.py) run the same algorithm step
// by step: the Gram sums in the same order (rows dealt to `slices`
// slices, row r to slice r mod S, each slice adding its rows' products in
// row order from 0.0, then the slices added in slice order), the same
// round-robin rotation order, the same expressions, and this file is
// compiled with -fmad=false, so the kernels equal them bit for bit. Sign
// rule: each right singular vector's first nonzero entry is positive; svd3
// flips u_i with v_i (ops/linalg.py says why this rule).
//
// What bounds them on this card: neither bytes (a few hundred KB) nor the
// FP64 rate (some 10^8 operations for 512 matrices: ~3 us at 34 TFLOP/s)
// but the latency of each matrix's chain of dependent rotations. So the
// design gives every matrix its own warp (a block where the rows are many)
// and runs a round's m / 2 disjoint rotations at once: a sweep is m - 1
// rounds of a few dependent steps, not m (m - 1) / 2 rotations one after
// another. A warp keeps its G and V in shared memory; warps never wait for
// each other.
//
// Layout: M <= 32 rows (the 8 x 9 eight-point and 12 x 12 DLT systems): 4
// warps a block, one matrix a warp, one slice. More rows (the weighted
// refit, (1, N, 9)): one block of 256 threads a matrix; thread (slice,
// entry) sums its slice's rows for one of the n (n + 1) / 2 Gram entries,
// then warp 0 adds the slices and runs the sweeps. svd3: one thread a
// matrix.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 12;                 // columns of a null-vector input
constexpr int kMaxM = kMaxN;              // n rounded up to even
constexpr int kMaxPairs = kMaxM / 2;
constexpr int kMaxEntries = kMaxN * (kMaxN + 1) / 2;
constexpr int kWarpRows = 32;             // a warp a matrix up to this
constexpr int kWarpsPerBlock = 4;
constexpr int kBlockThreads = 256;        // a block a matrix above it

struct Jacobi {                           // one matrix's state
    double G[kMaxM * kMaxM];
    double V[kMaxM * kMaxM];
    double c[kMaxPairs], s[kMaxPairs], t[kMaxPairs];
    double app[kMaxPairs], aqq[kMaxPairs], apq[kMaxPairs];
    int p[kMaxPairs], q[kMaxPairs], skip[kMaxPairs];
};

// (i, j), i <= j, of upper-triangle entry e in row-major order
__device__ __forceinline__ void entry_ij(int e, int n, int& i, int& j) {
    i = 0;
    while (e >= n - i) {
        e -= n - i;
        ++i;
    }
    j = i + e;
}

// the sum over the rows of `slice` (rows slice, slice + S, ...) of
// a[r][i] * a[r][j], added in row order from 0.0; a row past M adds 0.0
__device__ __forceinline__ double slice_sum(const float* a, int M, int n,
                                            int S, int slice, int i, int j) {
    const int K = (M + S - 1) / S;
    double acc = 0.0;
    for (int k = 0; k < K; ++k) {
        const int r = k * S + slice;
        const double prod = r < M ? (double)a[r * n + i] * (double)a[r * n + j]
                                  : 0.0;
        acc = acc + prod;
    }
    return acc;
}

// -1.0 where the first nonzero of x[0], x[stride], ... (n entries) is
// negative, else 1.0
__device__ __forceinline__ double first_sign(const double* x, int stride,
                                             int n) {
    for (int i = 0; i < n; ++i)
        if (x[i * stride] != 0.0) return x[i * stride] < 0.0 ? -1.0 : 1.0;
    return 1.0;
}

// G = 0 with g's entries placed symmetrically is done by the caller; this
// sets V = I and runs the sweeps on one warp, then writes the null vector.
__device__ void jacobi_null_vector(Jacobi& J, int n, int sweeps, int lane,
                                   float* out) {
    const int m = n + (n & 1);
    const int h = m / 2;
    for (int it = lane; it < m * m; it += 32)
        J.V[it] = (it / m == it % m) ? 1.0 : 0.0;
    __syncwarp();
    for (int sweep = 0; sweep < sweeps; ++sweep) {
        for (int r = 0; r < m - 1; ++r) {
            if (lane < h) {
                // round r: index 0 at place 0, index 1 + (j - 1 + r) mod
                // (m - 1) at place j; place k pairs with place m - 1 - k
                const int ja = lane, jb = m - 1 - lane;
                const int a = ja == 0 ? 0 : 1 + (ja - 1 + r) % (m - 1);
                const int b = 1 + (jb - 1 + r) % (m - 1);
                const int p = a < b ? a : b, q = a < b ? b : a;
                const double app = J.G[p * m + p], aqq = J.G[q * m + q];
                const double apq = J.G[p * m + q];
                const int sk = apq == 0.0;
                double c = 1.0, s = 0.0, t = 0.0;
                if (!sk) {
                    const double tau = (aqq - app) / (2.0 * apq);
                    t = (tau >= 0.0 ? 1.0 : -1.0)
                        / (fabs(tau) + sqrt(1.0 + tau * tau));
                    c = 1.0 / sqrt(1.0 + t * t);
                    s = t * c;
                }
                J.p[lane] = p; J.q[lane] = q; J.skip[lane] = sk;
                J.c[lane] = c; J.s[lane] = s; J.t[lane] = t;
                J.app[lane] = app; J.aqq[lane] = aqq; J.apq[lane] = apq;
            }
            __syncwarp();
            // the columns of G and V: item (row k, pair x)
            for (int it = lane; it < m * h; it += 32) {
                const int k = it / h, x = it % h;
                if (J.skip[x]) continue;
                const int p = J.p[x], q = J.q[x];
                const double c = J.c[x], s = J.s[x];
                const double gp = J.G[k * m + p], gq = J.G[k * m + q];
                J.G[k * m + p] = c * gp - s * gq;
                J.G[k * m + q] = s * gp + c * gq;
                const double vp = J.V[k * m + p], vq = J.V[k * m + q];
                J.V[k * m + p] = c * vp - s * vq;
                J.V[k * m + q] = s * vp + c * vq;
            }
            __syncwarp();
            // the rows of G: item (pair x, column k)
            for (int it = lane; it < m * h; it += 32) {
                const int x = it / m, k = it % m;
                if (J.skip[x]) continue;
                const int p = J.p[x], q = J.q[x];
                const double c = J.c[x], s = J.s[x];
                const double gp = J.G[p * m + k], gq = J.G[q * m + k];
                J.G[p * m + k] = c * gp - s * gq;
                J.G[q * m + k] = s * gp + c * gq;
            }
            __syncwarp();
            if (lane < h && !J.skip[lane]) {
                const int p = J.p[lane], q = J.q[lane];
                const double t = J.t[lane], apq = J.apq[lane];
                J.G[p * m + p] = J.app[lane] - t * apq;
                J.G[q * m + q] = J.aqq[lane] + t * apq;
                J.G[p * m + q] = 0.0;
                J.G[q * m + p] = 0.0;
            }
            __syncwarp();
        }
    }
    // the smallest diagonal entry (the first of equal ones), its column of
    // V, signed so that its first nonzero entry is positive
    int k = 0;
    for (int i = 1; i < n; ++i)
        if (J.G[i * m + i] < J.G[k * m + k]) k = i;
    const double sign = first_sign(J.V + k, m, n);
    for (int i = lane; i < n; i += 32)
        out[i] = (float)(J.V[i * m + k] * sign);
}

__device__ void place_gram(Jacobi& J, int n, int e, double g) {
    const int m = n + (n & 1);
    int i, j;
    entry_ij(e, n, i, j);
    J.G[i * m + j] = g;
    J.G[j * m + i] = g;
}

__device__ void zero_gram(Jacobi& J, int n, int lane) {
    const int m = n + (n & 1);
    for (int it = lane; it < m * m; it += 32) J.G[it] = 0.0;
}

// M <= kWarpRows: one matrix a warp, one slice
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
null_vector_warp_kernel(const float* __restrict__ A, float* __restrict__ out,
                        int B, int M, int n, int sweeps) {
    __shared__ Jacobi state[kWarpsPerBlock];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int b = blockIdx.x * kWarpsPerBlock + warp;
    if (b >= B) return;
    Jacobi& J = state[warp];
    const float* a = A + (size_t)b * M * n;
    zero_gram(J, n, lane);
    __syncwarp();
    const int E = n * (n + 1) / 2;
    for (int e = lane; e < E; e += 32) {
        int i, j;
        entry_ij(e, n, i, j);
        place_gram(J, n, e, slice_sum(a, M, n, 1, 0, i, j));
    }
    __syncwarp();
    jacobi_null_vector(J, n, sweeps, lane, out + (size_t)b * n);
}

// M > kWarpRows: one matrix a block of kBlockThreads threads, S slices
__global__ void __launch_bounds__(kBlockThreads)
null_vector_block_kernel(const float* __restrict__ A, float* __restrict__ out,
                         int M, int n, int S, int sweeps) {
    __shared__ Jacobi J;
    __shared__ double part[kBlockThreads];
    const int b = blockIdx.x, tid = threadIdx.x, lane = tid % 32;
    const float* a = A + (size_t)b * M * n;
    const int E = n * (n + 1) / 2;
    if (tid < S * E) {
        const int e = tid % E, slice = tid / E;
        int i, j;
        entry_ij(e, n, i, j);
        part[slice * E + e] = slice_sum(a, M, n, S, slice, i, j);
    }
    __syncthreads();
    if (tid >= 32) return;
    zero_gram(J, n, lane);
    __syncwarp();
    for (int e = lane; e < E; e += 32) {
        double g = part[e];
        for (int slice = 1; slice < S; ++slice) g = g + part[slice * E + e];
        place_gram(J, n, e, g);
    }
    __syncwarp();
    jacobi_null_vector(J, n, sweeps, lane, out + (size_t)b * n);
}

__device__ __forceinline__ double dot3col(const double w[3][3], int x,
                                          int y) {
    return w[0][x] * w[0][y] + w[1][x] * w[1][y] + w[2][x] * w[2][y];
}

__global__ void __launch_bounds__(128)
svd3_kernel(const float* __restrict__ A, float* __restrict__ U,
            float* __restrict__ S, float* __restrict__ Vh, int B, int sweeps,
            double rank_tol) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    double w[3][3], v[3][3];
    for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) {
            w[r][c] = (double)A[(size_t)b * 9 + r * 3 + c];
            v[r][c] = r == c ? 1.0 : 0.0;
        }
    for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll
        for (int pair = 0; pair < 3; ++pair) {
            const int p = pair == 2 ? 1 : 0, q = pair == 0 ? 1 : 2;
            const double alpha = dot3col(w, p, p), beta = dot3col(w, q, q);
            const double gamma = dot3col(w, p, q);
            if (gamma == 0.0) continue;
            const double zeta = (beta - alpha) / (2.0 * gamma);
            const double t = (zeta >= 0.0 ? 1.0 : -1.0)
                             / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
            const double c = 1.0 / sqrt(1.0 + t * t);
            const double s = t * c;
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
    }
    double sv[3];
    int order[3] = {0, 1, 2};
    for (int i = 0; i < 3; ++i) sv[i] = sqrt(dot3col(w, i, i));
    // stable descending sort: a value moves left past strictly smaller ones
    for (int i = 1; i < 3; ++i)
        for (int j = i; j > 0 && sv[order[j]] > sv[order[j - 1]]; --j) {
            const int tmp = order[j];
            order[j] = order[j - 1];
            order[j - 1] = tmp;
        }
    double ws[3][3], vs[3][3], ss[3];
    for (int i = 0; i < 3; ++i) {
        const int o = order[i];
        ss[i] = sv[o];
        const double sign = first_sign(&v[0][o], 3, 3);
        for (int r = 0; r < 3; ++r) {
            vs[r][i] = v[r][o] * sign;
            ws[r][i] = w[r][o] * sign;
        }
    }
    const double tol = ss[0] * rank_tol;
    double u[3][3];                       // u[i] is column i of U
    for (int r = 0; r < 3; ++r)
        u[0][r] = ss[0] > 0.0 ? ws[r][0] / ss[0] : (r == 0 ? 1.0 : 0.0);
    if (ss[1] > tol) {
        for (int r = 0; r < 3; ++r) u[1][r] = ws[r][1] / ss[1];
    } else {                              // orthogonal to u0, from the axis
        int k = 0;                        // where u0 is smallest
        for (int r = 1; r < 3; ++r)
            if (fabs(u[0][r]) < fabs(u[0][k])) k = r;
        const double uk = u[0][k];
        double e[3];
        for (int r = 0; r < 3; ++r) e[r] = (r == k ? 1.0 : 0.0) - uk * u[0][r];
        const double nrm = sqrt(e[0] * e[0] + e[1] * e[1] + e[2] * e[2]);
        for (int r = 0; r < 3; ++r) u[1][r] = e[r] / nrm;
    }
    if (ss[2] > tol) {
        for (int r = 0; r < 3; ++r) u[2][r] = ws[r][2] / ss[2];
    } else {                              // u0 x u1
        u[2][0] = u[0][1] * u[1][2] - u[0][2] * u[1][1];
        u[2][1] = u[0][2] * u[1][0] - u[0][0] * u[1][2];
        u[2][2] = u[0][0] * u[1][1] - u[0][1] * u[1][0];
    }
    for (int i = 0; i < 3; ++i) {
        S[(size_t)b * 3 + i] = (float)ss[i];
        for (int r = 0; r < 3; ++r) {
            U[(size_t)b * 9 + r * 3 + i] = (float)u[i][r];
            Vh[(size_t)b * 9 + i * 3 + r] = (float)vs[r][i];
        }
    }
}

}  // namespace

extern "C" {

// A (B, M, n) f32 contiguous -> out (B, n) f32. slices: the Gram sums'
// slices (1 where M <= 32); sweeps: the Jacobi sweeps.
int hg_null_vector(const float* A, float* out, int B, int M, int n,
                   int slices, int sweeps, void* stream) {
    if (B < 1 || M < 1 || n < 1 || n > kMaxN || sweeps < 0 || slices < 1)
        return (int)cudaErrorInvalidValue;
    if (M <= kWarpRows) {
        if (slices != 1) return (int)cudaErrorInvalidValue;
        const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
        null_vector_warp_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                                  (cudaStream_t)stream>>>(A, out, B, M, n,
                                                          sweeps);
    } else {
        if (slices * (n * (n + 1) / 2) > kBlockThreads
                || n * (n + 1) / 2 > kMaxEntries)
            return (int)cudaErrorInvalidValue;
        null_vector_block_kernel<<<B, kBlockThreads, 0,
                                   (cudaStream_t)stream>>>(A, out, M, n,
                                                           slices, sweeps);
    }
    return (int)cudaGetLastError();
}

// A (B, 3, 3) f32 contiguous -> U (B, 3, 3), S (B, 3), Vh (B, 3, 3) f32.
int hg_svd3(const float* A, float* U, float* S, float* Vh, int B, int sweeps,
            double rank_tol, void* stream) {
    if (B < 1 || sweeps < 0) return (int)cudaErrorInvalidValue;
    svd3_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        A, U, S, Vh, B, sweeps, rank_tol);
    return (int)cudaGetLastError();
}

}  // extern "C"
