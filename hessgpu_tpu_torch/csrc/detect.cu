// Fused detection for one octave on Hopper (sm_90a): response of every
// plane, then per key level the 3x3x3 NMS, threshold, edge test, subpixel
// solve, typing and the gradient/rotation maps. Plain C interface, loaded
// with ctypes (hessgpu_tpu_torch/ops/cuda/detect.py).
//
// Replaces detect_octave_pallas (hessgpu_tpu/ops/pallas/detect.py), its plain
// output set: valid, response, dx, dy, ds, ftype, grad, rot, each
// (B, NK, H, W). The fp16 rounding of the response, done outside the TPU
// kernel, is folded in here with the half intrinsics; atan2f stands where
// the TPU kernel carried its own polynomial.
//
// Output contract: valid (bytes 0/1), grad and rot are written at every
// cell. response, dx, dy, ds and ftype are written only where valid is 1;
// everywhere else they keep whatever the caller's buffers held. Their one
// reader, the compaction (ops/compaction.py), gathers them at valid cells
// only. The JAX package's "compressed" mode drops the same five maps.
//
// What bounds it on this card: bytes and instruction issue about equally.
// Per pixel it reads L Gaussian planes (20 B at L=5) and writes 9 B per key
// level (27 B at NK=3), plus 20 B per valid cell (about a thousand cells of
// a 4.9 M pixel batch). The whole keypoint test is ~300 instructions per pixel
// and key level, as long as the bytes. So the design
//   - keeps every intermediate out of device memory: a block stages its
//     tile of all needed Gaussian planes (halo 2, clamped to the image) in
//     shared memory and computes each plane's response once into a second
//     shared tile (halo 1) that the adjacent key levels share;
//   - runs the cheap test first: per pixel and key level only the threshold
//     and the gradient are dense; the 27-neighbour NMS runs for a warp only
//     if one of its lanes passes the threshold, and the edge test, subpixel
//     solve, typing and fp16 rounding only if one passes the NMS too (~4% of
//     a Hessian octave-0 warp's levels reach the NMS);
//   - computes every tile index once per thread and walks the planes with
//     it, so staging and the response tile cost a few instructions a cell;
//   - has 256 threads a block, two rows each, and at most 64 registers a
//     thread, so that at least four blocks share an SM and one block's
//     staging loads hide behind the others' work.
//
// Border semantics are those of the plain PyTorch version (ops/hessian.py +
// ops/keypoint.py): a neighbour outside the image reads the clamped cell, of
// the Gaussian for the response and of the response for the NMS. Both tiles
// hold the clamped cells' values, so the tests read raw tile neighbours.
// Arithmetic order follows the plain version expression by expression and
// the file is compiled with -fmad=false, so valid and, at valid cells,
// ftype, response, dx, dy and ds agree with it bit for bit; grad too.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 16;
constexpr int kMaxKeys = 8;
constexpr int kTW = 32;   // output tile: a warp is one row of it
constexpr int kTH = 16;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kTW * kTH / kThreads;   // 2
constexpr int kGW = kTW + 4, kGH = kTH + 4;   // Gaussian tile, halo 2
constexpr int kRW = kTW + 2, kRH = kTH + 2;   // response tile, halo 1
constexpr int kGC = kGW * kGH, kRC = kRW * kRH;   // cells per plane
constexpr int kGIter = (kGC + kThreads - 1) / kThreads;
constexpr int kRIter = (kRC + kThreads - 1) / kThreads;
constexpr unsigned kAll = 0xffffffffu;

constexpr int TYPE_DARK_BLOB = 0;
constexpr int TYPE_BRIGHT_BLOB = 1;
constexpr int TYPE_SADDLE = 2;

struct DetectParams {
    int L, H, W;
    int NK;       // key levels
    int p_lo;     // first Gaussian plane staged
    int NP;       // Gaussian planes staged
    int NR;       // response planes (NP for Hessian, NP-1 for DoG)
    int is_hessian, subpixel, darkness;
    float threshold;   // T
    float thr0;        // 0.8*T with subpixel, else T (no darkness adaption)
    float te;          // (e+1)^2/e
    float norms[kMaxPlanes];    // per response plane, index from p_lo
    int key_levels[kMaxKeys];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(kThreads, 4)
detect_kernel(const float* __restrict__ gauss, unsigned char* __restrict__ o_valid,
              float* __restrict__ o_resp, float* __restrict__ o_dx,
              float* __restrict__ o_dy, float* __restrict__ o_ds,
              int* __restrict__ o_type, float* __restrict__ o_grad,
              float* __restrict__ o_rot, DetectParams P) {
    extern __shared__ float smem[];
    float* sg = smem;                  // NP x kGH x kGW
    float* sr = smem + P.NP * kGC;     // NR x kRH x kRW

    const int H = P.H, W = P.W;
    const long long hw = (long long)H * W;
    const int b = blockIdx.z;
    const int row0 = blockIdx.y * kTH;
    const int col0 = blockIdx.x * kTW;
    const int tid = threadIdx.x;
    const float* g = gauss + ((long long)b * P.L + P.p_lo) * hw;

    // Gaussian tile: sg[p][ty][tx] = plane p at clamp(row0-2+ty, col0-2+tx).
    // A thread stages the same cells of every plane: offsets once, then
    // kGIter independent loads per plane.
    int goff[kGIter];
#pragma unroll
    for (int k = 0; k < kGIter; ++k) {
        const int i = tid + k * kThreads;
        const int ty = i / kGW, tx = i - ty * kGW;
        goff[k] = i < kGC ? clampi(row0 - 2 + ty, 0, H - 1) * W
                              + clampi(col0 - 2 + tx, 0, W - 1)
                          : -1;
    }
#pragma unroll 2
    for (int p = 0; p < P.NP; ++p) {
        const float* gp = g + p * hw;
        float val[kGIter];
#pragma unroll
        for (int k = 0; k < kGIter; ++k)
            if (goff[k] >= 0) val[k] = __ldg(gp + goff[k]);
#pragma unroll
        for (int k = 0; k < kGIter; ++k)
            if (goff[k] >= 0) sg[p * kGC + tid + k * kThreads] = val[k];
    }
    __syncthreads();

    // Response tile: sr[p][ty][tx] = response of plane p at the clamped cell
    // clamp(row0-1+ty, col0-1+tx). Its Gaussian neighbours are raw tile
    // neighbours: the tile already holds the clamped cells.
#pragma unroll
    for (int k = 0; k < kRIter; ++k) {
        const int i = tid + k * kThreads;
        if (i >= kRC) break;
        const int ty = i / kRW, tx = i - ty * kRW;
        const int gi = (clampi(row0 - 1 + ty, 0, H - 1) - (row0 - 2)) * kGW
            + clampi(col0 - 1 + tx, 0, W - 1) - (col0 - 2);
        for (int p = 0; p < P.NR; ++p) {
            const float* gp = sg + p * kGC + gi;
            float val;
            if (P.is_hessian) {
                const float two_c = 2.0f * gp[0];
                const float lxx = gp[-1] - two_c + gp[1];
                const float lyy = gp[-kGW] - two_c + gp[kGW];
                const float lxy = (gp[-kGW + 1] - gp[-kGW - 1]
                                   + gp[kGW - 1] - gp[kGW + 1]) * 0.25f;
                val = (lxx * lyy - lxy * lxy) * P.norms[p];
            } else {
                val = gp[kGC] - gp[0];
            }
            sr[p * kRC + i] = val;
        }
    }
    __syncthreads();

    const int lane = tid & 31;
    for (int rr = 0; rr < kRowsPerThread; ++rr) {
        // warp w of the block takes tile rows w and w + 8: one row a pass
        const int ty = (tid >> 5) + rr * (kThreads / kTW), tx = lane;
        const int r = row0 + ty, c = col0 + tx;
        const bool inside = r < H && c < W;
        const bool interior = r > 0 && r < H - 1 && c > 0 && c < W - 1;
        const int ri = (ty + 1) * kRW + tx + 1;   // response tile index
        const int gi = (ty + 2) * kGW + tx + 2;   // Gaussian tile index

        for (int li = 0; li < P.NK; ++li) {
            const int pc = P.key_levels[li] - P.p_lo;
            const float* cur = sr + pc * kRC + ri;
            const float* gk = sg + pc * kGC + gi;   // key level's Gaussian
            const long long o = (((long long)b * P.NK + li) * H + r) * W + c;

            const float v = cur[0];
            const float gc = gk[0];
            float thr = P.threshold, thr0 = P.thr0;
            if (P.darkness) {
                thr = P.threshold * fminf(2.0f * gc + 0.1f, 1.0f);
                thr0 = P.subpixel ? 0.8f * thr : thr;
            }
            // the cheap tests first: the threshold, for every lane
            bool cand = interior && (fabsf(v) > thr0);
            bool valid = false;
            if (__any_sync(kAll, cand)) {
                const float* prv = cur - kRC;
                const float* nxt = cur + kRC;
                const float left = cur[-1], right = cur[1];
                const float up = cur[-kRW], down = cur[kRW];
                const float tl = cur[-kRW - 1], tr = cur[-kRW + 1];
                const float bl = cur[kRW - 1], br = cur[kRW + 1];
                // the 24 neighbours compared with >= / <= (left/right are
                // strict)
                float rest_max = fmaxf(fmaxf(fmaxf(up, down), fmaxf(tl, tr)),
                                       fmaxf(bl, br));
                float rest_min = fminf(fminf(fminf(up, down), fminf(tl, tr)),
                                       fminf(bl, br));
#pragma unroll
                for (int a = -1; a <= 1; ++a) {
#pragma unroll
                    for (int q = -1; q <= 1; ++q) {
                        const float x0 = prv[a * kRW + q];
                        const float x1 = nxt[a * kRW + q];
                        rest_max = fmaxf(rest_max, fmaxf(x0, x1));
                        rest_min = fminf(rest_min, fminf(x0, x1));
                    }
                }
                bool is_max = (v > fmaxf(left, right)) && (v >= rest_max);
                bool is_min = (v < fminf(left, right)) && (v <= rest_min);
                if (P.is_hessian) {
                    is_max = is_max && (v >= 0.0f);
                    is_min = is_min && (v <= 0.0f);
                }
                cand = cand && (is_max || is_min);

                if (__any_sync(kAll, cand)) {
                    // edge rejection on the response map
                    const float fx = 0.5f * (right - left);
                    const float fy = 0.5f * (down - up);
                    const float vx2 = 2.0f * v;
                    const float fxx = left + right - vx2;
                    const float fyy = up + down - vx2;
                    const float fxy = 0.25f * (br + tl - bl - tr);
                    const float det2 = fxx * fyy - fxy * fxy;
                    const float trc = fxx + fyy;
                    const float tr2 = trc * trc;
                    bool extremum = cand && (det2 > 0.0f)
                        && (tr2 <= P.te * det2);

                    float dx = 0.0f, dy = 0.0f, ds = 0.0f, response = v;
                    if (P.subpixel) {
                        const float cn = nxt[0];
                        const float cp = prv[0];
                        const float fs = 0.5f * (cn - cp);
                        const float fss = cn + cp - vx2;
                        const float fxs = 0.25f * (nxt[1] + prv[-1]
                                                   - nxt[-1] - prv[1]);
                        const float fys = 0.25f * (nxt[kRW] + prv[-kRW]
                                                   - nxt[-kRW] - prv[kRW]);
                        // symmetric 3x3 adjugate solve of
                        // [fxx fxy fxs; fxy fyy fys; fxs fys fss] x
                        //     = -[fx fy fs]
                        const float a = fxx, bb = fxy, cc = fxs, r0 = -fx;
                        const float d = fyy, e = fys, r1 = -fy;
                        const float f = fss, r2 = -fs;
                        const float C00 = d * f - e * e;
                        const float C01 = cc * e - bb * f;
                        const float C02 = bb * e - cc * d;
                        const float det = a * C00 + bb * C01 + cc * C02;
                        const bool ok = fabsf(det) >= 1e-30f;
                        const float rdet = 1.0f / (ok ? det : 1.0f);
                        const float s0 = r0 * rdet, s1 = r1 * rdet;
                        const float s2 = r2 * rdet;
                        const float sx = C00 * s0 + C01 * s1 + C02 * s2;
                        const float C11 = a * f - cc * cc;
                        const float C12 = bb * cc - a * e;
                        const float sy = C01 * s0 + C11 * s1 + C12 * s2;
                        const float C22 = a * d - bb * bb;
                        const float ss = C02 * s0 + C12 * s1 + C22 * s2;
                        dx = ok ? sx : 0.0f;
                        dy = ok ? sy : 0.0f;
                        ds = ok ? ss : 0.0f;
                        const float refined =
                            v + 0.5f * (dx * fx + dy * fy + ds * fs);
                        response = ok ? refined : v;
                        const bool passed = (fabsf(response) > thr)
                            && (fabsf(ds) < 1.0f) && (fabsf(dx) < 1.0f)
                            && (fabsf(dy) < 1.0f);
                        // a degenerate system accepts the unrefined keypoint
                        extremum = extremum && (!ok || passed);
                    }
                    valid = extremum;
                    if (valid) {
                        int ftype;
                        if (P.is_hessian) {
                            const float g_lxx = gk[-1] - 2.0f * gc + gk[1];
                            ftype = g_lxx > 0.0f ? TYPE_DARK_BLOB
                                                 : TYPE_BRIGHT_BLOB;
                            if (response < 0.0f) ftype = TYPE_SADDLE;
                        } else {
                            ftype = is_max ? TYPE_BRIGHT_BLOB : TYPE_DARK_BLOB;
                        }
                        // the reference keeps the response as fp16 in the
                        // key map
                        o_resp[o] = __half2float(__float2half_rn(response));
                        o_dx[o] = dx;
                        o_dy[o] = dy;
                        o_ds[o] = ds;
                        o_type[o] = ftype;
                    }
                }
            }

            if (inside) {
                const float dxg = gk[1] - gk[-1];
                const float dyg = gk[kGW] - gk[-kGW];
                const float mag = 0.5f * sqrtf(dxg * dxg + dyg * dyg);
                o_valid[o] = valid ? 1 : 0;
                o_grad[o] = mag;
                o_rot[o] = (mag == 0.0f) ? 0.0f : atan2f(dyg, dxg);
            }
        }
    }
}

}  // namespace

extern "C" {

// gauss (B, L, H, W) f32 contiguous -> eight (B, NK, H, W) maps (valid as
// bytes 0/1, ftype i32, the rest f32). valid, grad and rot are written at
// every cell; response, dx, dy, ds and ftype only where valid is 1.
// key_levels: NK ascending host ints; norms: L host floats (per Gaussian
// level; unused for DoG).
int hg_detect_octave(const float* gauss, unsigned char* valid, float* resp,
                     float* dx, float* dy, float* ds, int* ftype, float* grad,
                     float* rot, int B, int L, int H, int W,
                     const int* key_levels, int NK, const float* norms,
                     int is_hessian, int subpixel, int darkness,
                     float threshold, float thr0, float te, void* stream) {
    if (B < 1 || B > 65535 || H < 1 || W < 1 || NK < 1 || NK > kMaxKeys)
        return (int)cudaErrorInvalidValue;
    DetectParams P;
    P.L = L; P.H = H; P.W = W; P.NK = NK;
    P.p_lo = key_levels[0] - 1;
    P.NR = key_levels[NK - 1] + 2 - P.p_lo;
    P.NP = is_hessian ? P.NR : P.NR + 1;
    if (P.p_lo < 0 || P.p_lo + P.NP > L || P.NP > kMaxPlanes)
        return (int)cudaErrorInvalidValue;
    for (int i = 0; i < NK; ++i) {
        if (i > 0 && key_levels[i] <= key_levels[i - 1])
            return (int)cudaErrorInvalidValue;
        P.key_levels[i] = key_levels[i];
    }
    for (int i = 0; i < P.NR; ++i) P.norms[i] = norms[P.p_lo + i];
    P.is_hessian = is_hessian; P.subpixel = subpixel; P.darkness = darkness;
    P.threshold = threshold; P.thr0 = thr0; P.te = te;

    const size_t smem = sizeof(float) * (size_t)(P.NP * kGC + P.NR * kRC);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            detect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
    detect_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        gauss, valid, resp, dx, dy, ds, ftype, grad, rot, P);
    return (int)cudaGetLastError();
}

}  // extern "C"
