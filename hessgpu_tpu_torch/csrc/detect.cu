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
// What bounds it on this card: bytes. Per pixel it reads L Gaussian planes
// (20 B at L=5) and writes 29 B per key level (87 B at NK=3); the arithmetic
// (a few hundred float ops per pixel) is far under the float32 rate for that
// traffic. So the design keeps every intermediate out of device memory: a
// block stages its tile of all needed Gaussian planes (halo 2, index clamped
// to the image) in shared memory, computes each plane's response once into a
// second shared tile (halo 1) that the adjacent key levels share, and each
// thread then runs the whole keypoint test for its pixel out of shared
// memory and writes the eight outputs. No response map, shifted copy or
// padded plane ever reaches device memory.
//
// Border semantics are those of the plain PyTorch version (ops/hessian.py +
// ops/keypoint.py): a neighbour outside the image reads the clamped cell, of
// the Gaussian for the response and of the response for the NMS. Arithmetic
// order follows the plain version expression by expression and the file is
// compiled with -fmad=false, so valid, ftype, response, dx, dy, ds and grad
// agree with it bit for bit.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 16;
constexpr int kMaxKeys = 8;
constexpr int kTW = 32;   // output tile = one thread per pixel
constexpr int kTH = 16;
constexpr int kThreads = kTW * kTH;
constexpr int kGW = kTW + 4, kGH = kTH + 4;   // Gaussian tile, halo 2
constexpr int kRW = kTW + 2, kRH = kTH + 2;   // response tile, halo 1

constexpr int TYPE_DARK_BLOB = 0;
constexpr int TYPE_BRIGHT_BLOB = 1;
constexpr int TYPE_SADDLE = 2;
constexpr int TYPE_NONE = 3;

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

__global__ void __launch_bounds__(kThreads)
detect_kernel(const float* __restrict__ gauss, unsigned char* __restrict__ o_valid,
              float* __restrict__ o_resp, float* __restrict__ o_dx,
              float* __restrict__ o_dy, float* __restrict__ o_ds,
              int* __restrict__ o_type, float* __restrict__ o_grad,
              float* __restrict__ o_rot, DetectParams P) {
    extern __shared__ float smem[];
    float* sg = smem;                          // NP x kGH x kGW
    float* sr = smem + P.NP * kGH * kGW;       // NR x kRH x kRW

    const int H = P.H, W = P.W;
    const long long hw = (long long)H * W;
    const int b = blockIdx.z;
    const int row0 = blockIdx.y * kTH;
    const int col0 = blockIdx.x * kTW;
    const int tid = threadIdx.x;
    const float* g = gauss + ((long long)b * P.L + P.p_lo) * hw;

    // Gaussian tile: sg[p][ty][tx] = plane p at clamp(row0-2+ty, col0-2+tx)
    for (int i = tid; i < P.NP * kGH * kGW; i += kThreads) {
        const int p = i / (kGH * kGW);
        const int rem = i - p * (kGH * kGW);
        const int ty = rem / kGW, tx = rem - ty * kGW;
        const int gy = clampi(row0 - 2 + ty, 0, H - 1);
        const int gx = clampi(col0 - 2 + tx, 0, W - 1);
        sg[i] = g[p * hw + (long long)gy * W + gx];
    }
    __syncthreads();

    // Response tile: sr[p][ty][tx] = response of plane p at the clamped cell
    // (r, c) = clamp(row0-1+ty, col0-1+tx), from Gaussian neighbours that are
    // clamped in turn. Shared-tile index of image row y is y - (row0-2).
    for (int i = tid; i < P.NR * kRH * kRW; i += kThreads) {
        const int p = i / (kRH * kRW);
        const int rem = i - p * (kRH * kRW);
        const int ty = rem / kRW, tx = rem - ty * kRW;
        const int r = clampi(row0 - 1 + ty, 0, H - 1);
        const int c = clampi(col0 - 1 + tx, 0, W - 1);
        const int i0 = r - (row0 - 2), j0 = c - (col0 - 2);
        const float* gp = sg + p * (kGH * kGW);
        float val;
        if (P.is_hessian) {
            const int im = clampi(r - 1, 0, H - 1) - (row0 - 2);
            const int ip = clampi(r + 1, 0, H - 1) - (row0 - 2);
            const int jm = clampi(c - 1, 0, W - 1) - (col0 - 2);
            const int jp = clampi(c + 1, 0, W - 1) - (col0 - 2);
            const float two_c = 2.0f * gp[i0 * kGW + j0];
            const float lxx = gp[i0 * kGW + jm] - two_c + gp[i0 * kGW + jp];
            const float lyy = gp[im * kGW + j0] - two_c + gp[ip * kGW + j0];
            const float lxy = (gp[im * kGW + jp] - gp[im * kGW + jm]
                               + gp[ip * kGW + jm] - gp[ip * kGW + jp]) * 0.25f;
            val = (lxx * lyy - lxy * lxy) * P.norms[p];
        } else {
            val = gp[kGH * kGW + i0 * kGW + j0] - gp[i0 * kGW + j0];
        }
        sr[i] = val;
    }
    __syncthreads();

    const int ty = tid / kTW, tx = tid - ty * kTW;
    const int r = row0 + ty, c = col0 + tx;
    if (r >= H || c >= W) return;

    // response-tile indices of the clamped neighbours (tile row of image row
    // y is y - (row0-1))
    const int i0 = ty + 1, j0 = tx + 1;
    const int im = clampi(r - 1, 0, H - 1) - (row0 - 1);
    const int ip = clampi(r + 1, 0, H - 1) - (row0 - 1);
    const int jm = clampi(c - 1, 0, W - 1) - (col0 - 1);
    const int jp = clampi(c + 1, 0, W - 1) - (col0 - 1);
    // the same for the Gaussian tile (one more cell of halo)
    const int gi0 = i0 + 1, gj0 = j0 + 1;
    const int gim = im + 1, gip = ip + 1, gjm = jm + 1, gjp = jp + 1;

    const bool interior = r > 0 && r < H - 1 && c > 0 && c < W - 1;

    for (int li = 0; li < P.NK; ++li) {
        const int pc = P.key_levels[li] - P.p_lo;
        const float* prv = sr + (pc - 1) * (kRH * kRW);
        const float* cur = sr + pc * (kRH * kRW);
        const float* nxt = sr + (pc + 1) * (kRH * kRW);
        const float* gk = sg + pc * (kGH * kGW);   // key level's Gaussian

        const float v = cur[i0 * kRW + j0];
        const float left = cur[i0 * kRW + jm], right = cur[i0 * kRW + jp];
        const float up = cur[im * kRW + j0], down = cur[ip * kRW + j0];
        const float tl = cur[im * kRW + jm], tr = cur[im * kRW + jp];
        const float bl = cur[ip * kRW + jm], br = cur[ip * kRW + jp];

        // the 24 neighbours compared with >= / <= (left/right are strict)
        float rest_max = fmaxf(fmaxf(fmaxf(up, down), fmaxf(tl, tr)),
                               fmaxf(bl, br));
        float rest_min = fminf(fminf(fminf(up, down), fminf(tl, tr)),
                               fminf(bl, br));
        const int rows3[3] = {im, i0, ip};
        const int cols3[3] = {jm, j0, jp};
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
            for (int q = 0; q < 3; ++q) {
                const float x0 = prv[rows3[a] * kRW + cols3[q]];
                const float x1 = nxt[rows3[a] * kRW + cols3[q]];
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

        const float gc = gk[gi0 * kGW + gj0];
        float thr = P.threshold, thr0 = P.thr0;
        if (P.darkness) {
            thr = P.threshold * fminf(2.0f * gc + 0.1f, 1.0f);
            thr0 = P.subpixel ? 0.8f * thr : thr;
        }
        bool extremum = (fabsf(v) > thr0) && (is_max || is_min);

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
        extremum = extremum && (det2 > 0.0f) && (tr2 <= P.te * det2);

        float dx = 0.0f, dy = 0.0f, ds = 0.0f, response = v;
        if (P.subpixel) {
            const float cn = nxt[i0 * kRW + j0];
            const float cp = prv[i0 * kRW + j0];
            const float fs = 0.5f * (cn - cp);
            const float fss = cn + cp - vx2;
            const float fxs = 0.25f * (nxt[i0 * kRW + jp] + prv[i0 * kRW + jm]
                                       - nxt[i0 * kRW + jm] - prv[i0 * kRW + jp]);
            const float fys = 0.25f * (nxt[ip * kRW + j0] + prv[im * kRW + j0]
                                       - nxt[im * kRW + j0] - prv[ip * kRW + j0]);
            // symmetric 3x3 adjugate solve of
            // [fxx fxy fxs; fxy fyy fys; fxs fys fss] x = -[fx fy fs]
            const float a = fxx, bb = fxy, cc = fxs, r0 = -fx;
            const float d = fyy, e = fys, r1 = -fy;
            const float f = fss, r2 = -fs;
            const float C00 = d * f - e * e;
            const float C01 = cc * e - bb * f;
            const float C02 = bb * e - cc * d;
            const float det = a * C00 + bb * C01 + cc * C02;
            const bool ok = fabsf(det) >= 1e-30f;
            const float rdet = 1.0f / (ok ? det : 1.0f);
            const float s0 = r0 * rdet, s1 = r1 * rdet, s2 = r2 * rdet;
            const float sx = C00 * s0 + C01 * s1 + C02 * s2;
            const float C11 = a * f - cc * cc;
            const float C12 = bb * cc - a * e;
            const float sy = C01 * s0 + C11 * s1 + C12 * s2;
            const float C22 = a * d - bb * bb;
            const float ss = C02 * s0 + C12 * s1 + C22 * s2;
            dx = ok ? sx : 0.0f;
            dy = ok ? sy : 0.0f;
            ds = ok ? ss : 0.0f;
            const float refined = v + 0.5f * (dx * fx + dy * fy + ds * fs);
            response = ok ? refined : v;
            const bool passed = (fabsf(response) > thr) && (fabsf(ds) < 1.0f)
                && (fabsf(dx) < 1.0f) && (fabsf(dy) < 1.0f);
            // a degenerate system accepts the unrefined keypoint
            extremum = extremum && (!ok || passed);
        }

        const bool valid = extremum && interior;

        int ftype;
        if (P.is_hessian) {
            const float g_lxx = gk[gi0 * kGW + gjm] - 2.0f * gc
                + gk[gi0 * kGW + gjp];
            ftype = g_lxx > 0.0f ? TYPE_DARK_BLOB : TYPE_BRIGHT_BLOB;
            if (response < 0.0f) ftype = TYPE_SADDLE;
        } else {
            ftype = is_max ? TYPE_BRIGHT_BLOB : TYPE_DARK_BLOB;
        }
        if (!valid) ftype = TYPE_NONE;

        // the reference keeps the response as fp16 in the key map
        const float resp16 = __half2float(__float2half_rn(response));

        const float dxg = gk[gi0 * kGW + gjp] - gk[gi0 * kGW + gjm];
        const float dyg = gk[gip * kGW + gj0] - gk[gim * kGW + gj0];
        const float mag = 0.5f * sqrtf(dxg * dxg + dyg * dyg);
        const float rot = (mag == 0.0f) ? 0.0f : atan2f(dyg, dxg);

        const long long o = (((long long)b * P.NK + li) * H + r) * W + c;
        o_valid[o] = valid ? 1 : 0;
        o_resp[o] = valid ? resp16 : 0.0f;
        o_dx[o] = dx;
        o_dy[o] = dy;
        o_ds[o] = ds;
        o_type[o] = ftype;
        o_grad[o] = mag;
        o_rot[o] = rot;
    }
}

}  // namespace

extern "C" {

// gauss (B, L, H, W) f32 contiguous -> eight (B, NK, H, W) maps (valid as
// bytes 0/1, ftype i32, the rest f32). key_levels: NK ascending host ints;
// norms: L host floats (per Gaussian level; unused for DoG).
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

    const size_t smem =
        sizeof(float) * (size_t)(P.NP * kGH * kGW + P.NR * kRH * kRW);
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
