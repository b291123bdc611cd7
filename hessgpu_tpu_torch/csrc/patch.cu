// Per-keypoint orientation and descriptor kernels for Hopper (sm_90a). Plain
// C interface, loaded with ctypes (hessgpu_tpu_torch/ops/cuda/patch.py).
//
// Replace orientation_pallas and descriptor_pallas
// (hessgpu_tpu/ops/pallas/patch.py). Both walk, for every valid slot of a
// (B, G) keypoint table, the pixels of that keypoint's own support in the
// gradient magnitude / angle maps of its level, which they read in place:
// a table of one pointer per level addresses the (B, NK, h, w) tensors the
// detect kernel wrote. No padded canvas, no window copy, no per-table window
// size: the loop is sized per keypoint from its own sigma (and theta), and a
// pixel counts by the same tests in absolute level coordinates as in the
// plain PyTorch versions (ops/orientation.py, ops/descriptor.py), so the set
// of contributing pixels is the same. Slots that are not valid get zeros.
//
// What bounds them on this card: by the roofline, bytes (a keypoint's support
// is 10^2..10^4 pixels of two maps, a few MB for a whole batch, microseconds
// at 3.35 TB/s, against some 25 (orientation) or 75 (descriptor) float
// operations per pixel, plus the descriptor's 25 MB of output); in practice
// instruction issue and the latency of a warp's serial walk over its
// keypoint, far above either bound.
//
//  * orientation: one warp per slot. Lane l takes the pixels l, l+32, ... of
//    the support's bounding box in raster order and adds their votes into
//    its own column of a 36 x 32 shared histogram, so no two lanes ever add
//    to one address; the 32 columns of a bin are then summed in lane order.
//    Lane 0 runs the smoothing and the peak picking, which are branchy and
//    tiny.
//  * descriptor: a pixel of the support touches at most 2 x 2 cells x 2 bins
//    of the 16 x 8 table, so the design spends instructions only where a
//    pixel has entries. A block of 4 warps serves one slot. The support's
//    bounding box is cut, in raster order, into rounds of 32 pixels; warp w
//    takes the rounds w, w + 4, ... and alternates two steps. Staging: each
//    lane computes its pixel once (membership, Gaussian weight, cell
//    coordinates, the two bin shares; the two map values are requested a
//    round ahead) and the contributing ones are appended, in order, to the
//    warp's ring in shared memory. Accumulation: 8 staged pixels at a time,
//    lane = (pixel q of the 8, corner (dy, dx) of its 2 x 2 cells): every
//    lane has an entry to add, into bins ob and ob + 1 of its cell in table
//    q of the warp's 8 private tables, so no two lanes of a step write one
//    address. The 4 x 8 tables are summed in order at the end. A pixel's
//    warp and table follow from its place in the bounding box alone: one
//    fixed order per entry. Warps meet at a block barrier only once per
//    slot, so they are at different stages and hide each other's latency.
//    Slots are walked by a fixed grid (8 blocks per SM) in table-column
//    order (slot g of every batch item, then slot g + 1), which spreads the
//    valid slots - packed at the front of each item's row - evenly over the
//    blocks; a slot that is not valid costs its block one 512-byte store of
//    zeros, its flag having been fetched with 127 others.
//
// No floating-point atomics anywhere: two runs give the same bits. The
// expressions follow the plain versions operation by operation and the file
// is compiled with -fmad=false; what differs from them is the order of the
// sums over pixels only. expf, sinf, cosf are the full-precision functions.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 64;

struct LevelTable {
    const float* grad[kMaxLevels];    // batch item 0's plane of each level
    const float* rot[kMaxLevels];
    long long bstride[kMaxLevels];    // elements from one batch item to the next
    int h[kMaxLevels];
    int w[kMaxLevels];
    int NL;
};

// ---------------------------------------------------------------------------
// orientation
// ---------------------------------------------------------------------------

constexpr int kOriWarps = 4;
constexpr int kBins = 36;
constexpr int kCol = 33;   // 32 lane columns per bin + 1 against bank conflicts

struct OriParams {
    int n, G;
    float gaussian_factor;   // 1.5
    float window;            // gaussian_factor * window_factor
    float bins_per_radian;   // 36 / 2pi
    float peak_threshold;    // 0.8
    float theta_quantum;     // 2pi / 255
    int half_sift, single, max_peaks;
};

__global__ void __launch_bounds__(kOriWarps * 32)
orientation_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                   const float* __restrict__ sigmas,
                   const unsigned char* __restrict__ valids,
                   const int* __restrict__ level_ids,
                   float* __restrict__ o_theta, unsigned char* __restrict__ o_valid,
                   float* __restrict__ o_votes,
                   const __grid_constant__ LevelTable T, OriParams P) {
    __shared__ float hist[kOriWarps][kBins * kCol];
    __shared__ float vbuf[kOriWarps][2][kBins];

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int slot = blockIdx.x * kOriWarps + warp;
    if (slot >= P.n) return;
    const int lid = level_ids[slot];
    if (!valids[slot] || lid < 0 || lid >= T.NL) {
        if (lane < 4) {
            o_theta[(long long)slot * 4 + lane] = 0.0f;
            o_valid[(long long)slot * 4 + lane] = 0;
        }
        if (o_votes)
            for (int i = lane; i < kBins; i += 32)
                o_votes[(long long)slot * kBins + i] = 0.0f;
        return;
    }

    const float kx = xs[slot], ky = ys[slot], sg = sigmas[slot];
    const int H = T.h[lid], W = T.w[lid];
    const long long plane = (long long)(slot / P.G) * T.bstride[lid];
    const float* __restrict__ g = T.grad[lid] + plane;
    const float* __restrict__ r = T.rot[lid] + plane;

    const float gsigma = sg * P.gaussian_factor;
    const float win = fabsf(sg) * P.window;
    const float dist_threshold = win * win + 0.5f;
    const float factor = -0.5f / (gsigma * gsigma);

    // integer pixels floor(k - win)..floor(k + win), clamped to [1, dim - 2]
    const int ix0 = (int)fmaxf(1.0f, floorf(kx - win));
    const int ix1 = (int)fminf((float)W - 2.0f, floorf(kx + win));
    const int iy0 = (int)fmaxf(1.0f, floorf(ky - win));
    const int iy1 = (int)fminf((float)H - 2.0f, floorf(ky + win));
    const int nx = ix1 - ix0 + 1, ny = iy1 - iy0 + 1;
    const int npx = (nx > 0 && ny > 0) ? nx * ny : 0;

    float* hw = hist[warp];
    for (int b = 0; b < kBins; ++b) hw[b * kCol + lane] = 0.0f;
    for (int p = lane; p < npx; p += 32) {
        const int row = p / nx;
        const int iy = iy0 + row, ix = ix0 + (p - row * nx);
        const float dx = ((float)ix + 0.5f) - kx;   // pixel centres
        const float dy = ((float)iy + 0.5f) - ky;
        const float sq = dx * dx + dy * dy;
        if (sq < dist_threshold) {
            const long long o = (long long)iy * W + ix;
            int ob = (int)floorf(r[o] * P.bins_per_radian);
            if (ob < 0) ob += kBins;
            ob = min(max(ob, 0), kBins - 1);
            hw[ob * kCol + lane] += g[o] * expf(sq * factor);
        }
    }
    __syncwarp();
    float* v = vbuf[warp][0];
    float* t = vbuf[warp][1];
    for (int b = lane; b < kBins; b += 32) {
        float s = 0.0f;
        for (int l = 0; l < 32; ++l) s += hw[b * kCol + l];
        v[b] = s;
    }
    __syncwarp();
    if (lane != 0) return;

    // 6 rounds of circular [1/3 1/3 1/3] smoothing, ((pre + cur) + nxt) / 3
    for (int round = 0; round < 6; ++round) {
        for (int i = 0; i < kBins; ++i)
            t[i] = ((v[(i + kBins - 1) % kBins] + v[i]) + v[(i + 1) % kBins])
                   / 3.0f;
        float* swap = v; v = t; t = swap;
    }
    if (P.half_sift)
        for (int i = 0; i < kBins / 2; ++i) {
            v[i] = v[i] + v[i + kBins / 2];
            v[i + kBins / 2] = 0.0f;
        }
    if (o_votes)
        for (int i = 0; i < kBins; ++i)
            o_votes[(long long)slot * kBins + i] = v[i];

    float th[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    unsigned char ov[4] = {0, 0, 0, 0};
    float vmax = v[0];
    int imax = 0;
    for (int i = 1; i < kBins; ++i)
        if (v[i] > vmax) { vmax = v[i]; imax = i; }   // first maximum
    if (P.single) {
        const float pre = v[(imax + kBins - 1) % kBins];
        const float nxt = v[(imax + 1) % kBins];
        const float off = 0.5f * (nxt - pre) / (vmax + vmax - nxt - pre);
        th[0] = ((float)imax + 0.5f + off) / P.bins_per_radian;
        ov[0] = 1;
    } else {
        // strict local maxima above threshold * max, by vote descending;
        // among equal votes the lowest bin first
        const float thr = P.peak_threshold * vmax;
        unsigned long long taken = 0ull;
        const int npk = min(4, P.max_peaks);
        for (int s = 0; s < npk; ++s) {
            float best = -1.0f;
            int bi = -1;
            for (int i = 0; i < kBins; ++i) {
                const float vi = v[i];
                if (!((taken >> i) & 1ull) && vi > thr
                        && vi > v[(i + kBins - 1) % kBins]
                        && vi > v[(i + 1) % kBins] && vi > best) {
                    best = vi;
                    bi = i;
                }
            }
            if (bi < 0) break;
            taken |= 1ull << bi;
            const float pre = v[(bi + kBins - 1) % kBins];
            const float nxt = v[(bi + 1) % kBins];
            const float di = 0.5f * (nxt - pre) / (best + best - nxt - pre);
            const float rotb = (float)bi + di + 0.5f;   // in bins
            float frac = rotb / 36.0f;
            if (frac < 0.0f) frac = frac + 1.0f;
            th[s] = floorf(frac * 255.0f) * P.theta_quantum;
            ov[s] = 1;
        }
    }
    for (int s = 0; s < 4; ++s) {
        o_theta[(long long)slot * 4 + s] = th[s];
        o_valid[(long long)slot * 4 + s] = ov[s];
    }
}

// ---------------------------------------------------------------------------
// descriptor
// ---------------------------------------------------------------------------

constexpr int kDescWarps = 4;     // warps that share one slot's pixels
constexpr int kGroup = 8;         // staged pixels accumulated per step
constexpr int kRing = 64;         // staged pixels a warp can hold
constexpr int kRowPitch = 34;     // floats per cell row: 4 cells x 8 bins + 2
constexpr int kTabPitch = 140;    // floats per private table: 4 rows + 4
constexpr int kDescBlocksPerSM = 8;

struct DescParams {
    int n, G;
    float window_factor;   // 3.0
    float pi, two_pi;      // as float32
    float four_over_pi;
};

__global__ void __launch_bounds__(kDescWarps * 32, kDescBlocksPerSM)
descriptor_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                  const float* __restrict__ sigmas,
                  const float* __restrict__ thetas,
                  const unsigned char* __restrict__ valids,
                  const int* __restrict__ level_ids, float* __restrict__ out,
                  const __grid_constant__ LevelTable T, DescParams P) {
    // per warp: 8 private 16 x 8 tables (padded against bank conflicts) and
    // the ring of staged pixels: (cu, cv, share of bin ob, share of bin
    // ob + 1) and (floor cu, floor cv, table offsets of the two bins in cell
    // (floor cv, floor cu))
    __shared__ __align__(16) float s_tab[kDescWarps][kGroup * kTabPitch];
    __shared__ float4 s_pix[kDescWarps][kRing];
    __shared__ float4 s_idx[kDescWarps][kRing];
    __shared__ int s_lid[kDescWarps * 32];

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* tab = s_tab[warp];
    float4* pix = s_pix[warp];
    float4* idx = s_idx[warp];
    const unsigned full = 0xffffffffu;
    const unsigned below = (1u << lane) - 1u;

    // accumulation role: pixel q of a group, corner (dy, dx) of its cells
    const int q = lane >> 2, dy = (lane >> 1) & 1, dx = lane & 1;
    const float dyf = (float)dy, dxf = (float)dx;
    float* mine = tab + q * kTabPitch + dy * kRowPitch + dx * 8;
    // reduction role: entry threadIdx.x = cell * 8 + bin of the 16 x 8 table
    const int rcell = threadIdx.x >> 3;
    const int roff = (rcell >> 2) * kRowPitch + (rcell & 3) * 8
        + (threadIdx.x & 7);

    auto accumulate = [&](int slot_in_ring) {
        const float4 a = pix[slot_in_ring];
        const float4 b = idx[slot_in_ring];
        const float cxf = b.x + dxf, cyf = b.y + dyf;
        if (cxf >= 0.0f && cxf <= 3.0f && cyf >= 0.0f && cyf <= 3.0f) {
            const float ay = fmaxf(0.0f, 1.0f - fabsf(a.y - cyf));
            const float ax = fmaxf(0.0f, 1.0f - fabsf(a.x - cxf));
            const float w = ay * ax;
            float* e1 = mine + __float_as_int(b.z);
            float* e2 = mine + __float_as_int(b.w);
            *e1 = *e1 + w * a.z;
            *e2 = *e2 + w * a.w;
        }
    };

    // The block's slots are j = blockIdx.x, + gridDim.x, ... in table-column
    // order. Their level ids (-1: not valid) are fetched 128 at a time, one
    // per thread, so that walking the many slots that are not valid costs
    // stores only and no chain of dependent loads.
    constexpr int kAhead = kDescWarps * 32;
    const int B = P.n / P.G;
    const int per_block = (P.n - blockIdx.x + gridDim.x - 1) / gridDim.x;
    auto slot_of = [&](int k) {
        const int j = blockIdx.x + k * gridDim.x, g = j / B;
        return (j - g * B) * P.G + g;
    };
    for (int k = 0; k < per_block; ++k) {
        if (k % kAhead == 0) {
            __syncthreads();
            int lid = -1;
            if (k + threadIdx.x < per_block) {
                const int slot = slot_of(k + threadIdx.x);
                lid = level_ids[slot];
                if (!valids[slot] || lid >= T.NL) lid = -1;
            }
            s_lid[threadIdx.x] = lid;
            __syncthreads();
        }
        const int slot = slot_of(k);
        float* dst = out + (long long)slot * 128;
        const int lid = s_lid[k % kAhead];
        if (lid < 0) {   // the whole block
            dst[threadIdx.x] = 0.0f;
            continue;
        }
        for (int i = lane; i < kGroup * kTabPitch / 4; i += 32)
            reinterpret_cast<float4*>(tab)[i] =
                make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        __syncwarp();

        const float kx = xs[slot], ky = ys[slot], th = thetas[slot];
        const int H = T.h[lid], W = T.w[lid];
        const long long plane = (long long)(slot / P.G) * T.bstride[lid];
        const float* __restrict__ gm = T.grad[lid] + plane;
        const float* __restrict__ rm = T.rot[lid] + plane;

        const float spt = fabsf(sigmas[slot] * P.window_factor);
        const float c = cosf(th), s = sinf(th);
        const float crspt = c / spt, srspt = s / spt;
        const float anglef = th > P.pi ? th - P.two_pi : th;

        // The support is |u|, |v| < 2.5 cells in the rotated frame, so a
        // pixel centre lies within 2.5 * spt * (|cos| + |sin|) of the
        // keypoint on each axis; two pixels of margin cover the rounding.
        // Interior pixels only.
        const float R = 2.5f * spt * (fabsf(c) + fabsf(s)) + 2.0f;
        const int ix0 = (int)fmaxf(1.0f, floorf(kx - R));
        const int ix1 = (int)fminf((float)W - 2.0f, ceilf(kx + R));
        const int iy0 = (int)fmaxf(1.0f, floorf(ky - R));
        const int iy1 = (int)fminf((float)H - 2.0f, ceilf(ky + R));
        const int nx = ix1 - ix0 + 1, ny = iy1 - iy0 + 1;
        const int npx = (nx > 0 && ny > 0) ? nx * ny : 0;

        // Round t of the bounding box is its pixels 32 t .. 32 t + 31 in
        // raster order; warp w takes the rounds t = w, w + 4, ... A round's
        // two map values are requested one round ahead, so their latency is
        // spent under the accumulation of the round before.
        int head = 0, count = 0;      // ring: [head, head + count), 8 | head
        int col = warp * 32 + lane, row = 0;
        float u = 0.0f, v = 0.0f, rot = 0.0f, grad = 0.0f;
        bool member = false;
        auto locate = [&]() {         // this lane's pixel of the next round
            while (col >= nx) { col -= nx; ++row; }
            member = false;
            if (row < ny) {
                const int iy = iy0 + row, ix = ix0 + col;
                const float dxp = ((float)ix + 0.5f) - kx;
                const float dyp = ((float)iy + 0.5f) - ky;
                // cell-frame coordinates: u along descriptor x, v along y
                u = crspt * dxp + srspt * dyp;
                v = crspt * dyp - srspt * dxp;
                const float cu = u + 1.5f, cv = v + 1.5f;
                member = cu > -1.0f && cu < 4.0f && cv > -1.0f && cv < 4.0f;
                if (member) {
                    rot = rm[iy * W + ix];
                    grad = gm[iy * W + ix];
                }
            }
            col += kDescWarps * 32;
        };
        if (npx > 0) locate();
        for (int t0 = warp * 32; t0 < npx; t0 += kDescWarps * 32) {
            const bool m_now = member;
            const float u_now = u, v_now = v, rot_now = rot, grad_now = grad;
            if (t0 + kDescWarps * 32 < npx) locate();
            float4 a, b;
            if (m_now) {
                const float cu = u_now + 1.5f, cv = v_now + 1.5f;
                const float gauss_w =
                    expf(-0.125f * (u_now * u_now + v_now * v_now));
                float tp = (anglef - rot_now) * P.four_over_pi;
                if (tp < 0.0f) tp = tp + 8.0f;
                const float fo = floorf(tp);
                const int ob = min(max((int)fo, 0), 7);   // fp edge at 8.0
                const float w2 = tp - fo;                 // bin ob + 1
                const float w1 = 1.0f - w2;
                const float wgt = gauss_w * grad_now;
                const float fcu = floorf(cu), fcv = floorf(cv);
                const int cell = (int)fcv * kRowPitch + (int)fcu * 8;
                a = make_float4(cu, cv, w1 * wgt, w2 * wgt);
                b = make_float4(fcu, fcv, __int_as_float(cell + ob),
                                __int_as_float(cell + ((ob + 1) & 7)));
            }
            const unsigned m = __ballot_sync(full, m_now);
            if (m_now) {
                const int at = (head + count + __popc(m & below)) & (kRing - 1);
                pix[at] = a;
                idx[at] = b;
            }
            count += __popc(m);
            __syncwarp();
            while (count >= kGroup) {
                accumulate(head + q);
                head = (head + kGroup) & (kRing - 1);
                count -= kGroup;
                __syncwarp();
            }
        }
        if (count > 0 && q < count) accumulate(head + q);

        // entry e of the table: the 4 warps' 8 tables each, in order
        __syncthreads();
        float sum = s_tab[0][roff];
#pragma unroll
        for (int t = 1; t < kDescWarps * kGroup; ++t)
            sum = sum + s_tab[t / kGroup][(t % kGroup) * kTabPitch + roff];
        dst[threadIdx.x] = sum;
        __syncthreads();   // the tables are zeroed again for the next slot
    }
}

bool fill_levels(LevelTable& T, const long long* grad_ptrs,
                 const long long* rot_ptrs, const long long* bstride,
                 const int* lh, const int* lw, int NL) {
    if (NL < 1 || NL > kMaxLevels) return false;
    T.NL = NL;
    for (int i = 0; i < NL; ++i) {
        if (lh[i] < 1 || lw[i] < 1) return false;
        T.grad[i] = reinterpret_cast<const float*>(grad_ptrs[i]);
        T.rot[i] = reinterpret_cast<const float*>(rot_ptrs[i]);
        T.bstride[i] = bstride[i];
        T.h[i] = lh[i];
        T.w[i] = lw[i];
    }
    return true;
}

}  // namespace

extern "C" {

// Tables: n = B * G slots, slot i of batch item i / G. valid: bytes 0/1.
// Levels: NL host entries each - device addresses of batch item 0's grad and
// rot plane, elements to the next batch item, height, width.
// thetas (n, 4) f32, ovalid (n, 4) bytes, votes (n, 36) f32 or null.
int hg_orientation(const float* x, const float* y, const float* sigma,
                   const unsigned char* valid, const int* level_id,
                   float* thetas, unsigned char* ovalid, float* votes,
                   int n, int G, const long long* grad_ptrs,
                   const long long* rot_ptrs, const long long* bstride,
                   const int* lh, const int* lw, int NL,
                   float gaussian_factor, float window, float bins_per_radian,
                   float peak_threshold, float theta_quantum, int half_sift,
                   int single, int max_peaks, void* stream) {
    LevelTable T;
    if (n < 1 || G < 1 || !fill_levels(T, grad_ptrs, rot_ptrs, bstride, lh,
                                       lw, NL))
        return (int)cudaErrorInvalidValue;
    OriParams P;
    P.n = n; P.G = G;
    P.gaussian_factor = gaussian_factor; P.window = window;
    P.bins_per_radian = bins_per_radian; P.peak_threshold = peak_threshold;
    P.theta_quantum = theta_quantum;
    P.half_sift = half_sift; P.single = single; P.max_peaks = max_peaks;
    const int blocks = (n + kOriWarps - 1) / kOriWarps;
    orientation_kernel<<<blocks, kOriWarps * 32, 0, (cudaStream_t)stream>>>(
        x, y, sigma, valid, level_id, thetas, ovalid, votes, T, P);
    return (int)cudaGetLastError();
}

// out (n, 16, 8) f32: raw, unnormalized [cell cy * 4 + cx, bin].
int hg_descriptor(const float* x, const float* y, const float* sigma,
                  const float* theta, const unsigned char* valid,
                  const int* level_id, float* out, int n, int G,
                  const long long* grad_ptrs, const long long* rot_ptrs,
                  const long long* bstride, const int* lh, const int* lw,
                  int NL, float window_factor, float pi, float two_pi,
                  float four_over_pi, void* stream) {
    LevelTable T;
    if (n < 1 || G < 1 || n % G != 0
            || !fill_levels(T, grad_ptrs, rot_ptrs, bstride, lh, lw, NL))
        return (int)cudaErrorInvalidValue;
    DescParams P;
    P.n = n; P.G = G;
    P.window_factor = window_factor; P.pi = pi; P.two_pi = two_pi;
    P.four_over_pi = four_over_pi;
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    // a fixed grid that fills the card once; its blocks stride over the slots
    int blocks = sms * kDescBlocksPerSM;
    if (blocks > n) blocks = n;
    descriptor_kernel<<<blocks, kDescWarps * 32, 0, (cudaStream_t)stream>>>(
        x, y, sigma, theta, valid, level_id, out, T, P);
    return (int)cudaGetLastError();
}

}  // extern "C"
