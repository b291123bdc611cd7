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
// A level's buffer may also be a band of rows of a taller level (the
// row-sharded path): the table gives each level its global height and the
// global row of its buffer's row 0, and keypoints, tests and the clamp stay
// in global rows.
//
// What bounds them on this card: by the roofline, bytes (a keypoint's support
// is 10^2..10^4 pixels of two maps, a few MB for a whole batch, microseconds
// at 3.35 TB/s, against some 25 (orientation) or 75 (descriptor) float
// operations per pixel, plus the descriptor's 25 MB of output); in practice
// instruction issue and the latency of a warp's serial walk over its
// keypoint, far above either bound.
//
//  * orientation: one warp per valid slot, the warps of a fixed grid (8 blocks
//    of 4 warps per SM) striding over the slots in table-column order, so the
//    valid slots - packed at the front of each item's row - go one to a warp
//    across the card. A warp fetches the flags and levels of 32 of its slots
//    at once, and each lane writes the zeros of its own slot if that is not
//    valid (one store per output field). On a valid slot, lane l takes the
//    pixels l, l + 32, ... of the support's bounding box in raster order, its
//    (row, col) stepped without a division; the map values of 4 rounds are
//    requested together (the walk waits on the memory's latency, not on the
//    instruction rate), then each vote is added into the lane's own column of
//    a 36 x 32 shared histogram (bank l whatever the bin; no two lanes add to
//    one address). Lanes 0..17 then hold two adjacent bins each: the merge
//    sums each bin's 32 columns as two chains of 16 in a fixed rotated order
//    (the 18 lanes read 18 banks), the six smoothing rounds and the half-SIFT
//    fold are two shuffles a round, and the peaks are picked by warp argmax
//    over (vote, bin), ties to the lower bin. Thetas go out as one float4 and
//    the four valid bytes as one word.
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

// A level's buffer may be a band of rows of a taller level (the row-sharded
// path): h is the level's global height, which the [1, h - 2] clamp uses,
// and global row iy of batch item b lies at buffer row
// iy - (row0 + b * row_step). On the main path row0 = row_step = 0 and the
// buffer is the whole level.
struct LevelTable {
    const float* grad[kMaxLevels];    // batch item 0's plane of each level
    const float* rot[kMaxLevels];
    long long bstride[kMaxLevels];    // elements from one batch item to the next
    int h[kMaxLevels];
    int w[kMaxLevels];
    int row0[kMaxLevels];             // global row of buffer row 0, item 0
    int row_step[kMaxLevels];         // its step from one batch item to the next
    int NL;
};

// ---------------------------------------------------------------------------
// orientation
// ---------------------------------------------------------------------------

constexpr int kOriWarps = 4;          // warps of a block, each on its own slots
constexpr int kOriBlocksPerSM = 8;
constexpr int kOriAhead = 4;          // rounds whose map values are in flight
constexpr int kBins = 36;
constexpr int kPairs = kBins / 2;     // lane l < 18 holds bins 2l and 2l + 1

struct OriParams {
    int n, G;
    float gaussian_factor;   // 1.5
    float window;            // gaussian_factor * window_factor
    float bins_per_radian;   // 36 / 2pi
    float peak_threshold;    // 0.8
    float theta_quantum;     // 2pi / 255
    int half_sift, single, max_peaks;
};

// (v, b) becomes the warp's largest vote and its bin, ties to the lowest
// bin; every lane ends with the same pair.
__device__ __forceinline__ void warp_best(float& v, int& b) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int ob = __shfl_xor_sync(0xffffffffu, b, off);
        if (ov > v || (ov == v && ob < b)) { v = ov; b = ob; }
    }
}

__global__ void __launch_bounds__(kOriWarps * 32, kOriBlocksPerSM)
orientation_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                   const float* __restrict__ sigmas,
                   const unsigned char* __restrict__ valids,
                   const int* __restrict__ level_ids,
                   float* __restrict__ o_theta, unsigned char* __restrict__ o_valid,
                   float* __restrict__ o_votes,
                   const __grid_constant__ LevelTable T, OriParams P) {
    // per warp: the 36 x 32 histogram, bin b of lane l's column at b * 32 + l
    // (a lane's adds hit bank l whatever the bin), and the smoothed votes
    __shared__ __align__(16) float s_hist[kOriWarps][kBins * 32];
    __shared__ __align__(16) float s_votes[kOriWarps][kBins];

    const unsigned full = 0xffffffffu;
    const float neg_inf = __int_as_float(0xff800000);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* hist = s_hist[warp];
    float* sv = s_votes[warp];
    const int prv = (lane + kPairs - 1) % kPairs;   // pair neighbours
    const int nxl = (lane + 1) % kPairs;

    // The warp's slots are j = gw, gw + TW, ... in table-column order (slot
    // g of every batch item, then g + 1), so the valid slots, packed at the
    // front of each item's row, go one to a warp over the whole grid.
    const int B = P.n / P.G;
    const int TW = gridDim.x * kOriWarps;
    const int gw = warp * gridDim.x + blockIdx.x;
    const int per_warp = gw < P.n ? (P.n - gw + TW - 1) / TW : 0;
    auto slot_of = [&](int k) {
        const int j = gw + k * TW, g = j / B;
        return (j - g * B) * P.G + g;
    };
    for (int k0 = 0; k0 < per_warp; k0 += 32) {
        // lane i fetches the flag and level of the warp's slot k0 + i, and
        // writes the zeros of that slot if it is not valid
        bool live = false;
        int lid = -1;
        if (k0 + lane < per_warp) {
            const int slot = slot_of(k0 + lane);
            lid = level_ids[slot];
            live = valids[slot] && lid >= 0 && lid < T.NL;
            if (!live) {
                const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                reinterpret_cast<float4*>(o_theta)[slot] = zero;
                reinterpret_cast<unsigned*>(o_valid)[slot] = 0u;
                if (o_votes) {
                    float4* d = reinterpret_cast<float4*>(
                        o_votes + (long long)slot * kBins);
#pragma unroll
                    for (int i = 0; i < kBins / 4; ++i) d[i] = zero;
                }
            }
        }
        unsigned todo = __ballot_sync(full, live);
        while (todo) {
            const int i = __ffs(todo) - 1;
            todo &= todo - 1;
            const int slot = slot_of(k0 + i);
            const int level = __shfl_sync(full, lid, i);

            const float kx = xs[slot], ky = ys[slot], sg = sigmas[slot];
            const int H = T.h[level], W = T.w[level];
            const int item = slot / P.G;
            const long long plane = (long long)item * T.bstride[level];
            const int row0 = T.row0[level] + item * T.row_step[level];

            const float gsigma = sg * P.gaussian_factor;
            const float win = fabsf(sg) * P.window;
            const float dist_threshold = win * win + 0.5f;
            const float factor = -0.5f / (gsigma * gsigma);

            // integer pixels floor(k - win)..floor(k + win), clamped to
            // [1, dim - 2]
            const int ix0 = (int)fmaxf(1.0f, floorf(kx - win));
            const int ix1 = (int)fminf((float)W - 2.0f, floorf(kx + win));
            const int iy0 = (int)fmaxf(1.0f, floorf(ky - win));
            const int iy1 = (int)fminf((float)H - 2.0f, floorf(ky + win));
            const int nx = ix1 - ix0 + 1, ny = iy1 - iy0 + 1;
            const int npx = (nx > 0 && ny > 0) ? nx * ny : 0;
            // the maps from the box's first row on: global row iy0 lies at
            // buffer row iy0 - row0, and box row `row` at g[row * W]
            const long long first = plane + (long long)(iy0 - row0) * W;
            const float* __restrict__ g = T.grad[level] + first;
            const float* __restrict__ r = T.rot[level] + first;

            __syncwarp();   // the last slot's reads of hist and sv are done
#pragma unroll
            for (int e = 0; e < kBins / 4; ++e)   // 36 x 32 floats
                reinterpret_cast<float4*>(hist)[e * 32 + lane] =
                    make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            __syncwarp();

            // Round t is the box's pixels 32 t .. 32 t + 31 in raster order,
            // lane l the pixel 32 t + l: its (row, col) steps by 32 with one
            // wrap, no division per pixel. The map values of kOriAhead rounds
            // are requested together, then their votes added in round order.
            if (npx > 0) {
                const int drow = 32 / nx, dcol = 32 - drow * nx;
                int row = lane / nx, col = lane - row * nx;
                for (int p0 = 0; p0 < npx; p0 += 32 * kOriAhead) {
                    bool in[kOriAhead];
                    float sq[kOriAhead], gv[kOriAhead], rv[kOriAhead];
#pragma unroll
                    for (int u = 0; u < kOriAhead; ++u) {
                        in[u] = false;
                        sq[u] = gv[u] = rv[u] = 0.0f;
                        if (row < ny) {
                            const int iy = iy0 + row, ix = ix0 + col;
                            // pixel centres
                            const float dx = ((float)ix + 0.5f) - kx;
                            const float dy = ((float)iy + 0.5f) - ky;
                            sq[u] = dx * dx + dy * dy;
                            in[u] = sq[u] < dist_threshold;
                            if (in[u]) {
                                const int o = row * W + ix;
                                gv[u] = g[o];
                                rv[u] = r[o];
                            }
                        }
                        row += drow;
                        col += dcol;
                        if (col >= nx) { col -= nx; ++row; }
                    }
#pragma unroll
                    for (int u = 0; u < kOriAhead; ++u)
                        if (in[u]) {
                            int ob = (int)floorf(rv[u] * P.bins_per_radian);
                            if (ob < 0) ob += kBins;
                            ob = min(max(ob, 0), kBins - 1);
                            hist[ob * 32 + lane] +=
                                gv[u] * expf(sq[u] * factor);
                        }
                }
            }
            __syncwarp();

            // Merge: lane l < 18 sums bins 2l and 2l + 1, each as two chains
            // of 16 columns (72 half-columns in all), columns l, l + 1, ...
            // and l + 16, l + 17, ... mod 32 in that order, so the 18 lanes
            // read 18 banks at every step; then the two halves.
            float lo = 0.0f, hi = 0.0f;
            if (lane < kPairs) {
                const float* h0 = hist + 2 * lane * 32;
                const float* h1 = h0 + 32;
                float lo_a = h0[lane], hi_a = h1[lane];
                float lo_b = h0[(lane + 16) & 31], hi_b = h1[(lane + 16) & 31];
#pragma unroll
                for (int s = 1; s < 16; ++s) {
                    const int ca = (lane + s) & 31, cb = (lane + 16 + s) & 31;
                    lo_a = lo_a + h0[ca];
                    hi_a = hi_a + h1[ca];
                    lo_b = lo_b + h0[cb];
                    hi_b = hi_b + h1[cb];
                }
                lo = lo_a + lo_b;
                hi = hi_a + hi_b;
            }

            // 6 rounds of circular [1/3 1/3 1/3] smoothing across the pairs,
            // ((pre + cur) + nxt) / 3 per bin, IEEE division
#pragma unroll
            for (int round = 0; round < 6; ++round) {
                const float pre = __shfl_sync(full, hi, prv);   // bin 2l - 1
                const float nxt = __shfl_sync(full, lo, nxl);   // bin 2l + 2
                const float nlo = ((pre + lo) + hi) / 3.0f;
                const float nhi = ((lo + hi) + nxt) / 3.0f;
                lo = nlo;
                hi = nhi;
            }
            if (P.half_sift) {   // bins 18..35 (lanes 9..17) onto 0..17
                const float flo = __shfl_down_sync(full, lo, kPairs / 2);
                const float fhi = __shfl_down_sync(full, hi, kPairs / 2);
                if (lane < kPairs / 2) {
                    lo = lo + flo;
                    hi = hi + fhi;
                } else {
                    lo = 0.0f;
                    hi = 0.0f;
                }
            }
            if (lane < kPairs) {
                reinterpret_cast<float2*>(sv)[lane] = make_float2(lo, hi);
                if (o_votes)
                    reinterpret_cast<float2*>(
                        o_votes + (long long)slot * kBins)[lane] =
                        make_float2(lo, hi);
            }
            __syncwarp();

            // the first maximum
            float vmax = lane < kPairs ? lo : neg_inf;
            int imax = 2 * lane;
            if (lane < kPairs && hi > lo) { vmax = hi; imax = 2 * lane + 1; }
            warp_best(vmax, imax);
            float4 th = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            unsigned ov = 0u;
            if (P.single) {
                const float pre = sv[(imax + kBins - 1) % kBins];
                const float nxt = sv[(imax + 1) % kBins];
                const float off =
                    0.5f * (nxt - pre) / (vmax + vmax - nxt - pre);
                th.x = ((float)imax + 0.5f + off) / P.bins_per_radian;
                ov = 1u;
            } else {
                // strict local maxima above threshold * max, by vote
                // descending; among equal votes the lowest bin first
                const float thr = P.peak_threshold * vmax;
                const float pre = __shfl_sync(full, hi, prv);
                const float nxt = __shfl_sync(full, lo, nxl);
                bool pk_lo = lane < kPairs && lo > thr && lo > pre && lo > hi;
                bool pk_hi = lane < kPairs && hi > thr && hi > lo && hi > nxt;
                const int npk = min(4, P.max_peaks);
#pragma unroll
                for (int s = 0; s < 4; ++s) {
                    if (s >= npk) break;
                    float best = pk_lo ? lo : neg_inf;
                    int bi = 2 * lane;
                    if (pk_hi && hi > best) { best = hi; bi = 2 * lane + 1; }
                    warp_best(best, bi);
                    if (best == neg_inf) break;
                    if (bi == 2 * lane) pk_lo = false;
                    if (bi == 2 * lane + 1) pk_hi = false;
                    const float bp = sv[(bi + kBins - 1) % kBins];
                    const float bn = sv[(bi + 1) % kBins];
                    const float di = 0.5f * (bn - bp) / (best + best - bn - bp);
                    const float rotb = (float)bi + di + 0.5f;   // in bins
                    float frac = rotb / 36.0f;
                    if (frac < 0.0f) frac = frac + 1.0f;
                    const float q = floorf(frac * 255.0f) * P.theta_quantum;
                    if (s == 0) th.x = q;
                    else if (s == 1) th.y = q;
                    else if (s == 2) th.z = q;
                    else th.w = q;
                    ov |= 1u << (8 * s);
                }
            }
            if (lane == 0) {   // one store per output field
                reinterpret_cast<float4*>(o_theta)[slot] = th;
                reinterpret_cast<unsigned*>(o_valid)[slot] = ov;
            }
        }
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
        const int item = slot / P.G;
        const long long plane = (long long)item * T.bstride[lid];
        const int row0 = T.row0[lid] + item * T.row_step[lid];

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
        // the maps from the box's first row on (buffer row iy0 - row0)
        const long long first = plane + (long long)(iy0 - row0) * W;
        const float* __restrict__ gm = T.grad[lid] + first;
        const float* __restrict__ rm = T.rot[lid] + first;

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
                    const int o = row * W + ix;
                    rot = rm[o];
                    grad = gm[o];
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
                 const int* lh, const int* lw, const int* row0,
                 const int* row_step, int NL) {
    if (NL < 1 || NL > kMaxLevels) return false;
    T.NL = NL;
    for (int i = 0; i < NL; ++i) {
        if (lh[i] < 1 || lw[i] < 1) return false;
        T.grad[i] = reinterpret_cast<const float*>(grad_ptrs[i]);
        T.rot[i] = reinterpret_cast<const float*>(rot_ptrs[i]);
        T.bstride[i] = bstride[i];
        T.h[i] = lh[i];
        T.w[i] = lw[i];
        T.row0[i] = row0[i];
        T.row_step[i] = row_step[i];
    }
    return true;
}

}  // namespace

extern "C" {

// Tables: n = B * G slots, slot i of batch item i / G. valid: bytes 0/1.
// Levels: NL host entries each - device addresses of batch item 0's grad and
// rot plane, elements to the next batch item, global height, width, the
// global row of item 0's buffer row 0 and its step per item (LevelTable).
// thetas (n, 4) f32, ovalid (n, 4) bytes, votes (n, 36) f32 or null.
int hg_orientation(const float* x, const float* y, const float* sigma,
                   const unsigned char* valid, const int* level_id,
                   float* thetas, unsigned char* ovalid, float* votes,
                   int n, int G, const long long* grad_ptrs,
                   const long long* rot_ptrs, const long long* bstride,
                   const int* lh, const int* lw, const int* row0,
                   const int* row_step, int NL, float gaussian_factor,
                   float window, float bins_per_radian, float peak_threshold,
                   float theta_quantum, int half_sift, int single,
                   int max_peaks, void* stream) {
    LevelTable T;
    if (n < 1 || G < 1 || n % G != 0
            || !fill_levels(T, grad_ptrs, rot_ptrs, bstride, lh, lw, row0,
                            row_step, NL))
        return (int)cudaErrorInvalidValue;
    OriParams P;
    P.n = n; P.G = G;
    P.gaussian_factor = gaussian_factor; P.window = window;
    P.bins_per_radian = bins_per_radian; P.peak_threshold = peak_threshold;
    P.theta_quantum = theta_quantum;
    P.half_sift = half_sift; P.single = single; P.max_peaks = max_peaks;
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    // a fixed grid that fills the card once; its warps stride over the slots
    int blocks = sms * kOriBlocksPerSM;
    const int need = (n + kOriWarps - 1) / kOriWarps;
    if (blocks > need) blocks = need;
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
                  const int* row0, const int* row_step, int NL,
                  float window_factor, float pi, float two_pi,
                  float four_over_pi, void* stream) {
    LevelTable T;
    if (n < 1 || G < 1 || n % G != 0
            || !fill_levels(T, grad_ptrs, rot_ptrs, bstride, lh, lw, row0,
                            row_step, NL))
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
