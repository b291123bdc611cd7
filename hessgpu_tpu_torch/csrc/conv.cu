// Separable Gaussian blur, whole-octave Gaussian chain and by-2 decimation
// for Hopper (sm_90a). Plain C interface, loaded with ctypes
// (hessgpu_tpu_torch/ops/cuda/conv.py).
//
// Replaces three TPU kernels of hessgpu_tpu/ops/pallas/conv.py:
//   hg_blur          <- blur_pallas
//   hg_octave_chain  <- octave_chain_pallas
//   hg_downsample2   <- downsample2_pallas, called alone; on the main path
//                       the chain's decimation epilogue instead
//
// Arithmetic, all three: each filter pass is acc = t[0]*x[0];
// acc = acc + t[k]*x[k], left to right, compiled with -fmad=false, so results
// equal the plain PyTorch version (ops/gaussian.py) bit for bit.
//
// blur and decimation are bound by bytes: a 13-tap separable filter does 52
// operations per pixel against 8 bytes moved, decimation none at all. Each
// reads every input pixel from device memory once (plus a halo) and writes
// every output pixel once. The blur writes through an output batch stride,
// so the initial blur lands in level 0 of octave 0's stack. The standalone
// decimation reads the source plane through its batch and row strides.
//
// On the main path no decimation reads a level back: the chain that holds
// level level_ds in shared memory writes its even rows and columns, cropped
// to (H/2, W/2) like both pyramids crop, straight into level 0 of the next
// octave's stack (the decimation epilogue, chain_decimate), and the next
// chain starts from that level in place. Each octave's base is written once.
// A decimation launch of its own would cost a launch floor per octave (~6
// us, all of its time below 480 x 640), a read of the level back from
// device memory at sector granularity (half the plane, to keep a quarter),
// and a fresh base that the next chain copies into level 0 of its stack.
//
// The blur, one launch of (B, H, W):
//  * A block owns a column strip of 64 output columns of one plane and walks
//    down a segment of its rows in steps of 32 rows. Each step's input rows
//    of the strip, with the horizontal halo (the column index clamped to the
//    image), are staged with asynchronous copies into one of kBlurStages = 2
//    shared buffers a step ahead: the copies of step s+1 are in flight
//    during step s's passes (3 buffers, copies two steps ahead, measured 3%
//    faster at 16 x 480 x 640, 4 no faster: PERF.md).
//  * The horizontal pass writes its rows into a ring of 64 shared rows,
//    slot = row & 63. The vertical pass reads its taps from the ring, the
//    row index clamped to the image (a clamped row's horizontal result is
//    the edge row's), so every horizontal row of a segment is computed once:
//    the halo rows are recomputed once per segment (2r rows of every SH),
//    not once per 32-row tile. 64 slots hold the 32 new rows and the
//    2r <= 32 rows of the vertical halo.
//  * Both passes are register-blocked with the chain's `fir` (8 outputs a
//    thread from a window of taps + 7 values, each read from shared memory
//    once). Horizontal: lane = row, warp = group of 8 columns, odd row
//    pitches, so no bank conflicts. Vertical: lane = column, so loads are
//    free of conflicts and stores coalesced. No division runs per element.
//  * The strip and the step are fixed (64 x 32, 256 threads, 48 registers,
//    dynamic shared memory sized by the radius: 36.5 KB at r = 6, 41.6 KB at
//    r = 16; 5 blocks an SM). The segment height is the one choice: the
//    fewest segments that give the card kBlurBlocksPerSM = 4 blocks an SM,
//    no more than one per 32 rows, so that the grid is one wave of 5 blocks
//    an SM at the main path's shapes. 16 x 480 x 640 (the initial blur) gets
//    4 segments of 120 rows, 640 blocks; a 16-plane 30 x 40 stack one
//    segment of the whole height, 16 blocks. Halo work per pixel: (64 + 2r)
//    / 64 staged columns, (SH + 2r) / SH horizontal rows (1.19 and 1.10 at
//    r = 6, 120-row segments).
//  * What bounds it (scripts/torch_kernel_tuning.py, PERF.md): float32
//    instruction throughput (52 unfused operations a pixel, ~75
//    instructions with the loads and indices) and the staging copies, which
//    overlap the passes poorly: taking out any one of staging, horizontal
//    pass and vertical pass saves about as much as that phase costs alone.
//
// The chain is bound by bytes and operations about alike: L+1 planes moved,
// and 4 unfused operations per tap and pixel (248 per pixel for the default
// four transitions), which no fusion can merge because the rounding of every
// multiply and add is part of the result. One launch per octave reads the
// base once and writes all L levels; the levels in between live in shared
// memory, as octave_chain_pallas keeps them in VMEM. What the design does
// for this card:
//  * A block owns a 2-D output tile and stages the tile grown by the
//    chain's cumulative halo R = sum of the radii, cut to the image. Level
//    l+1 is computed in place over the tile grown by the halo that the
//    levels after it still need, again cut to the image, so a small octave
//    (30 x 40 under R = 29) is computed once and not once per halo pixel.
//  * Clamp-to-edge at every level: a level outside the image is that level
//    at the clamped index, not the blur of an extended lower level. Because
//    every level's region is "grown tile intersected with the image", the
//    clamped position of any tap lies inside the region the block holds, and
//    a pass clamps its read index to the region's bounds.
//  * The passes are register-blocked: a thread produces 8 neighbouring
//    outputs of a pass from a window of taps + 7 values, each read from
//    shared memory once, held in 8 registers that rotate by name through a
//    tap loop unrolled by 8 (the loop stays rolled beyond that: a fully
//    unrolled pass per tap count ran out of instruction cache). Lanes run
//    along the other axis (rows in the horizontal pass over an odd pitch,
//    columns in the vertical), so shared-memory accesses are free of bank
//    conflicts and global stores are coalesced. A window that touches no
//    region border skips the clamps. The region is staged with asynchronous
//    copies, all of a thread's loads in flight at once.
//  * The host picks the tile from a short list by a cost model (rounds of
//    one block per SM, a block's passes in rounds of its 1024 threads) among
//    the tiles whose two shared buffers fit 227 KB. No one tile serves a
//    pyramid: a 16-frame 480 x 640 octave wants the largest tile that fits
//    (least recomputation), its 120 x 160 octave a tile small enough to give
//    most SMs a block, and the DoG chain's wider halo leaves other tiles
//    fitting than the Hessian's (PERF.md has the times per tile). Planning
//    costs about as much host time as the rest of a call, so the last plans
//    are kept, like the per-device set-up. A chain whose halo fits
//    no tile, or needs more than 3 times the chain's own work, runs in
//    groups of consecutive levels: the last level of a group is read back
//    from the output stack as the next group's base. Default taps (Hessian
//    11, 13, 17, 21; DoG ... 25) are one group, one launch.

#include <cuda_runtime.h>

#include <cmath>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

constexpr int kMaxTaps = 33;   // params.KERNEL_MAX_WIDTH
constexpr int kMaxR = kMaxTaps / 2;
constexpr int kThreads = 256;

struct Taps {
    float t[kMaxTaps];
    int n;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}

// ---------------------------------------------------------------------------
// octave chain: one launch computes a group of consecutive levels
// ---------------------------------------------------------------------------

constexpr int kMaxChain = 8;        // transitions per launch
constexpr int kChainThreads = 1024;
constexpr int kChainOut = 8;        // outputs a thread produces per window

struct ChainParams {
    float t[kMaxChain][kMaxTaps];
    int n[kMaxChain];           // taps of transition l, 0 = identity
    int rem[kMaxChain + 1];     // halo the levels after level l still need
    int nt;                     // transitions in this launch
    int H, W, TH, TW;
    int pitchA, pitchB;         // odd row pitches of the two shared buffers
    int offB;                   // floats from buffer A to buffer B
    int write_base;             // 1: the base is also written out as level 0
    int dec;                    // level of the group to decimate, -1 = none
    int oh, ow;                 // the decimated plane: H / 2 x W / 2
    float* dec_out;             // its batch item 0; rows of ow floats
    long long in_bs, out_bs, hw, dec_bs;
};

// K = 8 neighbouring outputs of one filter pass from a window of nt + K - 1
// inputs, each read once: acc[j] = sum_k ts[k] * x[j + k], k ascending. The
// window slides through K registers that rotate by name (the tap loop is
// unrolled by K), so a tap costs one load of the tap, one of the new input
// and K multiplies and K adds. at(m) is the address of input m.
template <typename At>
__device__ __forceinline__ void fir(At at, const float* __restrict__ ts,
                                    int nt, float (&acc)[kChainOut]) {
    constexpr int K = kChainOut;
    float r[K];
#pragma unroll
    for (int j = 0; j < K; ++j) r[j] = *at(j);
    {
        const float t = ts[0];
#pragma unroll
        for (int j = 0; j < K; ++j) acc[j] = t * r[j];
    }
    // tap k reads x[k + K - 1] into the register x[k - 1] has left
    int k = 1;
#pragma unroll 1
    for (; k + K <= nt; k += K) {
#pragma unroll
        for (int s = 0; s < K; ++s) {
            const float t = ts[k + s];
            r[s] = *at(k + s + K - 1);
#pragma unroll
            for (int j = 0; j < K; ++j)
                acc[j] = acc[j] + t * r[(j + s + 1) % K];
        }
    }
    // the last (nt - 1) % K taps: an even number, nt being odd and K even
    static_assert(K % 2 == 0, "fir: K must be even");
#pragma unroll
    for (int s = 0; s < K - 2; s += 2) {
        if (k + s < nt) {
#pragma unroll
            for (int d = 0; d < 2; ++d) {
                const float t = ts[k + s + d];
                r[s + d] = *at(k + s + d + K - 1);
#pragma unroll
                for (int j = 0; j < K; ++j)
                    acc[j] = acc[j] + t * r[(j + s + d + 1) % K];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// blur: column strips walked down row segments (see the header)
// ---------------------------------------------------------------------------

constexpr int kBW = 64;                  // output columns of a strip
constexpr int kBH = 32;                  // rows a step stages and filters
constexpr int kBlurStages = 2;           // input buffers: copies run ahead
constexpr int kRing = 64;                // rows of horizontal results kept
constexpr int kRingPitch = kBW + 1;      // odd: lanes on rows hit all banks
constexpr int kBlurBlocksPerSM = 4;
static_assert(kRing >= kBH + 2 * kMaxR, "ring too small for the halo");
static_assert((kRing & (kRing - 1)) == 0, "ring slots are row & (kRing-1)");
static_assert(kBW == 8 * (kThreads / 32) && kBH == 32,
              "horizontal pass: lane = row, warp = 8 columns");

// Dynamic shared memory of a blur with radius r: the taps (kMaxTaps floats,
// padded to 36), kBlurStages input buffers of kBH rows at an odd pitch, the
// ring.
__host__ __device__ constexpr int blur_pitch(int r) {
    return (kBW + 2 * r) | 1;
}
__host__ __device__ constexpr int blur_smem_floats(int r) {
    return 36 + kBlurStages * kBH * blur_pitch(r) + kRing * kRingPitch;
}

// One separable blur of B contiguous (H, W) planes into B planes out_bs
// floats apart; block (strip, segment, plane) writes columns [64 strip, +64)
// of rows [SH segment, +SH).
__global__ void __launch_bounds__(kThreads)
blur_kernel(const float* __restrict__ in, float* __restrict__ out, int H,
            int W, int SH, long long out_bs,
            const __grid_constant__ Taps taps) {
    constexpr int K = kChainOut;
    extern __shared__ float blur_smem[];
    const int n = taps.n, r = n / 2;
    const int iw = kBW + 2 * r;                  // staged columns of a row
    const int pitch = blur_pitch(r);
    float* s_taps = blur_smem;
    float* s_in = blur_smem + 36;                // kBlurStages buffers
    float* s_ring = s_in + kBlurStages * kBH * pitch;

    const int c0 = blockIdx.x * kBW;
    const int R0 = blockIdx.y * SH, R1 = min(H, R0 + SH);
    const float* src = in + (long long)blockIdx.z * H * W;
    float* dst = out + (long long)blockIdx.z * out_bs;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x < n) s_taps[threadIdx.x] = taps.t[threadIdx.x];

    // Horizontal results of rows [hlo, hend) are computed once, step j
    // taking rows [hlo + j kBH, +kBH). After a step every output row whose
    // vertical taps (clamped) lie below the rows computed so far is written.
    const int hlo = max(0, R0 - r), hend = min(H, R1 + r);
    const int steps = (hend - hlo + kBH - 1) / kBH;
    // the input rows of step j and their horizontal halo into buffer b,
    // the column index clamped to the image; one group of asynchronous
    // copies (empty past the last step). Thread t copies elements t, t +
    // kThreads, ... of the rows x iw block, stepped without a division.
    const int step_y = kThreads / iw, step_x = kThreads - step_y * iw;
    const int first_y = threadIdx.x / iw, first_x = threadIdx.x - first_y * iw;
    auto stage = [&](int j, int b) {
        const int y0 = hlo + j * kBH;
        const int rows = j < steps ? min(kBH, hend - y0) : 0;
        const unsigned buf = (unsigned)__cvta_generic_to_shared(
            s_in + b * kBH * pitch);
        int ry = first_y, x = first_x;
        for (int e = threadIdx.x; e < rows * iw; e += kThreads) {
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                         :: "r"(buf + 4u * (ry * pitch + x)),
                            "l"(src + (long long)(y0 + ry) * W
                                + clampi(c0 - r + x, 0, W - 1))
                         : "memory");
            x += step_x;
            ry += step_y;
            if (x >= iw) { x -= iw; ++ry; }
        }
        asm volatile("cp.async.commit_group;" ::: "memory");
    };

    for (int j = 0; j + 1 < kBlurStages; ++j) stage(j, j);
    int odone = R0, cur = 0;
    for (int j = 0; j < steps; ++j) {
        stage(j + kBlurStages - 1,
              cur == 0 ? kBlurStages - 1 : cur - 1);   // the buffer j-1 used
        asm volatile("cp.async.wait_group %0;" :: "n"(kBlurStages - 1)
                     : "memory");
        __syncthreads();

        const int hy = hlo + j * kBH, rows = min(kBH, hend - hy);
        if (lane < rows) {   // horizontal: lane = row, warp = 8 columns
            const float* p = s_in + cur * kBH * pitch + lane * pitch
                + warp * K;
            float acc[K];
            fir([=](int m) { return p + m; }, s_taps, n, acc);
            float* o = s_ring + ((hy + lane) & (kRing - 1)) * kRingPitch
                + warp * K;
#pragma unroll
            for (int i = 0; i < K; ++i) o[i] = acc[i];
        }
        __syncthreads();

        const int oend = hy + rows == H ? R1 : min(R1, hy + rows - r);
        const int cx = threadIdx.x & (kBW - 1), gx = c0 + cx;
        for (int y = odone + (threadIdx.x / kBW) * K; y < oend;
             y += (kThreads / kBW) * K) {   // vertical: lane = column
            const float* colp = s_ring + cx;
            const int lo = y - r;
            float acc[K];
            if (lo >= 0 && lo + n + K - 1 <= H) {
                fir([=](int m) {
                        return colp + ((lo + m) & (kRing - 1)) * kRingPitch;
                    }, s_taps, n, acc);
            } else {
                fir([=](int m) {
                        return colp + (clampi(lo + m, 0, H - 1) & (kRing - 1))
                            * kRingPitch;
                    }, s_taps, n, acc);
            }
            if (gx < W) {
                float* d = dst + (long long)y * W + gx;
                if (y + K <= oend) {
#pragma unroll
                    for (int i = 0; i < K; ++i) d[(long long)i * W] = acc[i];
                } else {
#pragma unroll
                    for (int i = 0; i < K; ++i)
                        if (y + i < oend) d[(long long)i * W] = acc[i];
                }
            }
        }
        odone = oend;
        __syncthreads();     // the ring slots and buffer cur are written next
        cur = cur + 1 == kBlurStages ? 0 : cur + 1;
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Horizontal pass of one level: rows [y0, y1) of buffer A, output columns
// [X0, X1) into buffer B; reads clamp to the columns [x0, x1) that A holds.
// A is addressed by (row - oy, column - ox), B by (row - oy, column - X0).
__device__ __forceinline__ void chain_hpass(
        const float* __restrict__ A, float* __restrict__ Bf,
        const float* __restrict__ ts, int nt, int y0, int y1, int x0, int x1,
        int X0, int X1, int oy, int ox, int pA, int pB) {
    constexpr int K = kChainOut, T = kChainThreads;
    const int R = nt / 2;
    const int nrows = y1 - y0;
    const int items = nrows * ((X1 - X0 + K - 1) / K);
    // window `item` is rows' residue ry of column group cg: lanes run over
    // rows; stepping by T threads moves (cg, ry) by (T / nrows, T % nrows)
    const int step_cg = T / nrows, step_ry = T - step_cg * nrows;
    int cg = threadIdx.x / nrows, ry = threadIdx.x - cg * nrows;
    for (int item = threadIdx.x; item < items;
         item += T, cg += step_cg, ry += step_ry) {
        if (ry >= nrows) { ry -= nrows; ++cg; }
        const int c0 = X0 + cg * K, lo = c0 - R;
        const float* rowp = A + (y0 + ry - oy) * pA - ox;
        float acc[K];
        if (lo >= x0 && lo + nt + K - 1 <= x1) {
            const float* p = rowp + lo;
            fir([=](int m) { return p + m; }, ts, nt, acc);
        } else {
            fir([=](int m) { return rowp + clampi(lo + m, x0, x1 - 1); },
                   ts, nt, acc);
        }
        float* o = Bf + (y0 + ry - oy) * pB + (c0 - X0);
        if (c0 + K <= X1) {
#pragma unroll
            for (int j = 0; j < K; ++j) o[j] = acc[j];
        } else {
#pragma unroll
            for (int j = 0; j < K; ++j)
                if (c0 + j < X1) o[j] = acc[j];
        }
    }
}

// Vertical pass of one level: output rows [Y0, Y1), columns [X0, X1) out of
// buffer B, whose rows [y0, y1) are filled; reads clamp to those rows. The
// result goes to buffer A (unless it is the launch's last level) and, inside
// the block's tile [ty0, ty1) x [tx0, tx1), to the output plane.
__device__ __forceinline__ void chain_vpass(
        const float* __restrict__ Bf, float* __restrict__ A,
        float* __restrict__ dst, const float* __restrict__ ts, int nt, int y0,
        int y1, int Y0, int Y1, int X0, int X1, int oy, int ox, int pA, int pB,
        int ty0, int ty1, int tx0, int tx1, int W, bool keep) {
    constexpr int K = kChainOut, T = kChainThreads;
    const int R = nt / 2;
    const int ncols = X1 - X0;
    const int items = ncols * ((Y1 - Y0 + K - 1) / K);
    // window `item` is column cx of row group rg: lanes run over columns
    const int step_rg = T / ncols, step_cx = T - step_rg * ncols;
    int rg = threadIdx.x / ncols, cx = threadIdx.x - rg * ncols;
    for (int item = threadIdx.x; item < items;
         item += T, rg += step_rg, cx += step_cx) {
        if (cx >= ncols) { cx -= ncols; ++rg; }
        const int r0 = Y0 + rg * K, lo = r0 - R;
        const float* colp = Bf - oy * pB + cx;
        float acc[K];
        if (lo >= y0 && lo + nt + K - 1 <= y1) {
            const float* p = colp + lo * pB;
            fir([=](int m) { return p + m * pB; }, ts, nt, acc);
        } else {
            fir([=](int m) {
                       return colp + clampi(lo + m, y0, y1 - 1) * pB;
                   }, ts, nt, acc);
        }
        const int gx = X0 + cx;
        const bool whole = r0 + K <= Y1;
        if (keep) {
            float* a = A + (r0 - oy) * pA + (gx - ox);
            if (whole) {
#pragma unroll
                for (int j = 0; j < K; ++j) a[j * pA] = acc[j];
            } else {
#pragma unroll
                for (int j = 0; j < K; ++j)
                    if (r0 + j < Y1) a[j * pA] = acc[j];
            }
        }
        if (gx >= tx0 && gx < tx1) {
            float* d = dst + r0 * W + gx;
            if (r0 >= ty0 && r0 + K <= ty1) {
#pragma unroll
                for (int j = 0; j < K; ++j) d[j * W] = acc[j];
            } else {
#pragma unroll
                for (int j = 0; j < K; ++j)
                    if (r0 + j >= ty0 && r0 + j < ty1) d[j * W] = acc[j];
            }
        }
    }
}

// The decimation epilogue: next[y, x] = level[2y, 2x] for the kept pixels
// of the block's tile [ty0, ty1) x [tx0, tx1), y < oh, x < ow, read from
// buffer A, which holds the level over a region that contains the tile.
// Tile origins are multiples of the (even) tile sizes, so the blocks' kept
// pixels partition the decimated plane: each is written once. A warp
// writes a run of consecutive columns of one row (coalesced); its reads of
// A are two floats apart (a two-way bank conflict).
__device__ __forceinline__ void chain_decimate(
        const float* __restrict__ A, float* __restrict__ next, int ty0,
        int ty1, int tx0, int tx1, int oy, int ox, int pA, int oh, int ow) {
    constexpr int T = kChainThreads;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int y1 = min((ty1 + 1) >> 1, oh), x1 = min((tx1 + 1) >> 1, ow);
    for (int y = (ty0 >> 1) + warp; y < y1; y += T / 32)
        for (int x = (tx0 >> 1) + lane; x < x1; x += 32)
            next[y * ow + x] = A[(2 * y - oy) * pA + (2 * x - ox)];
}

// Levels 1..nt of a group from its base, for one tile of one batch item.
// in: the base plane of batch item 0; out: the plane of level 0 of the group
// in the (B, L, H, W) stack (level l of the group is out + l*hw). If P.dec
// >= 0, level P.dec of the group is also decimated into P.dec_out.
__global__ void __launch_bounds__(kChainThreads)
chain_kernel(const float* __restrict__ in, float* __restrict__ out,
             const __grid_constant__ ChainParams P) {
    constexpr int T = kChainThreads;
    extern __shared__ float chain_smem[];
    float* taps = chain_smem;                    // nt x 33
    float* A = chain_smem + kMaxChain * kMaxTaps;
    float* Bf = A + P.offB;
    for (int i = threadIdx.x; i < P.nt * kMaxTaps; i += T)
        taps[i] = P.t[i / kMaxTaps][i % kMaxTaps];

    const int H = P.H, W = P.W, pA = P.pitchA, pB = P.pitchB;
    const int row0 = blockIdx.y * P.TH, col0 = blockIdx.x * P.TW;
    const int ty0 = row0, ty1 = min(row0 + P.TH, H);
    const int tx0 = col0, tx1 = min(col0 + P.TW, W);
    const float* src = in + (long long)blockIdx.z * P.in_bs;
    float* dst = out + (long long)blockIdx.z * P.out_bs;
    float* next = P.dec_out + (long long)blockIdx.z * P.dec_bs;

    // region of level l: the tile grown by rem[l], cut to the image
    int y0 = max(0, row0 - P.rem[0]), y1 = min(H, row0 + P.TH + P.rem[0]);
    int x0 = max(0, col0 - P.rem[0]), x1 = min(W, col0 + P.TW + P.rem[0]);
    const int oy = y0, ox = x0;

    // Stage the region with asynchronous copies (global to shared without a
    // register in between), so that a thread has all its loads in flight at
    // once instead of waiting for each before it can store it.
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int gy = y0 + warp; gy < y1; gy += T / 32) {
        const float* srow = src + gy * W;
        const unsigned arow = (unsigned)__cvta_generic_to_shared(
            A + (gy - oy) * pA - ox);
        for (int gx = x0 + lane; gx < x1; gx += 32)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                         :: "r"(arow + 4u * gx), "l"(srow + gx) : "memory");
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    if (P.write_base)
        for (int gy = ty0 + warp; gy < ty1; gy += T / 32)
            for (int gx = tx0 + lane; gx < tx1; gx += 32)
                dst[gy * W + gx] = A[(gy - oy) * pA + (gx - ox)];
    if (P.dec == 0)
        chain_decimate(A, next, ty0, ty1, tx0, tx1, oy, ox, pA, P.oh, P.ow);

    for (int l = 0; l < P.nt; ++l) {
        dst += P.hw;
        const int n = P.n[l];
        if (n == 0) {   // identity: level l+1 = level l, still in A
            for (int gy = ty0 + warp; gy < ty1; gy += T / 32)
                for (int gx = tx0 + lane; gx < tx1; gx += 32)
                    dst[gy * W + gx] = A[(gy - oy) * pA + (gx - ox)];
            if (l + 1 == P.dec)
                chain_decimate(A, next, ty0, ty1, tx0, tx1, oy, ox, pA, P.oh,
                               P.ow);
            continue;
        }
        const int rem = P.rem[l + 1];
        const int Y0 = max(0, row0 - rem), Y1 = min(H, row0 + P.TH + rem);
        const int X0 = max(0, col0 - rem), X1 = min(W, col0 + P.TW + rem);
        const float* ts = taps + l * kMaxTaps;
        chain_hpass(A, Bf, ts, n, y0, y1, x0, x1, X0, X1, oy, ox, pA, pB);
        __syncthreads();
        // A keeps the new level for the next transition, and for the
        // epilogue when it is the decimated one (a group's last level too)
        chain_vpass(Bf, A, dst, ts, n, y0, y1, Y0, Y1, X0, X1, oy, ox, pA, pB,
                    ty0, ty1, tx0, tx1, W, l + 1 < P.nt || l + 1 == P.dec);
        __syncthreads();
        if (l + 1 == P.dec)   // A is read only: no barrier before the hpass
            chain_decimate(A, next, ty0, ty1, tx0, tx1, oy, ox, pA, P.oh,
                           P.ow);
        y0 = Y0; y1 = Y1; x0 = X0; x1 = X1;
    }
}

// out[b, y, x] = in[b*in_bs + 2y*in_rs + 2x]; out is (B, ho, wo) contiguous.
__global__ void downsample2_kernel(const float* __restrict__ in,
                                   float* __restrict__ out, long long in_bs,
                                   long long in_rs, int ho, int wo) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x < wo && y < ho) {
        const float* src = in + (long long)blockIdx.z * in_bs;
        out[((long long)blockIdx.z * ho + y) * wo + x] =
            src[2LL * y * in_rs + 2 * x];
    }
}

bool make_taps(const float* taps, int n, Taps* out) {
    if (n < 1 || n > kMaxTaps || n % 2 == 0) return false;
    for (int i = 0; i < n; ++i) out->t[i] = taps[i];
    out->n = n;
    return true;
}

constexpr size_t kMaxSmem = 232448;   // 227 KB a block may use on sm_90

// the output tiles the cost model chooses from
constexpr int kTileH[] = {16, 32, 48, 64, 80, 96, 112, 128};
constexpr int kTileW[] = {32, 64, 96, 128, 160, 192, 256};

struct ChainPlan {
    int TH = 0, TW = 0;
    int pitchA = 0, pitchB = 0, offB = 0;
    size_t smem = 0;
    double cost = 0.0;     // modelled time of the launch, arbitrary unit
    double ratio = 0.0;    // multiply-adds done over multiply-adds needed
};

// Sum and maximum, over the tiles of one axis (size `dim`, tile `T`), of the
// extent of the tile grown by `halo` and cut to [0, dim).
void axis_extents(int dim, int T, int halo, double* sum, double* mx) {
    *sum = 0.0;
    *mx = 0.0;
    for (int a = 0; a < dim; a += T) {
        const int e = (a + T + halo < dim ? a + T + halo : dim)
            - (a - halo > 0 ? a - halo : 0);
        *sum += e;
        if (e > *mx) *mx = e;
    }
}

// Shared memory and modelled cost of running transitions [l0, l0 + nt) of a
// chain in one launch with tile TH x TW. Returns false if it does not fit.
bool plan_tile(int B, int H, int W, const int* ntaps, int l0, int nt, int TH,
               int TW, int sms, ChainPlan* out) {
    int rem[kMaxChain + 2] = {0};
    for (int l = nt - 1; l >= 0; --l) rem[l] = rem[l + 1] + ntaps[l0 + l] / 2;
    const int rows0 = TH + 2 * rem[0] < H ? TH + 2 * rem[0] : H;
    const int cols0 = TW + 2 * rem[0] < W ? TW + 2 * rem[0] : W;
    const int cols1 = TW + 2 * rem[1] < W ? TW + 2 * rem[1] : W;
    ChainPlan p;
    p.TH = TH;
    p.TW = TW;
    p.pitchA = cols0 | 1;
    p.pitchB = cols1 | 1;
    p.offB = rows0 * p.pitchA;
    p.smem = sizeof(float) * ((size_t)rows0 * (p.pitchA + p.pitchB)
                              + kMaxChain * kMaxTaps);
    if (p.smem > kMaxSmem) return false;
    // Multiply-adds of all blocks (total), of the biggest block (biggest) and
    // of the chain itself (needed); and the biggest block's time in units of
    // one thread's multiply-add: a pass runs in rounds of kChainThreads
    // windows, each costing its kChainOut * taps multiply-adds plus about 30
    // for its set-up and stores.
    double total = 0.0, biggest = 0.0, needed = 0.0, block_time = 0.0;
    for (int l = 0; l < nt; ++l) {
        double rs, rm, Rs, Rm, Cs, Cm;
        axis_extents(H, TH, rem[l], &rs, &rm);
        axis_extents(H, TH, rem[l + 1], &Rs, &Rm);
        axis_extents(W, TW, rem[l + 1], &Cs, &Cm);
        const double n = ntaps[l0 + l];
        total += n * Cs * (rs + Rs);
        biggest += n * Cm * (rm + Rm);
        needed += n * 2.0 * H * W;
        const double hwin = rm * std::ceil(Cm / kChainOut);
        const double vwin = Cm * std::ceil(Rm / kChainOut);
        block_time += (std::ceil(hwin / kChainThreads)
                       + std::ceil(vwin / kChainThreads))
            * (kChainOut * n + 30.0) * kChainThreads;
    }
    // Blocks run in rounds of one per SM. Edge blocks are smaller than the
    // biggest (mean / biggest), which shows the more rounds there are.
    const long long blocks = (long long)B * ((H + TH - 1) / TH)
        * ((W + TW - 1) / TW);
    const double rounds = (double)((blocks + sms - 1) / sms);
    const double edge = biggest > 0.0 ? (total * B / blocks) / biggest : 1.0;
    p.cost = rounds * block_time * (1.0 - (1.0 - edge) * (1.0 - 1.0 / rounds));
    if (nt == 0) p.cost = (double)blocks;   // a bare copy: the fewest blocks
    p.ratio = needed > 0.0 ? total / needed : 1.0;
    *out = p;
    return true;
}

// The cheapest tile for transitions [l0, l0 + nt) among those that fit and
// do at most max_ratio times the work needed. Returns false if there is none.
bool plan_group(int B, int H, int W, const int* ntaps, int l0, int nt,
                int sms, double max_ratio, ChainPlan* best) {
    bool found = false;
    for (int TH : kTileH)
        for (int TW : kTileW) {
            ChainPlan p;
            if (!plan_tile(B, H, W, ntaps, l0, nt, TH, TW, sms, &p)
                    || p.ratio > max_ratio)
                continue;
            if (!found || p.cost < best->cost) *best = p;
            found = true;
        }
    return found;
}

// What the host keeps between calls, under one lock: per device, the SM count
// (read, and the kernel's shared-memory limit raised, at the first call on
// that device); and the last plans, because a pyramid asks for the same few
// shapes over and over.
struct PlanEntry {
    int key[4 + kMaxChain];
    int nt;
    ChainPlan plan;
};
std::mutex g_chain_mutex;
std::vector<int> g_chain_sms;           // by device ordinal, 0 = not set up
std::vector<PlanEntry> g_chain_plans;

// SM count of the current device. The first call on a device also raises
// chain_kernel's and blur_kernel's shared-memory limits there.
cudaError_t sm_count(int* sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    std::lock_guard<std::mutex> lock(g_chain_mutex);
    if ((int)g_chain_sms.size() <= dev) g_chain_sms.resize(dev + 1, 0);
    if (g_chain_sms[dev] == 0) {
        int n = 0;
        e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return e;
        e = cudaFuncSetAttribute(chain_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kMaxSmem);
        if (e != cudaSuccess) return e;
        e = cudaFuncSetAttribute(blur_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 4 * blur_smem_floats(kMaxR));
        if (e != cudaSuccess) return e;
        g_chain_sms[dev] = n;
    }
    *sms = g_chain_sms[dev];
    return cudaSuccess;
}

// Row segments of a blur: the fewest that give kBlurBlocksPerSM blocks an
// SM (fewer segments, less halo recomputed), and no more than one per kBH
// rows.
int blur_segments(int B, int H, int W, int sms) {
    const long long per = (long long)B * ((W + kBW - 1) / kBW);
    const long long want = (kBlurBlocksPerSM * (long long)sms + per - 1) / per;
    const long long most = (H + kBH - 1) / kBH;
    return (int)(want < most ? want : most);
}

// Rows of a segment: H cut into blur_segments pieces, the last the shortest.
int blur_segment_rows(int B, int H, int W, int sms) {
    const int seg = blur_segments(B, H, W, sms);
    return (H + seg - 1) / seg;
}

// The group of transitions that starts at l0: how many (at most `avail`) and
// with what tile. The longest group with a tile that fits and does at most
// 3 times the work needed; a single transition takes any tile that fits.
// Returns 0 if nothing fits, which the built-in tile list rules out (its
// smallest tile holds any single transition).
int plan_chain_group(int B, int H, int W, const int* ntaps, int l0, int avail,
                     int sms, ChainPlan* plan) {
    PlanEntry e;
    const int head[4] = {B, H, W, sms};
    std::memcpy(e.key, head, sizeof(head));
    for (int l = 0; l < kMaxChain; ++l)
        e.key[4 + l] = l < avail ? ntaps[l0 + l] : -1;
    std::lock_guard<std::mutex> lock(g_chain_mutex);
    for (const PlanEntry& c : g_chain_plans)
        if (std::memcmp(c.key, e.key, sizeof(e.key)) == 0) {
            *plan = c.plan;
            return c.nt;
        }
    e.nt = avail;
    while (!plan_group(B, H, W, ntaps, l0, e.nt, sms, e.nt > 1 ? 3.0 : 1e30,
                       &e.plan)) {
        if (e.nt <= 1) return 0;
        --e.nt;
    }
    if (g_chain_plans.size() >= 64) g_chain_plans.clear();
    g_chain_plans.push_back(e);
    *plan = e.plan;
    return e.nt;
}

bool chain_args_ok(int B, int L, int H, int W, const int* ntaps) {
    if (B < 1 || B > 65535 || L < 1 || H < 1 || W < 1
            || (long long)H * W > 0x7fffffffLL)   // in-plane offsets are ints
        return false;
    for (int l = 0; l + 1 < L; ++l)
        if (ntaps[l] != 0
                && (ntaps[l] < 1 || ntaps[l] > kMaxTaps || ntaps[l] % 2 == 0))
            return false;
    return true;
}

// Calls launch(l0, nt, plan) for every group of a chain's transitions, in
// order: at least once, L == 1 being a bare copy of the base (nt = 0).
template <typename Launch>
cudaError_t for_each_group(int B, int L, int H, int W, const int* ntaps,
                           int sms, Launch launch) {
    int l0 = 0;
    do {
        const int avail = L - 1 - l0 < kMaxChain ? L - 1 - l0 : kMaxChain;
        ChainPlan plan;
        const int nt = plan_chain_group(B, H, W, ntaps, l0, avail, sms, &plan);
        if (nt == 0 && avail > 0) return cudaErrorInvalidValue;
        const cudaError_t e = launch(l0, nt, plan);
        if (e != cudaSuccess) return e;
        l0 += nt;
    } while (l0 + 1 < L);
    return cudaSuccess;
}

}  // namespace

extern "C" {

const char* hg_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// (B, H, W) contiguous -> B planes of (H, W), out_bs floats apart, rows
// contiguous (e.g. level 0 of a (B, L, H, W) stack: out_bs = L*H*W).
// taps: n host floats, n odd <= 33.
int hg_blur(const float* in, float* out, int B, int H, int W,
            long long out_bs, const float* taps, int n, void* stream) {
    Taps t;
    if (!make_taps(taps, n, &t) || B < 1 || B > 65535 || H < 1 || W < 1
            || (long long)H * W > 0x7fffffffLL || out_bs < (long long)H * W)
        return (int)cudaErrorInvalidValue;
    int sms = 0;
    const cudaError_t e = sm_count(&sms);
    if (e != cudaSuccess) return (int)e;
    const int SH = blur_segment_rows(B, H, W, sms);
    dim3 grid((W + kBW - 1) / kBW, (H + SH - 1) / SH, B);
    blur_kernel<<<grid, kThreads, 4 * blur_smem_floats(n / 2),
                  (cudaStream_t)stream>>>(in, out, H, W, SH, out_bs, t);
    return (int)cudaGetLastError();
}

// The rows of a segment that hg_blur walks for a (B, H, W) stack on the
// current device; -1 if it would refuse the shape. Launches nothing.
int hg_blur_segment_rows(int B, int H, int W) {
    int sms = 0;
    if (B < 1 || B > 65535 || H < 1 || W < 1 || sm_count(&sms) != cudaSuccess)
        return -1;
    return blur_segment_rows(B, H, W, sms);
}

// base (B, H, W) -> out (B, L, H, W): out[:, 0] = base,
// out[:, l+1] = blur(out[:, l], taps of transition l). taps: (L-1) rows of 33
// host floats; ntaps[l] = width of row l, 0 = identity. One launch per group
// of consecutive levels. base == NULL: out[:, 0] already holds the base, and
// the chain starts from it in place (nothing writes level 0). dec_level in
// [0, L): level dec_level is also decimated, next[b, y, x] =
// out[b, dec_level, 2y, 2x] for y < H/2, x < W/2, into dec_out, whose batch
// items are dec_bs floats apart and whose rows are W/2 floats long (e.g.
// level 0 of the next octave's stack), by the launch that computes that
// level (the first, for level 0). dec_level = -1: no decimation.
int hg_octave_chain(const float* base, float* out, int B, int L, int H, int W,
                    const float* taps, const int* ntaps, int dec_level,
                    float* dec_out, long long dec_bs, void* stream) {
    if (!chain_args_ok(B, L, H, W, ntaps) || dec_level < -1
            || dec_level >= L
            || (dec_level >= 0 && (dec_out == nullptr
                                   || dec_bs < (long long)(H / 2) * (W / 2))))
        return (int)cudaErrorInvalidValue;
    int sms = 0;
    cudaError_t e = sm_count(&sms);
    if (e != cudaSuccess) return (int)e;
    cudaStream_t s = (cudaStream_t)stream;
    const long long hw = (long long)H * W;
    const long long stack = hw * L;
    return (int)for_each_group(B, L, H, W, ntaps, sms,
                               [&](int l0, int nt, const ChainPlan& plan) {
        ChainParams P;
        P.nt = nt;
        P.rem[nt] = 0;
        for (int l = nt - 1; l >= 0; --l) {
            P.n[l] = ntaps[l0 + l];
            P.rem[l] = P.rem[l + 1] + P.n[l] / 2;
            for (int k = 0; k < P.n[l]; ++k)
                P.t[l][k] = taps[(l0 + l) * kMaxTaps + k];
        }
        P.H = H; P.W = W; P.TH = plan.TH; P.TW = plan.TW;
        P.pitchA = plan.pitchA; P.pitchB = plan.pitchB; P.offB = plan.offB;
        const bool from_base = l0 == 0 && base != nullptr;
        P.write_base = from_base;
        P.in_bs = from_base ? hw : stack;
        P.out_bs = stack;
        P.hw = hw;
        // the group that computes the level decimates it: a group's base
        // (level l0 > 0) is the previous group's last level
        P.dec = dec_level == 0 && l0 == 0 ? 0
            : dec_level > l0 && dec_level <= l0 + nt ? dec_level - l0 : -1;
        P.oh = H / 2; P.ow = W / 2;
        P.dec_out = dec_out;
        P.dec_bs = dec_bs;
        dim3 grid((W + plan.TW - 1) / plan.TW, (H + plan.TH - 1) / plan.TH, B);
        chain_kernel<<<grid, kChainThreads, plan.smem, s>>>(
            from_base ? base : out + l0 * hw, out + l0 * hw, P);
        return cudaGetLastError();
    });
}

// The number of device launches (groups of levels) hg_octave_chain makes for
// these arguments on the current device; -1 if it would refuse them. Launches
// nothing.
int hg_octave_chain_groups(int B, int L, int H, int W, const int* ntaps) {
    int sms = 0;
    if (!chain_args_ok(B, L, H, W, ntaps)
            || sm_count(&sms) != cudaSuccess)
        return -1;
    int groups = 0;
    const cudaError_t e = for_each_group(
        B, L, H, W, ntaps, sms, [&](int, int, const ChainPlan&) {
            ++groups;
            return cudaSuccess;
        });
    return e == cudaSuccess ? groups : -1;
}

// Decimation by 2 keeping even rows/cols: in is B planes of (h, w) with
// element strides in_bs (batch) and in_rs (row), unit column stride; out is
// (B, std::ceil(h/2), std::ceil(w/2)) contiguous.
int hg_downsample2(const float* in, float* out, int B, int h, int w,
                   long long in_bs, long long in_rs, void* stream) {
    if (B < 1 || B > 65535 || h < 1 || w < 1)
        return (int)cudaErrorInvalidValue;
    const int ho = (h + 1) / 2, wo = (w + 1) / 2;
    dim3 block(32, 8);
    dim3 grid((wo + block.x - 1) / block.x, (ho + block.y - 1) / block.y, B);
    downsample2_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        in, out, in_bs, in_rs, ho, wo);
    return (int)cudaGetLastError();
}

}  // extern "C"
