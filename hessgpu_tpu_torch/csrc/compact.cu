// GENERATE_FEATURE_LIST on Hopper (sm_90a): the compaction of the detect
// kernel's maps into the global keypoint table, as three kernels that read
// the valid maps in full and the keypoint payload at kept cells only. Plain
// C interface, loaded with ctypes (hessgpu_tpu_torch/ops/cuda/compact.py).
//
// Replaces no TPU kernel: the JAX package compacts with XLA sorts
// (hessgpu_tpu/ops/compaction.py), the port's plain route with PyTorch prefix
// sums, clamps and binary searches (ops/compaction.py
// compact_octave_keypoints, pyramid.py _globalize), several int32 passes over
// every one-byte cell. Membership and order are theirs:
//   - per (frame, key level, row) the leftmost kpr = min(W, _row_cap(W))
//     valid cells;
//   - per level the first `cap` of those in raster order;
//   - the table: the levels in level-major order (octave * NK + key level),
//     the first G slots of their concatenation, zeros past a frame's count.
//
// What bounds it on this card: bytes. valid is one byte a cell, (B, NK, H, W)
// an octave: 1.2 MB a 640x480 frame over all octaves, 97 MB a 24 MP one.
// Kept cells (at most G = 2048 a frame) carry 20 B of payload each. The
// design reads valid about once:
//   - row_count_kernel, one launch an octave right after its detection: a
//     warp per (frame, key level, row) counts the row's bytes with 16-byte
//     loads (valid is 0/1 a byte, so a word's popcount counts its set
//     bytes), capped at kpr: one int32 a row;
//   - level_scan_kernel: a block per (frame, level) scans its rows' capped
//     counts into row offsets and writes the level's count, min(sum, cap);
//   - table_scatter_kernel: a warp per row. A row with no kept cell below
//     its level's cap and below G reads two ints and stops; the others read
//     their valid bytes again, rank the set bytes and write each kept cell
//     to its slot (the counts of the levels before it + the row's offset +
//     the rank), reading the payload at those cells only. Further blocks
//     write the slots past each frame's count (zeros) and the count, so the
//     table is written once, with no memset.
// A row starts anywhere (W need not be a multiple of 16): a warp loads the
// 16-byte aligned chunks that cover it and masks the bytes outside it. Such
// a chunk never crosses a page, so the few bytes it reads past either end
// of the map cannot fault.
//
// Arithmetic is the plain route's, expression by expression, compiled with
// -fmad=false: x = (float)col + 0.5f + dx, y = (float)row + 0.5f + dy,
// sigma = key_sigma[k] * powf(sigma_step, ds), the plain route's
// torch.pow(float, tensor) (PyTorch's CUDA pow of two floats is ::pow, that
// is powf). The table is bit-equal to the plain route's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOctaves = 16;
constexpr int kMaxKeys = 8;             // kMaxKeys of detect.cu
constexpr int kWarps = 8;               // warps a block of the row kernels
constexpr int kRowThreads = kWarps * 32;
constexpr int kScanThreads = 1024;      // 32 warps: one scan of the warp sums
constexpr unsigned kAll = 0xffffffffu;
constexpr int kPtrs = 7;                // per octave, in hg_feature_table's order
constexpr int kDims = 3;

struct OctaveArgs {
    const unsigned char* valid;   // (B, NK, H, W) 0/1
    const float* dx;              // (B, NK, H, W), read at kept cells only
    const float* dy;
    const float* ds;
    const float* resp;
    const int* ftype;
    int* rows;                    // (2, B, NK, H): capped counts, row offsets
    int H, W, cap;
    int row_start;                // the octave's first row among a frame's
};

struct TableArgs {
    OctaveArgs oct[kMaxOctaves];
    int n_oct, B, NK, G, n_levels;
    int rows;                     // a frame's rows, all octaves and key levels
    const float* key_sigma;       // (NK,)
    float sigma_step;
    float* x;                     // (B, G) each
    float* y;
    float* sigma;
    float* theta;
    float* resp;
    int* ftype;
    int* level_id;
    unsigned char* valid;
    int* level_counts;            // (B, n_levels)
    int* pre_count;               // (B,)
};

// The bytes [s, e) of a 16-byte chunk as a mask of its four words (s, e may
// lie outside 0..16; empty where e <= s). Little-endian: byte i of a word is
// its bits 8i..8i+7.
__device__ __forceinline__ uint4 chunk_mask(int s, int e) {
    unsigned m[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int a = min(max(s - 4 * j, 0), 4);
        const int b = min(max(e - 4 * j, 0), 4);
        const unsigned below_b = b == 4 ? kAll : (1u << (8 * b)) - 1u;
        const unsigned below_a = a == 4 ? kAll : (1u << (8 * a)) - 1u;
        m[j] = below_b & ~below_a;
    }
    return make_uint4(m[0], m[1], m[2], m[3]);
}

__device__ __forceinline__ int set_bytes(uint4 v) {
    return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// One row of a valid map as the 16-byte aligned chunks that cover its W
// bytes; byte t of chunk c is column 16 c + t - lead.
struct RowChunks {
    const uint4* base;
    int lead;   // bytes of chunk 0 before the row
    int W;
    int n;      // chunks

    __device__ RowChunks(const unsigned char* row, int W_) : W(W_) {
        const uintptr_t p = reinterpret_cast<uintptr_t>(row);
        base = reinterpret_cast<const uint4*>(p & ~uintptr_t(15));
        lead = (int)(p & 15);
        n = (lead + W + 15) >> 4;
    }

    // chunk c with the bytes outside the row cleared; zeros past the row
    __device__ __forceinline__ uint4 load(int c) const {
        if (c >= n) return make_uint4(0u, 0u, 0u, 0u);
        uint4 v = __ldg(base + c);
        const uint4 m = chunk_mask(lead - 16 * c, lead + W - 16 * c);
        v.x &= m.x; v.y &= m.y; v.z &= m.z; v.w &= m.w;
        return v;
    }
};

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(kAll, v, d);
        if (lane >= d) v += t;
    }
    return v;
}

// counts[row] = min(set bytes of the row, kpr), rows = B * NK * H
__global__ void __launch_bounds__(kRowThreads)
row_count_kernel(const unsigned char* __restrict__ valid,
                 int* __restrict__ counts, long long rows, int W, int kpr) {
    const int lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (row >= rows) return;
    const RowChunks rc(valid + row * W, W);
    int n = 0;
#pragma unroll 4
    for (int c = lane; c < rc.n; c += 32) n += set_bytes(rc.load(c));
    n = __reduce_add_sync(kAll, n);
    if (lane == 0) counts[row] = min(n, kpr);
}

// grid (n_levels, B): the row offsets of level blockIdx.x of frame
// blockIdx.y (exclusive sums of its capped counts) and its count
__global__ void __launch_bounds__(kScanThreads)
level_scan_kernel(const __grid_constant__ TableArgs P) {
    __shared__ int warp_before[32];
    __shared__ int block_sum;
    const int L = blockIdx.x, b = blockIdx.y;
    const int o = L / P.NK, k = L - o * P.NK;
    const OctaveArgs& oc = P.oct[o];
    const size_t at = ((size_t)b * P.NK + k) * oc.H;
    const int* cnt = oc.rows + at;
    int* off = oc.rows + (size_t)P.B * P.NK * oc.H + at;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int carry = 0;
    for (int r0 = 0; r0 < oc.H; r0 += kScanThreads) {
        const int r = r0 + (int)threadIdx.x;
        const int v = r < oc.H ? cnt[r] : 0;
        const int inc = warp_inclusive_sum(v, lane);
        if (lane == 31) warp_before[warp] = inc;
        __syncthreads();
        if (warp == 0) {
            const int w = warp_before[lane];
            const int winc = warp_inclusive_sum(w, lane);
            warp_before[lane] = winc - w;
            if (lane == 31) block_sum = winc;
        }
        __syncthreads();
        if (r < oc.H) off[r] = carry + warp_before[warp] + inc - v;
        carry += block_sum;
        __syncthreads();   // warp_before and block_sum are written again
    }
    if (threadIdx.x == 0)
        P.level_counts[(size_t)b * P.n_levels + L] = min(carry, oc.cap);
}

// grid (row_blocks + tail blocks, B). A warp per row of frame blockIdx.y
// writes the row's kept cells to their slots; a thread per slot of the tail
// blocks zeroes the slots past the frame's count.
__global__ void __launch_bounds__(kRowThreads)
table_scatter_kernel(const __grid_constant__ TableArgs P, int row_blocks) {
    const int b = blockIdx.y;
    const int* lc = P.level_counts + (size_t)b * P.n_levels;
    const size_t out0 = (size_t)b * P.G;
    if ((int)blockIdx.x >= row_blocks) {
        const int s = ((int)blockIdx.x - row_blocks) * kRowThreads
                      + (int)threadIdx.x;
        int total = 0;
        for (int i = 0; i < P.n_levels; ++i) total += lc[i];
        const int pre = min(total, P.G);
        if (s == 0) P.pre_count[b] = pre;
        if (s >= P.G || s < pre) return;
        const size_t t = out0 + s;
        P.x[t] = 0.0f; P.y[t] = 0.0f; P.sigma[t] = 0.0f; P.theta[t] = 0.0f;
        P.resp[t] = 0.0f; P.ftype[t] = 0; P.level_id[t] = 0; P.valid[t] = 0;
        return;
    }
    const int lane = threadIdx.x & 31;
    const int j = (int)blockIdx.x * kWarps + (int)(threadIdx.x >> 5);
    if (j >= P.rows) return;
    int o = 0;
    while (o + 1 < P.n_oct && P.oct[o + 1].row_start <= j) ++o;
    const OctaveArgs& oc = P.oct[o];
    const int k = (j - oc.row_start) / oc.H;
    const int r = j - oc.row_start - k * oc.H;
    const size_t at = ((size_t)b * P.NK + k) * oc.H + r;
    const int c = oc.rows[at];
    if (c == 0) return;
    const int off = oc.rows[(size_t)P.B * P.NK * oc.H + at];
    const int L = o * P.NK + k;
    const int count = lc[L];
    if (off >= count) return;
    int before = 0;
    for (int i = lane; i < L; i += 32) before += lc[i];
    before = __reduce_add_sync(kAll, before);
    // the row's first n kept cells lie below the level's count and below G
    const int n = min(min(c, count - off), P.G - before - off);
    if (n <= 0) return;
    const size_t cell0 = at * oc.W;
    const RowChunks rc(oc.valid + cell0, oc.W);
    const int slot0 = before + off;
    const float ks = P.key_sigma[k];
    const float fr = (float)r + 0.5f;
    int done = 0;   // set bytes in the chunks before this round's
    for (int c0 = 0; c0 < rc.n && done < n; c0 += 32) {
        const int ch = c0 + lane;
        const uint4 v = rc.load(ch);
        const int m = set_bytes(v);
        const int inc = warp_inclusive_sum(m, lane);
        int rank = done + inc - m;
        const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            unsigned bits = words[q];
            while (bits && rank < n) {
                const int col = 16 * ch + 4 * q + ((__ffs(bits) - 1) >> 3)
                                - rc.lead;
                bits &= bits - 1u;
                const size_t cell = cell0 + col;
                const size_t t = out0 + slot0 + rank;
                P.x[t] = (float)col + 0.5f + oc.dx[cell];
                P.y[t] = fr + oc.dy[cell];
                P.sigma[t] = ks * powf(P.sigma_step, oc.ds[cell]);
                P.theta[t] = 0.0f;
                P.resp[t] = oc.resp[cell];
                P.ftype[t] = oc.ftype[cell];
                P.level_id[t] = L;
                P.valid[t] = 1;
                ++rank;
            }
        }
        done += __shfl_sync(kAll, inc, 31);
    }
}

}  // namespace

extern "C" {

// valid (rows, W) bytes 0/1, rows = B * NK * H of one octave -> counts
// (rows,) int32: each row's set bytes, capped at kpr.
int hg_row_counts(const unsigned char* valid, int* counts, long long rows,
                  int W, int kpr, void* stream) {
    if (rows < 1 || W < 1 || kpr < 1) return (int)cudaErrorInvalidValue;
    const long long blocks = (rows + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    row_count_kernel<<<(unsigned)blocks, kRowThreads, 0,
                       (cudaStream_t)stream>>>(valid, counts, rows, W, kpr);
    return (int)cudaGetLastError();
}

// The global table from n_oct octaves whose rows hold their capped counts
// (hg_row_counts into rows[0]); writes rows[1] (the row offsets), the eight
// (B, G) fields, level_counts (B, n_oct * NK) and pre_count (B,) - two
// launches. ptrs: n_oct x 7 host pointers (valid, dx, dy, ds, response,
// ftype, rows); dims: n_oct x 3 host ints (H, W, cap). key_sigma: NK
// device floats.
int hg_feature_table(const unsigned long long* ptrs, const int* dims,
                     int n_oct, int B, int NK, int G, const float* key_sigma,
                     float sigma_step, float* x, float* y, float* sigma,
                     float* theta, float* resp, int* ftype, int* level_id,
                     unsigned char* valid, int* level_counts, int* pre_count,
                     void* stream) {
    if (n_oct < 1 || n_oct > kMaxOctaves || B < 1 || B > 65535 || NK < 1
            || NK > kMaxKeys || G < 0)
        return (int)cudaErrorInvalidValue;
    TableArgs P;
    int rows = 0;
    for (int o = 0; o < n_oct; ++o) {
        const unsigned long long* p = ptrs + (size_t)o * kPtrs;
        const int* d = dims + (size_t)o * kDims;
        OctaveArgs& oc = P.oct[o];
        oc.valid = reinterpret_cast<const unsigned char*>(p[0]);
        oc.dx = reinterpret_cast<const float*>(p[1]);
        oc.dy = reinterpret_cast<const float*>(p[2]);
        oc.ds = reinterpret_cast<const float*>(p[3]);
        oc.resp = reinterpret_cast<const float*>(p[4]);
        oc.ftype = reinterpret_cast<const int*>(p[5]);
        oc.rows = reinterpret_cast<int*>(p[6]);
        oc.H = d[0]; oc.W = d[1]; oc.cap = d[2];
        if (oc.H < 1 || oc.W < 1 || oc.cap < 0)
            return (int)cudaErrorInvalidValue;
        oc.row_start = rows;
        rows += NK * oc.H;
    }
    P.n_oct = n_oct; P.B = B; P.NK = NK; P.G = G; P.n_levels = n_oct * NK;
    P.rows = rows;
    P.key_sigma = key_sigma; P.sigma_step = sigma_step;
    P.x = x; P.y = y; P.sigma = sigma; P.theta = theta; P.resp = resp;
    P.ftype = ftype; P.level_id = level_id; P.valid = valid;
    P.level_counts = level_counts; P.pre_count = pre_count;

    cudaStream_t s = (cudaStream_t)stream;
    level_scan_kernel<<<dim3(P.n_levels, B), kScanThreads, 0, s>>>(P);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int row_blocks = (rows + kWarps - 1) / kWarps;
    const int tail_blocks = G > 0 ? (G + kRowThreads - 1) / kRowThreads : 1;
    table_scatter_kernel<<<dim3(row_blocks + tail_blocks, B), kRowThreads, 0,
                           s>>>(P, row_blocks);
    return (int)cudaGetLastError();
}

}  // extern "C"
