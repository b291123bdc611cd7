// Separable Gaussian blur, whole-octave Gaussian chain and by-2 decimation
// for Hopper (sm_90a). Plain C interface, loaded with ctypes
// (hessgpu_tpu_torch/ops/cuda/conv.py).
//
// Replaces three TPU kernels of hessgpu_tpu/ops/pallas/conv.py:
//   hg_blur          <- blur_pallas
//   hg_octave_chain  <- octave_chain_pallas
//   hg_downsample2   <- downsample2_pallas
//
// What bounds them on this card: bytes. A 13..21-tap separable filter does
// 2*taps multiply-adds per pixel against 8 bytes moved per pixel, far under
// the card's float32 rate, and decimation does no arithmetic at all. So each
// kernel reads every input pixel from device memory once (plus a halo) and
// writes every output pixel once: a block stages its tile plus the halo in
// shared memory with the index clamped to the image (no edge-padded copy in
// device memory), runs the horizontal pass into a second shared tile and the
// vertical pass out of it. The chain is L-1 launches of the blur kernel that
// read level l and write level l+1 in place in the (B, L, H, W) stack, so it
// moves 2 planes per level where one fused launch would move 1; each level
// takes its halo from the clamped level below it, which is exactly chained
// blur. Decimation reads the source plane through its batch/row strides, so
// a plane of the level stack is decimated in place.
//
// Arithmetic: each pass is acc = t[0]*x[0]; acc = acc + t[k]*x[k], left to
// right, compiled with -fmad=false, so results equal the plain PyTorch
// version (ops/gaussian.py) bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 33;   // params.KERNEL_MAX_WIDTH
constexpr int kMaxR = kMaxTaps / 2;
constexpr int kTW = 64;        // output tile
constexpr int kTH = 32;
constexpr int kThreads = 256;

struct Taps {
    float t[kMaxTaps];
    int n;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}

// One separable blur of B planes. Plane b starts at in + b*in_bs (rows are W
// apart) and is written to out + b*out_bs.
__global__ void __launch_bounds__(kThreads)
blur_kernel(const float* __restrict__ in, float* __restrict__ out,
            long long in_bs, long long out_bs, int H, int W, Taps taps) {
    __shared__ float s_in[(kTH + 2 * kMaxR) * (kTW + 2 * kMaxR)];
    __shared__ float s_h[(kTH + 2 * kMaxR) * kTW];

    const int r = taps.n / 2;
    const int iw = kTW + 2 * r;
    const int ih = kTH + 2 * r;
    const int col0 = blockIdx.x * kTW;
    const int row0 = blockIdx.y * kTH;
    const float* src = in + (long long)blockIdx.z * in_bs;
    float* dst = out + (long long)blockIdx.z * out_bs;

    // tile + halo, index clamped to the image (clamp-to-edge borders)
    for (int i = threadIdx.x; i < ih * iw; i += kThreads) {
        const int ty = i / iw, tx = i - ty * iw;
        const int gy = clampi(row0 + ty - r, 0, H - 1);
        const int gx = clampi(col0 + tx - r, 0, W - 1);
        s_in[i] = src[(long long)gy * W + gx];
    }
    __syncthreads();

    // horizontal pass over all ih rows (the vertical pass needs the halo
    // rows; a clamped row's horizontal result is the edge row's)
    for (int i = threadIdx.x; i < ih * kTW; i += kThreads) {
        const int ty = i / kTW, tx = i - ty * kTW;
        const float* p = s_in + ty * iw + tx;
        float acc = taps.t[0] * p[0];
        for (int k = 1; k < taps.n; ++k) acc = acc + taps.t[k] * p[k];
        s_h[i] = acc;
    }
    __syncthreads();

    // vertical pass
    for (int i = threadIdx.x; i < kTH * kTW; i += kThreads) {
        const int ty = i / kTW, tx = i - ty * kTW;
        const int gy = row0 + ty, gx = col0 + tx;
        if (gy < H && gx < W) {
            const float* p = s_h + ty * kTW + tx;
            float acc = taps.t[0] * p[0];
            for (int k = 1; k < taps.n; ++k) acc = acc + taps.t[k] * p[k * kTW];
            dst[(long long)gy * W + gx] = acc;
        }
    }
}

// Copies B planes of n floats between two strided stacks.
__global__ void copy_planes_kernel(const float* __restrict__ in,
                                   float* __restrict__ out, long long in_bs,
                                   long long out_bs, long long n) {
    const float* src = in + (long long)blockIdx.y * in_bs;
    float* dst = out + (long long)blockIdx.y * out_bs;
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += step)
        dst[i] = src[i];
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

void launch_blur(const float* in, float* out, long long in_bs, long long out_bs,
                 int B, int H, int W, const Taps& taps, cudaStream_t s) {
    dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
    blur_kernel<<<grid, kThreads, 0, s>>>(in, out, in_bs, out_bs, H, W, taps);
}

void launch_copy(const float* in, float* out, long long in_bs, long long out_bs,
                 int B, long long n, cudaStream_t s) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 1024) blocks = 1024;
    copy_planes_kernel<<<dim3((unsigned)blocks, B), threads, 0, s>>>(
        in, out, in_bs, out_bs, n);
}

}  // namespace

extern "C" {

const char* hg_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// (B, H, W) -> (B, H, W), both contiguous. taps: n host floats, n odd <= 33.
int hg_blur(const float* in, float* out, int B, int H, int W,
            const float* taps, int n, void* stream) {
    Taps t;
    if (!make_taps(taps, n, &t) || B < 1 || B > 65535 || H < 1 || W < 1)
        return (int)cudaErrorInvalidValue;
    const long long hw = (long long)H * W;
    launch_blur(in, out, hw, hw, B, H, W, t, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

// base (B, H, W) -> out (B, L, H, W): out[:, 0] = base,
// out[:, l+1] = blur(out[:, l], taps of transition l). taps: (L-1) rows of 33
// host floats; ntaps[l] = width of row l, 0 = identity.
int hg_octave_chain(const float* base, float* out, int B, int L, int H, int W,
                    const float* taps, const int* ntaps, void* stream) {
    if (B < 1 || B > 65535 || L < 1 || H < 1 || W < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const long long hw = (long long)H * W;
    const long long stack = hw * L;
    launch_copy(base, out, hw, stack, B, hw, s);
    for (int l = 0; l + 1 < L; ++l) {
        const float* src = out + l * hw;
        float* dst = out + (l + 1) * hw;
        if (ntaps[l] == 0) {
            launch_copy(src, dst, stack, stack, B, hw, s);
            continue;
        }
        Taps t;
        if (!make_taps(taps + l * kMaxTaps, ntaps[l], &t))
            return (int)cudaErrorInvalidValue;
        launch_blur(src, dst, stack, stack, B, H, W, t, s);
    }
    return (int)cudaGetLastError();
}

// Decimation by 2 keeping even rows/cols: in is B planes of (h, w) with
// element strides in_bs (batch) and in_rs (row), unit column stride; out is
// (B, ceil(h/2), ceil(w/2)) contiguous.
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
