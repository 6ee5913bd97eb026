// Exact 15x15 median filter of (F, H, W) float32 frames, for sm_90a.
//
// Replaces the TPU's Pallas kernel photometry_tpu/ops/median_pallas.py:62
// (_kernel, launched by _median15_padded), and computes what the prepare
// stage's production path photometry_tpu/ops/filters.py:_median_block
// computes: the 113th smallest of the 225 samples around every pixel, with
// scipy 'reflect' borders (numpy 'symmetric': the edge sample repeats), on
// NaN-free input (callers nan_to_num first).
//
// Selection is the JAX path's: float32 values map monotonically onto int32
// order keys (sign bit kept, the other 31 bits flipped for negatives), and
// an 8-ary bisection of the key interval (seven probes per pass, the
// overflow-safe floor average (a & b) + ((a ^ b) >> 1)) isolates the key of
// the order statistic exactly, whatever the value range: a 3.4e38 pixel
// (nan_to_num of +inf) cannot stall it.  The result is bit-identical to the
// JAX filter's.
//
// Layout: a block owns a 32 x 8 tile of outputs of one frame and stages the
// (8 + 14) x (32 + 14) halo in shared memory as order keys, reflecting the
// indices at the frame edges itself (periodic with period 2n, so frames
// narrower than the 7-pixel halo fold again).  Each thread keeps its lo/hi
// bounds and seven counters in registers and reads its 225 keys from shared
// memory once per pass, conflict-free (a warp reads 32 neighbouring keys of
// one row).  A thread stops when its interval holds a single key, which
// the fixed 12 passes of the JAX path reach with the same probes, so the
// answer is the same.  The 225-deep stack never exists in device memory.
//
// Bound: by bytes the frame is read once and written once (33.6 MB per
// 2048 x 2048 frame, ~10 us at 3.35 TB/s); as written the selection costs
// up to 12 passes x 225 x 7 compare-and-adds per pixel, which is what
// limits it on the card.  Offsets are 64-bit: F * H * W exceeds int32 at
// full-CCD chunks.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int K = 15;
constexpr int HALF = K / 2;
constexpr int TX = 32;
constexpr int TY = 8;
constexpr int SW = TX + 2 * HALF;   // 46
constexpr int SH = TY + 2 * HALF;   // 22
constexpr int TARGET = K * K / 2 + 1;
constexpr int MAX_PASSES = 12;

__device__ __forceinline__ int reflect(int i, int n)
{
    const int p = 2 * n;
    i %= p;
    if (i < 0) i += p;
    return i < n ? i : p - 1 - i;
}

__device__ __forceinline__ int ordkey(float x)
{
    const int i = __float_as_int(x);
    return i < 0 ? (i ^ 0x7fffffff) : i;
}

__device__ __forceinline__ float from_ordkey(int k)
{
    return __int_as_float(k < 0 ? (k ^ 0x7fffffff) : k);
}

__device__ __forceinline__ int avg_floor(int a, int b)
{
    return (a & b) + ((a ^ b) >> 1);
}

__global__ void __launch_bounds__(TX * TY)
median15_kernel(const float* __restrict__ in, float* __restrict__ out, int H, int W)
{
    __shared__ int tile[SH][SW];
    const long long plane = (long long)H * W;
    const float* src = in + (long long)blockIdx.z * plane;
    const int x0 = blockIdx.x * TX;
    const int y0 = blockIdx.y * TY;
    for (int j = threadIdx.y * TX + threadIdx.x; j < SH * SW; j += TX * TY) {
        const int ty = j / SW, tx = j % SW;
        const int gy = reflect(y0 + ty - HALF, H);
        const int gx = reflect(x0 + tx - HALF, W);
        tile[ty][tx] = ordkey(src[(long long)gy * W + gx]);
    }
    __syncthreads();
    const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
    if (x >= W || y >= H) return;

    int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
            const int v = tile[threadIdx.y + dy][threadIdx.x + dx];
            lo = min(lo, v);
            hi = max(hi, v);
        }
    }
    lo -= 1;   // count(<= lo) == 0 < TARGET <= count(<= hi); the -inf key is > INT_MIN
    for (int pass = 0; pass < MAX_PASSES; ++pass) {
        if ((unsigned)hi - (unsigned)lo <= 1u) break;   // (lo, hi] holds one key: hi
        const int m4 = avg_floor(lo, hi);
        const int m2 = avg_floor(lo, m4), m6 = avg_floor(m4, hi);
        const int m1 = avg_floor(lo, m2), m3 = avg_floor(m2, m4);
        const int m5 = avg_floor(m4, m6), m7 = avg_floor(m6, hi);
        int c1 = 0, c2 = 0, c3 = 0, c4 = 0, c5 = 0, c6 = 0, c7 = 0;
#pragma unroll
        for (int dy = 0; dy < K; ++dy) {
#pragma unroll
            for (int dx = 0; dx < K; ++dx) {
                const int v = tile[threadIdx.y + dy][threadIdx.x + dx];
                c1 += v <= m1; c2 += v <= m2; c3 += v <= m3; c4 += v <= m4;
                c5 += v <= m5; c6 += v <= m6; c7 += v <= m7;
            }
        }
        // hi: the smallest probe whose count reaches TARGET; lo: the largest below.
        int nhi = hi, nlo = lo;
        if (c7 >= TARGET) nhi = m7; else nlo = m7;
        if (c6 >= TARGET) nhi = m6; else if (m6 > nlo) nlo = m6;
        if (c5 >= TARGET) nhi = m5; else if (m5 > nlo) nlo = m5;
        if (c4 >= TARGET) nhi = m4; else if (m4 > nlo) nlo = m4;
        if (c3 >= TARGET) nhi = m3; else if (m3 > nlo) nlo = m3;
        if (c2 >= TARGET) nhi = m2; else if (m2 > nlo) nlo = m2;
        if (c1 >= TARGET) nhi = m1; else if (m1 > nlo) nlo = m1;
        lo = nlo;
        hi = nhi;
    }
    out[(long long)blockIdx.z * plane + (long long)y * W + x] = from_ordkey(hi);
}

}  // namespace

// in, out: (F, H, W) float32, contiguous.  Returns 0 or the CUDA error.
extern "C" int median15(const void* in, void* out, int F, int H, int W, void* stream)
{
    const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, F);
    median15_kernel<<<grid, dim3(TX, TY), 0, (cudaStream_t)stream>>>(
        (const float*)in, (float*)out, H, W);
    return (int)cudaGetLastError();
}
