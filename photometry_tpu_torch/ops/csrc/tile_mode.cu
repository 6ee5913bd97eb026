// Sigma-clipped SExtractor mode of every tile of (F, H, W) float32 frames,
// for sm_90a: the tiled component of the background fit
// (ops/background._tiled_mode), in one launch for a chunk of frames.
//
// What it computes is ops/stats.sextractor_mode on the tile's pixels, as
// ops/tilemode.tile_mode_plain lays them out:
//   - a pixel is good where it is finite and its exclusion mask is False;
//     pixels past the frame's edge (a frame that does not divide into
//     tiles) are excluded, and count in the tile's size;
//   - `maxiters` times: the exact median of the good pixels, their mean and
//     standard deviation (n - 1 in the denominator), and a pixel stays good
//     where |x - median| <= sigma * std;
//   - then the median, mean and std of what is left: the mode is
//     2.5 median - 1.5 mean, or the median where (mean - median) / std >
//     0.3 or std == 0 (photutils' SExtractorBackground); NaN where no pixel
//     is left, or where fewer than `min_fraction` of the tile's pixels were
//     good to begin with.
// Every float32 operation of that rule is rounded as torch rounds it (no
// contraction into fused multiply-adds).
//
// Medians are exact: np.nanmedian of the good pixels, the mean of the two
// middle order statistics, so for the same set of good pixels the median
// is bit-equal to ops/stats.masked_median's.  The lower middle is found by
// a radix select on the pixels' order keys (the float's bits made unsigned
// and monotonic: -0.0 sorts below +0.0, as in masked_median's int32 keys),
// 8 bits a pass, 4 passes, counted in a 256-bin histogram in shared memory;
// the upper middle is the same key when enough pixels share it, else the
// smallest key above it.
//
// Mean and std are summed in float64 (the plain path sums in float32, in
// its reduction's order), then rounded to float32: the mean once, the std
// after the square root; the deviations x - mean are float32 as in the
// plain path.  So the kernel's sigma * std and the plain path's differ by
// the plain path's float32 summation error, at most (n + 2) * 2^-24 of it
// for n good pixels (recursive summation's bound; n = 4,096 for a 64 x 64
// tile gives 2.5e-4), in practice ~sqrt(n) * 2^-24.  A clip decision can
// therefore differ from the plain path's only for a pixel with
//   | |x - median| - sigma * std | <= (n + 2) * 2^-24 * sigma * std,
// and the skew rule only where (mean - median) / std lies that close to
// 0.3.  Where no pixel lies so near the cut, the surviving set is the
// plain path's and the mode agrees to the rounding of the mean.
//
// Layout: one block of 256 threads a tile, (F * th * tw) blocks, the tile's
// values in shared memory (4 bytes a pixel: 16 KB for 64 x 64), an excluded
// or clipped pixel stored as NaN.  The block reads its tile's rows straight
// from the frames (64-bit offsets: F * H * W exceeds int32 at full-CCD
// chunks) and writes one float: no (F, H, W) temporary.  The clip loop
// stops early once a pass clips nothing (the next passes would repeat it).

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int NT = 256;                 // threads a block, = histogram bins
constexpr int NW = NT / 32;
constexpr int MAX_PIXELS = 128 * 128;   // tile * tile; 64 KB of shared memory
constexpr unsigned FULL = 0xffffffffu;

struct Scratch {
    int hist[NT];
    double dred[NW];
    int ired[NW];
    unsigned ured[NW];
    int digit, krem, cnt;
};

// Unsigned order key: the float's bits, monotonic in its value.
__device__ __forceinline__ unsigned radix_key(float v)
{
    const unsigned i = __float_as_uint(v);
    return (i & 0x80000000u) ? ~i : (i | 0x80000000u);
}

__device__ __forceinline__ float from_radix_key(unsigned u)
{
    return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

__device__ __forceinline__ int block_sum(int v, Scratch& sh)
{
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    if ((threadIdx.x & 31) == 0) sh.ired[threadIdx.x >> 5] = v;
    __syncthreads();
    int t = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) t += sh.ired[w];
    __syncthreads();
    return t;
}

__device__ __forceinline__ double block_sum(double v, Scratch& sh)
{
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    if ((threadIdx.x & 31) == 0) sh.dred[threadIdx.x >> 5] = v;
    __syncthreads();
    double t = 0.0;
#pragma unroll
    for (int w = 0; w < NW; ++w) t += sh.dred[w];
    __syncthreads();
    return t;
}

__device__ __forceinline__ unsigned block_min(unsigned v, Scratch& sh)
{
    for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
    if ((threadIdx.x & 31) == 0) sh.ured[threadIdx.x >> 5] = v;
    __syncthreads();
    unsigned t = 0xffffffffu;
#pragma unroll
    for (int w = 0; w < NW; ++w) t = min(t, sh.ured[w]);
    __syncthreads();
    return t;
}

// Exact median of the n > 0 non-NaN values of s[0, npix).
__device__ float block_median(const float* s, int npix, int n, Scratch& sh)
{
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int k1 = (n + 1) / 2, k2 = n / 2 + 1;   // 1-based ranks of the middle pair
    unsigned prefix = 0, pmask = 0;
    int k = k1, cnt = 0;
    for (int shift = 24; shift >= 0; shift -= 8) {
        sh.hist[tid] = 0;
        __syncthreads();
        for (int i = tid; i < npix; i += NT) {
            const float v = s[i];
            if (v == v) {
                const unsigned u = radix_key(v);
                if ((u & pmask) == prefix) atomicAdd(&sh.hist[(u >> shift) & 255u], 1);
            }
        }
        __syncthreads();
        // Inclusive scan of the 256 bins, one a thread.
        const int h = sh.hist[tid];
        int x = h;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL, x, o);
            if (lane >= o) x += y;
        }
        if (lane == 31) sh.ired[warp] = x;
        __syncthreads();
        for (int w = 0; w < warp; ++w) x += sh.ired[w];
        if (x - h < k && k <= x) {       // exactly one bin holds rank k
            sh.digit = tid;
            sh.krem = k - (x - h);
            sh.cnt = h;
        }
        __syncthreads();
        prefix |= (unsigned)sh.digit << shift;
        pmask |= 0xffu << shift;
        k = sh.krem;
        cnt = sh.cnt;
    }
    const float v1 = from_radix_key(prefix);
    float v2 = v1;
    if ((k1 - k) + cnt < k2) {           // k1 - k keys below v1, cnt equal to it
        unsigned m = 0xffffffffu;
        for (int i = tid; i < npix; i += NT) {
            const float v = s[i];
            if (v == v) {
                const unsigned u = radix_key(v);
                if (u > prefix) m = min(m, u);
            }
        }
        v2 = from_radix_key(block_min(m, sh));
    }
    return __fmul_rn(0.5f, __fadd_rn(v1, v2));
}

struct Stats {
    int n;
    float med, mean, std;
};

__device__ Stats tile_stats(const float* s, int npix, Scratch& sh)
{
    const int tid = threadIdx.x;
    int n = 0;
    double sum = 0.0;
    for (int i = tid; i < npix; i += NT) {
        const float v = s[i];
        if (v == v) {
            ++n;
            sum += (double)v;
        }
    }
    Stats st;
    st.n = block_sum(n, sh);
    sum = block_sum(sum, sh);
    if (st.n == 0) {
        st.med = st.mean = st.std = __int_as_float(0x7fc00000);
        return st;
    }
    st.mean = (float)(sum / (double)st.n);
    double ss = 0.0;
    for (int i = tid; i < npix; i += NT) {
        const float v = s[i];
        if (v == v) {
            const double d = (double)__fsub_rn(v, st.mean);
            ss += d * d;
        }
    }
    ss = block_sum(ss, sh);
    st.std = (float)sqrt(ss / (double)max(st.n - 1, 1));
    st.med = block_median(s, npix, st.n, sh);
    return st;
}

__global__ void __launch_bounds__(NT)
tile_mode_kernel(const float* __restrict__ img, const uint8_t* __restrict__ mask,
                 float* __restrict__ out, int H, int W, int tile, int th, int tw,
                 int maxiters, float sigma, float min_fraction)
{
    extern __shared__ float s[];
    __shared__ Scratch sh;
    const int tid = threadIdx.x;
    const long long b = blockIdx.x;
    const int tx = (int)(b % tw);
    const int ty = (int)((b / tw) % th);
    const long long f = b / ((long long)tw * th);
    const size_t base = (size_t)f * (size_t)H * (size_t)W;
    const int npix = tile * tile;
    const float nan = __int_as_float(0x7fc00000);

    int good0 = 0;
    for (int i = tid; i < npix; i += NT) {
        const int r = i / tile, c = i - r * tile;
        const int y = ty * tile + r, x = tx * tile + c;
        float v = nan;
        if (y < H && x < W) {
            const size_t o = base + (size_t)y * W + x;
            const float p = img[o];
            if (isfinite(p) && !mask[o]) {
                v = p;
                ++good0;
            }
        }
        s[i] = v;
    }
    good0 = block_sum(good0, sh);     // syncs: s is complete

    Stats st = tile_stats(s, npix, sh);
    for (int it = 0; it < maxiters && st.n > 0; ++it) {
        const float thr = __fmul_rn(sigma, st.std);
        int clipped = 0;
        for (int i = tid; i < npix; i += NT) {
            const float v = s[i];
            if (v == v && !(fabsf(__fsub_rn(v, st.med)) <= thr)) {
                s[i] = nan;
                clipped = 1;
            }
        }
        if (!__syncthreads_or(clipped)) break;
        st = tile_stats(s, npix, sh);
    }

    if (tid == 0) {
        float res = nan;
        const float frac0 = __fdiv_rn((float)good0, (float)npix);
        if (st.n > 0 && frac0 >= min_fraction) {
            res = __fsub_rn(__fmul_rn(2.5f, st.med), __fmul_rn(1.5f, st.mean));
            const float skew = __fdiv_rn(fabsf(__fsub_rn(st.mean, st.med)), fmaxf(st.std, 1e-30f));
            if (skew > 0.3f || st.std == 0.0f) res = st.med;
        }
        out[b] = res;
    }
}

}  // namespace

extern "C" int tile_mode_max_pixels() { return MAX_PIXELS; }

// img: (F, H, W) float32, mask: (F, H, W) bool (one byte, True = excluded),
// out: (F, ceil(H / tile), ceil(W / tile)) float32; all contiguous.
extern "C" int tile_mode(const void* img, const void* mask, void* out, int F, int H, int W,
                         int tile, int maxiters, float sigma, float min_fraction, void* stream)
{
    if (F < 0 || H < 1 || W < 1 || tile < 1 || (long long)tile * tile > MAX_PIXELS || maxiters < 0)
        return (int)cudaErrorInvalidValue;
    const int th = (H + tile - 1) / tile, tw = (W + tile - 1) / tile;
    const long long blocks = (long long)F * th * tw;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    if (blocks == 0) return 0;
    const int smem = tile * tile * (int)sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(tile_mode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    tile_mode_kernel<<<(unsigned)blocks, NT, smem, (cudaStream_t)stream>>>(
        (const float*)img, (const uint8_t*)mask, (float*)out, H, W, tile, th, tw, maxiters,
        sigma, min_fraction);
    return (int)cudaGetLastError();
}
