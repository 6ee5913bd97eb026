// Banded aperture extraction: 10 masked sums per (target, cadence).
//
// Replaces photometry_tpu/ops/bandext.py:_band_kernel (the Pallas/MXU
// kernel) and feeds the same epilogue, photometry_tpu_torch/ops/bandext.py
// :_combine (port of bandext.py:_combine).
//
// What it computes.  For target n with stamp corner (r0[n], c0[n]) and
// cadence t, over the pixels (i, j) of its h x w stamp:
//   q0 flux sum      sum   x             mask & finite(x)
//   q1 finite count  count               mask & finite(x)
//   q2 zero count    count               mask & x == 0
//   q3 wsum          sum   x             mask & finite(x) & x > 0
//   q4 col moment    sum   x * j         (same pixels as q3)
//   q5 row moment    sum   x * i         (same pixels as q3)
//   q6 err^2         sum   e * e         mask & finite(e)
//   q7 bkg sum       sum   b             mask & finite(b)
//   q8 bkg count     count               mask & finite(b)
//   q9 shenanigans   count               window & (flag & 4)
// written to out[n, q, t] (float32; counts are exact up to 2^24).
//
// Element types.  The three value planes are float32 or bfloat16, all
// three of one type (the kernel is a template on it; the flag plane is
// uint8 in both).  A bfloat16 element is widened to float32 as it is
// loaded (__bfloat162float: exact, NaN, inf, subnormals and -0 kept), and
// every sum runs in float32, as the TPU kernel upcasts each block before
// it reduces (photometry_tpu/ops/bandext.py:286-294).  The pixels and the
// order of the sums are those of the float32 kernel, so a bfloat16 cube
// gives the float32 kernel's bits on the cube widened to float32.
//
// Why not the TPU's layout.  The TPU kernel streams whole 64x128 cells
// and contracts them against dense (M, 8192) piece patches on the MXU,
// because there a scattered 17-px read moves whole 4 KB (8, 128) tiles.
// On Hopper a 17-float row is three 32-byte sectors, so each target reads
// its own pixels directly.  The dense cell form would do M*8192
// multiply-adds per cell and cadence (~14 TFLOP for a full CCD at
// N=10,240, T=1312), ~96% of them against zeros.  Hence no counterpart of
// the piece decomposition (build_piece_patches, _patches_device): a
// target is never split into pieces, and nothing is contracted.
//
// What bounds it.  Device-memory bytes: per target and cadence, 12 bytes
// (f32 image, err, background; 6 in bfloat16) at each mask pixel and the
// flag byte at each window pixel; the card reads whole 32-byte sectors, so the least it
// can move is the sectors those pixels touch.  Arithmetic is a few flops
// per byte, far below the card's ridge point.
//
// Design.  One block per (target, block of 32 cadences), 8 warps.  The
// block compacts the target's bounding box (the nonzero bytes of mask |
// window) into two lists in shared memory, its mask pixels and its
// window-only pixels, each row-major and each entry packing (i << 16) | j
// with the window bit on top; boxes beyond 2,048 pixels go in chunks of
// 2,048.  Each warp then takes one cadence at a time: its lanes stride the
// lists (two entries unrolled, so their loads issue together), a shuffle
// tree reduces the 10 sums, and lane 0 adds them into the block's results
// in shared memory, which leave as coalesced out[n, q, t0:t0+32] rows.  The
// first design (lanes striding the whole bounding box, skipping its empty
// pixels) read the same sectors but walked the mostly empty boxes of the
// main path's 49 x 49 stamps.  On an H100 the time follows the sectors
// read: four cadences a warp with all their loads issued first and a
// halving exchange for the reduction (127 registers) were slower than this
// (60 registers, 4 blocks an SM).  The order of every sum is fixed by the
// lists and the chunks: the same inputs give the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 10;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTimeBlock = 32;                // cadences a block
constexpr int kPer = 8;                      // box pixels a thread compacts per chunk
constexpr int kChunk = kThreads * kPer;      // 2,048
constexpr uint8_t kShenanigans = 4;          // PixelQualityFlags.BackgroundShenanigans
constexpr uint32_t kWinBit = 1u << 31;

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane)
{
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// One element of a value plane, widened to float32.
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }

template <typename V>
__global__ void __launch_bounds__(kThreads)
band_extract_kernel(const V* __restrict__ img, const V* __restrict__ err,
                    const V* __restrict__ bkg, const uint8_t* __restrict__ flags,
                    const uint8_t* __restrict__ mw,      // (N, h, w): bit0 mask, bit1 window
                    const int32_t* __restrict__ r0s, const int32_t* __restrict__ c0s,
                    const int32_t* __restrict__ bbox,    // (N, 4): i_lo, i_hi, j_lo, j_hi (excl.)
                    float* __restrict__ out,             // (N, kQ, T)
                    int T, int H, int W, int h, int w) {
  __shared__ uint32_t mlist[kChunk];
  __shared__ uint32_t wlist[kChunk];
  __shared__ int wsum[2][kWarps];
  __shared__ float res[kQ][kTimeBlock];
  const int n = blockIdx.x;
  const int t_begin = blockIdx.y * kTimeBlock;
  const int t_end = min(t_begin + kTimeBlock, T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint8_t* mw_n = mw + (size_t)n * h * w;
  const int i_lo = bbox[4 * n + 0], i_hi = bbox[4 * n + 1];
  const int j_lo = bbox[4 * n + 2], j_hi = bbox[4 * n + 3];
  const int r0 = r0s[n], c0 = c0s[n];
  const bool inside = r0 >= 0 && c0 >= 0 && r0 <= H - h && c0 <= W - w;  // else the wrapper raises
  const int bw = max(j_hi - j_lo, 1);
  const int area = inside ? max(i_hi - i_lo, 0) * max(j_hi - j_lo, 0) : 0;
  const size_t plane = (size_t)H * W;
  const size_t corner = inside ? (size_t)r0 * W + c0 : 0;
  const int nt = t_end - t_begin;
  // res sums each cadence's chunks in chunk order; zeroed before the
  // first barrier below (or the last, for an empty box).
  for (int k = threadIdx.x; k < kQ * kTimeBlock; k += kThreads) {
    res[k / kTimeBlock][k % kTimeBlock] = 0.f;
  }
  for (int chunk = 0; chunk < area; chunk += kChunk) {
    // Compact this chunk of the box: thread k takes its pixels k*8 .. k*8+7.
    uint32_t ent[kPer];
    uint8_t code[kPer];
    int nm = 0, nw = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int p = chunk + threadIdx.x * kPer + k;
      const int i = i_lo + p / bw, j = j_lo + p % bw;
      code[k] = p < area ? mw_n[(size_t)i * w + j] : (uint8_t)0;
      ent[k] = ((uint32_t)i << 16) | (uint32_t)j | ((code[k] & 2) ? kWinBit : 0u);
      nm += code[k] & 1;
      nw += code[k] == 2;
    }
    const int im = warp_inclusive_scan(nm, lane), iw = warp_inclusive_scan(nw, lane);
    if (lane == 31) { wsum[0][warp] = im; wsum[1][warp] = iw; }
    __syncthreads();
    int om = im - nm, ow = iw - nw, n_mask = 0, n_win = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      om += v < warp ? wsum[0][v] : 0;
      ow += v < warp ? wsum[1][v] : 0;
      n_mask += wsum[0][v];
      n_win += wsum[1][v];
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (code[k] & 1) mlist[om++] = ent[k];
      else if (code[k] == 2) wlist[ow++] = ent[k];
    }
    __syncthreads();

    for (int tt = warp; tt < nt; tt += kWarps) {
      const size_t base = (size_t)(t_begin + tt) * plane + corner;
      float s[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) s[q] = 0.f;
#pragma unroll 2
      for (int e = lane; e < n_mask; e += 32) {
        const uint32_t en = mlist[e];
        const int i = (en >> 16) & 0x7fff, j = en & 0xffff;
        const size_t p = base + (size_t)i * W + j;
        const float x = load(img + p), er = load(err + p), b = load(bkg + p);
        const uint8_t f = (en & kWinBit) ? __ldg(flags + p) : (uint8_t)0;
        if (isfinite(x)) {
          s[0] += x;
          s[1] += 1.f;
          if (x > 0.f) {
            s[3] += x;
            s[4] += x * (float)j;
            s[5] += x * (float)i;
          }
        }
        if (x == 0.f) s[2] += 1.f;
        if (isfinite(er)) s[6] += er * er;
        if (isfinite(b)) {
          s[7] += b;
          s[8] += 1.f;
        }
        if (f & kShenanigans) s[9] += 1.f;
      }
#pragma unroll 4
      for (int e = lane; e < n_win; e += 32) {
        const uint32_t en = wlist[e];
        const size_t p = base + (size_t)((en >> 16) & 0x7fff) * W + (en & 0xffff);
        if (__ldg(flags + p) & kShenanigans) s[9] += 1.f;
      }
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) s[q] += __shfl_down_sync(0xffffffffu, s[q], d);
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < kQ; ++q) res[q][tt] += s[q];
      }
    }
    __syncthreads();   // the lists are rewritten by the next chunk
  }

  __syncthreads();
  float* o = out + (size_t)n * kQ * T + t_begin;
  for (int k = threadIdx.x; k < kQ * kTimeBlock; k += kThreads) {
    const int q = k / kTimeBlock, tt = k % kTimeBlock;
    if (tt < nt) o[(size_t)q * T + tt] = res[q][tt];
  }
}

template <typename V>
int launch(const V* img, const V* err, const V* bkg, const uint8_t* flags, const uint8_t* mw,
           const int32_t* r0s, const int32_t* c0s, const int32_t* bbox, float* out, int N,
           int T, int H, int W, int h, int w, void* stream) {
  if (N == 0 || T == 0) return (int)cudaSuccess;
  if (h > 0x7fff || w > 0xffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)N, (unsigned)((T + kTimeBlock - 1) / kTimeBlock));
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;     // T > 2,097,120
  band_extract_kernel<V><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      img, err, bkg, flags, mw, r0s, c0s, bbox, out, T, H, W, h, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for stamps taller than 32,767 or wider than 65,535
// pixels (the packed entries) or more than 2,097,120 cadences (the grid's
// y extent).  The value planes are float32 here, bfloat16 in the _bf16
// entry point; the arguments are otherwise the same.
int band_extract_sums(const float* img, const float* err, const float* bkg,
                      const uint8_t* flags, const uint8_t* mw, const int32_t* r0s,
                      const int32_t* c0s, const int32_t* bbox, float* out, int N, int T,
                      int H, int W, int h, int w, void* stream) {
  return launch(img, err, bkg, flags, mw, r0s, c0s, bbox, out, N, T, H, W, h, w, stream);
}

int band_extract_sums_bf16(const __nv_bfloat16* img, const __nv_bfloat16* err,
                           const __nv_bfloat16* bkg, const uint8_t* flags, const uint8_t* mw,
                           const int32_t* r0s, const int32_t* c0s, const int32_t* bbox,
                           float* out, int N, int T, int H, int W, int h, int w, void* stream) {
  return launch(img, err, bkg, flags, mw, r0s, c0s, bbox, out, N, T, H, W, h, w, stream);
}

}  // extern "C"
