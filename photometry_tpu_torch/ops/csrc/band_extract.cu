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
// Why not the TPU's layout.  The TPU kernel streams whole 64x128 cells
// and contracts them against dense (M, 8192) piece patches on the MXU,
// because there a scattered 17-px read moves whole 4 KB (8, 128) tiles.
// On Hopper a 17-float row is three 32-byte sectors, so each target reads
// its own window directly.  The dense cell form would do M*8192
// multiply-adds per cell and cadence (~14 TFLOP for a full CCD at
// N=10,240, T=1312), ~96% of them against zeros.  Hence no counterpart of
// the piece decomposition (build_piece_patches, _patches_device): a
// target is never split into pieces, and nothing is contracted.
//
// What bounds it.  Device-memory bytes: at most N*T*h_win*w_win*13 B
// (f32 image, err, background + u8 flags) over each target's window (the
// bounding box of mask | window); image/err/background are read only
// where the mask is set, flags only where the window is.  Arithmetic is a
// few flops per byte, far below the card's ridge point.
//
// Design.  One block per (target, block of TB cadences).  The block stages
// the target's mask|window bytes in shared memory once, then each warp
// reduces one cadence at a time: lanes stride the flattened window, each
// lane keeps 10 partial sums in registers, a warp-shuffle tree adds them,
// and lane 0 writes the 10 outputs.  Stamps too large for shared memory
// read the mask bytes from global memory instead (same arithmetic).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 10;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTimeBlock = 64;          // cadences per block
constexpr uint8_t kShenanigans = 4;     // PixelQualityFlags.BackgroundShenanigans
// Largest stamp (h * w mask bytes) staged in shared memory; larger stamps
// read their mask bytes from global memory.
constexpr size_t kMaxStagedBytes = 200 * 1024;

template <bool kStage>
__global__ void __launch_bounds__(kThreads)
band_extract_kernel(const float* __restrict__ img, const float* __restrict__ err,
                    const float* __restrict__ bkg, const uint8_t* __restrict__ flags,
                    const uint8_t* __restrict__ mw,      // (N, h, w): bit0 mask, bit1 window
                    const int32_t* __restrict__ r0s, const int32_t* __restrict__ c0s,
                    const int32_t* __restrict__ bbox,    // (N, 4): i_lo, i_hi, j_lo, j_hi (excl.)
                    float* __restrict__ out,             // (N, kQ, T)
                    int T, int H, int W, int h, int w) {
  extern __shared__ uint8_t smem[];
  const int n = blockIdx.x;
  const int t_begin = blockIdx.y * kTimeBlock;
  const int t_end = min(t_begin + kTimeBlock, T);
  const uint8_t* mw_n = mw + (size_t)n * h * w;

  const uint8_t* m_src = mw_n;
  if (kStage) {
    for (int k = threadIdx.x; k < h * w; k += kThreads) smem[k] = mw_n[k];
    __syncthreads();
    m_src = smem;
  }

  const int i_lo = bbox[4 * n + 0], i_hi = bbox[4 * n + 1];
  const int j_lo = bbox[4 * n + 2], j_hi = bbox[4 * n + 3];
  const int bw = j_hi - j_lo;
  const int area = max(i_hi - i_lo, 0) * max(bw, 0);
  const int r0 = r0s[n], c0 = c0s[n];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t plane = (size_t)H * W;

  for (int t = t_begin + warp; t < t_end; t += kWarps) {
    float s[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) s[q] = 0.f;
    const size_t base = (size_t)t * plane;
    for (int p = lane; p < area; p += 32) {
      const int i = i_lo + p / bw;
      const int j = j_lo + p % bw;
      const uint8_t m = m_src[i * w + j];
      if (!m) continue;
      const size_t off = base + (size_t)(r0 + i) * W + (c0 + j);
      if (m & 1) {
        const float x = img[off];
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
        const float e = err[off];
        if (isfinite(e)) s[6] += e * e;
        const float b = bkg[off];
        if (isfinite(b)) {
          s[7] += b;
          s[8] += 1.f;
        }
      }
      if ((m & 2) && (flags[off] & kShenanigans)) s[9] += 1.f;
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) s[q] += __shfl_down_sync(0xffffffffu, s[q], d);
    }
    if (lane == 0) {
      float* o = out + (size_t)n * kQ * T + t;
#pragma unroll
      for (int q = 0; q < kQ; ++q) o[(size_t)q * T] = s[q];
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
int band_extract_sums(const float* img, const float* err, const float* bkg,
                      const uint8_t* flags, const uint8_t* mw, const int32_t* r0s,
                      const int32_t* c0s, const int32_t* bbox, float* out, int N, int T,
                      int H, int W, int h, int w, void* stream) {
  if (N == 0 || T == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)N, (unsigned)((T + kTimeBlock - 1) / kTimeBlock));
  const size_t smem = (size_t)h * w;
  cudaStream_t s = (cudaStream_t)stream;
  if (smem <= kMaxStagedBytes) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(band_extract_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    band_extract_kernel<true><<<grid, kThreads, smem, s>>>(
        img, err, bkg, flags, mw, r0s, c0s, bbox, out, T, H, W, h, w);
  } else {
    band_extract_kernel<false><<<grid, kThreads, 0, s>>>(
        img, err, bkg, flags, mw, r0s, c0s, bbox, out, T, H, W, h, w);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
