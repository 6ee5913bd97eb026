// Flux-only stamp extraction: the masked sum of the finite cube values under
// each target's stamp mask, per cadence, for sm_90a.
//
// Replaces the TPU's Pallas kernel tools/pallas_extract_demo.py:51
// (_pallas_extract_padded, public entry pallas_extract_flux :134), which
// computes, for target n with corner (r0, c0) and mask (h, w), and cadence t:
//
//     out[n, t] = sum of img[t, r0+i, c0+j] over mask[n, i, j] with
//                 r0+i < H, c0+j < W and img finite;  NaN if that set is empty
//
// (±inf counts as missing, as NaN does).  The TPU kernel streams padded
// windows, corners snapped down to (8, 128) tiles, by double-buffered DMAs
// in groups of 8 targets x 8 cadences, and shifts each mask into its window;
// that shift drops exactly the mask pixels that fall off the image.  All of
// that exists for Mosaic's DMA tiling and has no counterpart here: the
// kernel reads each in-mask pixel of the image directly.
//
// What bounds it.  Device-memory bytes: each in-mask, in-image pixel read
// once per cadence (4 B), the masks and corners once, the (N, T) float32
// output once.  The reads land in the window rows the mask touches: a
// 17-px row is at most three 32-byte sectors, so the bytes actually moved
// are up to ~2x the in-mask bytes for sparse masks.  Arithmetic is one add
// per byte read, far below the ridge point.
//
// Design.  One block per (target, block of kTimeBlock cadences).  The block
// first compacts its target's mask into shared memory: the row-major list
// of the in-mask, in-image pixels' offsets from the corner, built with warp
// ballots and a scan over the warps' counts, so the order (and with it the
// float sum) is the same on every run.  Then each warp takes one cadence at
// a time: its lanes stride the list (neighbouring lanes read neighbouring
// pixels of a row), each keeps a float sum and a finite count in
// registers, a shuffle tree adds them, and lane 0 writes out[n, t].  A
// warp per cadence needs no reduction across warps.  Masks larger than the
// shared memory of one block are refused by the wrapper (KernelError).
// A later version may stream the window rows with cp.async or TMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTimeBlock = 64;          // cadences per block

__global__ void __launch_bounds__(kThreads)
stamp_flux_kernel(const float* __restrict__ img, const uint8_t* __restrict__ masks,
                  const int32_t* __restrict__ r0s, const int32_t* __restrict__ c0s,
                  float* __restrict__ out, int T, int H, int W, int h, int w)
{
  extern __shared__ int32_t offs[];     // up to h * w offsets from the corner
  __shared__ int warp_count[kWarps];
  const int n = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = r0s[n], c0 = c0s[n];
  const int hw = h * w;
  const uint8_t* m = masks + (size_t)n * hw;

  int count = 0;
  for (int p0 = 0; p0 < hw; p0 += kThreads) {
    const int p = p0 + threadIdx.x;
    bool keep = false;
    int off = 0;
    if (p < hw) {
      const int i = p / w, j = p - (p / w) * w;
      keep = m[p] != 0 && r0 + i < H && c0 + j < W;
      off = i * W + j;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = count, total = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int c = warp_count[k];
      before += k < warp ? c : 0;
      total += c;
    }
    if (keep) offs[before + __popc(ballot & ((1u << lane) - 1u))] = off;
    count += total;
    __syncthreads();                    // warp_count is rewritten next round
  }

  const int t_begin = blockIdx.y * kTimeBlock;
  const int t_end = min(t_begin + kTimeBlock, T);
  const size_t plane = (size_t)H * W;
  const float* corner = img + (size_t)r0 * W + c0;
  for (int t = t_begin + warp; t < t_end; t += kWarps) {
    const float* base = corner + (size_t)t * plane;
    float s = 0.f;
    int nfin = 0;
    for (int k = lane; k < count; k += 32) {
      const float x = __ldg(base + offs[k]);
      if (isfinite(x)) {
        s += x;
        ++nfin;
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, d);
      nfin += __shfl_down_sync(0xffffffffu, nfin, d);
    }
    if (lane == 0) out[(size_t)n * T + t] = nfin > 0 ? s : __int_as_float(0x7fc00000);
  }
}

}  // namespace

extern "C" {

// The largest h * w one block's shared memory holds on the current device.
int stamp_flux_max_pixels()
{
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)
      != cudaSuccess) return 0;
  return (bytes - (int)(kWarps * sizeof(int))) / (int)sizeof(int32_t);
}

// img (T, H, W) float32; masks (N, h, w) uint8/bool; r0s, c0s (N,) int32
// corners (>= 0); out (N, T) float32.  Launch on `stream`; returns
// cudaGetLastError() (0 = launched).
int stamp_flux(const float* img, const uint8_t* masks, const int32_t* r0s, const int32_t* c0s,
               float* out, int N, int T, int H, int W, int h, int w, void* stream)
{
  if (N == 0 || T == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)h * w * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(stamp_flux_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)N, (unsigned)((T + kTimeBlock - 1) / kTimeBlock));
  stamp_flux_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      img, masks, r0s, c0s, out, T, H, W, h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
