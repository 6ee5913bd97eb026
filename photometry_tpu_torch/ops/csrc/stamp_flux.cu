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
// kernel reads the in-mask pixels of the image directly.
//
// What bounds it.  Device-memory bytes, and not the in-mask bytes alone: a
// ~63-pixel mask spans ~9 rows of ~7 pixels, each row a run of one or two
// 32-byte sectors, and the card fetches from device memory in 64-byte
// segments (a knockout that also read each sector's 64-byte partner took
// no longer).  chip_smoke.py's phase 2d prints the three bounds at the
// photometry cube's shape: the in-mask bytes, the 32-byte sectors and the
// 64-byte segments under them, each counted once however many windows
// share it.  Arithmetic is one add per pixel read.
//
// Design (PERF.md section 6 has the knockouts behind each step and the
// times; chip_kernel_ab.py times it against the first design).
// - The wrapper hands the targets over in frame order (row-major corners):
//   the blocks that run together read nearby rows of each plane, and a
//   segment two windows share is still in L2 for the second.
// - One block of kWarps = 4 warps per (target, kTimeBlock = 8 cadences):
//   short blocks keep the masks' uneven sizes (9 to 289 pixels) from
//   leaving SMs idle at the end, and the targets resident together read
//   the same few planes; blocks of 64 or more cadences ran slower.
// - The block compacts its target's mask into shared memory as chunks: the
//   16-byte-aligned float4 quads of the image that hold in-mask, in-image
//   pixels, each with a 4-bit mask of them (fewer, wider loads than single
//   pixels), built with warp ballots and a scan over the warps' counts, so
//   the order (and with it the float sum) is the same on every run.  A
//   frame whose planes do not start on 16 bytes takes single pixels
//   instead (V = 1), the same code, slower.  Compacting each mask once, in
//   a first kernel, into device memory made the sums slower, not faster.
// - Each warp sums kGroup = 2 cadences at once: its lanes stride the chunk
//   list and issue the group's loads (ld.global.cs, evict-first, faster
//   than ld.global.nc here) before adding any, into 2 independent sums and
//   a bit per cadence for "a finite value was seen".  A transposed
//   butterfly of 1 + 4 shuffles leaves each sum whole in one lane, an OR
//   vote the finite bits, and that lane writes out[n, t].
// - Registers set the occupancy, and occupancy the speed: 32 registers
//   let 16 blocks, 64 warps, stay on an SM.  4 cadences a warp took 40-56
//   registers and ran slower; builds held to fewer registers spilled and
//   ran at half the speed.  ptxas: 32 registers, no spills, 16 bytes of
//   static shared memory per block, for both V.
// A mask whose chunk list does not fit one block's shared memory is refused
// by the wrapper (KernelError).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 2;                       // cadences a warp sums at once
constexpr int kTimeBlock = kWarps * kGroup;     // cadences a block: one group a warp
constexpr int kSpan = 32 / kGroup;              // lanes that end up with one cadence's sum
constexpr int kStaticSmem = kWarps * 4;

template <int V> struct Chunk;                  // V pixels one load reads
template <> struct Chunk<1> {
  using type = float;
  static __device__ __forceinline__ float at(float v, int) { return v; }
};
template <> struct Chunk<4> {
  using type = float4;
  static __device__ __forceinline__ float at(const float4& v, int b) {
    return b == 0 ? v.x : b == 1 ? v.y : b == 2 ? v.z : v.w;
  }
};

// Chunks of V pixels one window row of w pixels can touch.
__host__ __device__ constexpr int row_chunks(int w, int V) { return (w + 2 * V - 2) / V; }

template <int V>
__global__ void __launch_bounds__(kThreads)
stamp_flux_kernel(const float* __restrict__ img, const uint8_t* __restrict__ masks,
                  const int32_t* __restrict__ r0s, const int32_t* __restrict__ c0s,
                  float* __restrict__ out, int T, int H, int W, int h, int w)
{
  using Vec = typename Chunk<V>::type;
  extern __shared__ int32_t chunks[];   // (chunk index from the corner's << V) | in-mask bits
  __shared__ int warp_count[kWarps];
  const int n = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = r0s[n], c0 = c0s[n];
  if (r0 < 0 || c0 < 0) return;         // outside the domain: the wrapper raises after the launch
  const uint8_t* m = masks + (size_t)n * h * w;
  const long long corner = (long long)r0 * W + c0;   // the corner's element in a plane
  const int slots = row_chunks(w, V);
  const int ncand = h * slots;

  int count = 0;
  for (int p0 = 0; p0 < ncand; p0 += kThreads) {
    const int p = p0 + threadIdx.x;
    unsigned bits = 0;
    int entry = 0;
    if (p < ncand) {
      const int i = p / slots;
      const long long row = corner + (long long)i * W;   // element of (r0 + i, c0)
      const long long q = row / V + (p - i * slots);     // chunk of the plane
      if (r0 + i < H) {
#pragma unroll
        for (int b = 0; b < V; ++b) {
          const int j = (int)(q * V + b - row);
          if (j >= 0 && j < w && c0 + j < W && m[i * w + j]) bits |= 1u << b;
        }
      }
      entry = (int)((q - corner / V) << V) | (int)bits;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, bits != 0);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = count, total = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int c = warp_count[k];
      before += k < warp ? c : 0;
      total += c;
    }
    if (bits) chunks[before + __popc(ballot & ((1u << lane) - 1u))] = entry;
    count += total;
    __syncthreads();                    // warp_count is rewritten next round
  }

  const int t0 = blockIdx.y * kTimeBlock + warp * kGroup;
  if (t0 >= T) return;                  // no barrier follows
  const size_t stride = (size_t)H * W / V;
  const Vec* base = reinterpret_cast<const Vec*>(img) + corner / V;
  const Vec* plane[kGroup];
  float s[kGroup];
#pragma unroll
  for (int c = 0; c < kGroup; ++c) {
    plane[c] = base + (size_t)min(t0 + c, T - 1) * stride;   // a group past T re-reads T-1
    s[c] = 0.f;
  }
  unsigned fin = 0;
  for (int k = lane; k < count; k += 32) {
    const int e = chunks[k];
    Vec x[kGroup];
#pragma unroll
    for (int c = 0; c < kGroup; ++c) x[c] = __ldcs(plane[c] + (e >> V));
#pragma unroll
    for (int c = 0; c < kGroup; ++c) {
#pragma unroll
      for (int b = 0; b < V; ++b) {
        const float v = Chunk<V>::at(x[c], b);
        if ((e >> b & 1) && isfinite(v)) {
          s[c] += v;
          fin |= 1u << c;
        }
      }
    }
  }
  fin = __reduce_or_sync(0xffffffffu, fin);
  // Transposed butterfly: the lanes with bit 4 set keep the upper half of
  // the sums and send the lower, the others the reverse; bit 3 halves
  // again, and so on until each lane holds one sum (lane / kSpan); the
  // remaining rounds add it up over the kSpan lanes that share it.
#pragma unroll
  for (int o = 16, half = kGroup / 2; o > 0; o >>= 1, half >>= 1) {
    if (half > 0) {
      const bool up = lane & o;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = up ? s[i] : s[i + half];
        const float keep = up ? s[i + half] : s[i];
        s[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    } else {
      s[0] += __shfl_xor_sync(0xffffffffu, s[0], o);
    }
  }
  const int c = lane / kSpan;
  if (lane % kSpan == 0 && t0 + c < T)
    out[(size_t)n * T + t0 + c] = fin >> c & 1u ? s[0] : __int_as_float(0x7fc00000);
}

template <int V>
int launch(const float* img, const uint8_t* masks, const int32_t* r0s, const int32_t* c0s,
           float* out, int N, int T, int H, int W, int h, int w, cudaStream_t stream)
{
  const int smem = h * row_chunks(w, V) * (int)sizeof(int32_t);
  if (smem + kStaticSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(stamp_flux_kernel<V>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)N, (unsigned)((T + kTimeBlock - 1) / kTimeBlock));
  stamp_flux_kernel<V><<<grid, kThreads, smem, stream>>>(img, masks, r0s, c0s, out, T, H, W, h, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest h * w one block's shared memory holds on the current device
// (the single-pixel list, the longer of the two).
int stamp_flux_max_pixels()
{
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)
      != cudaSuccess) return 0;
  return (bytes - kStaticSmem) / (int)sizeof(int32_t);
}

// img (T, H, W) float32; masks (N, h, w) uint8/bool; r0s, c0s (N,) int32
// corners (>= 0); out (N, T) float32.  Launch on `stream`; returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue where a chunk
// index would not fit its 27 bits (h * W >= 2^29) or T needs more than
// 65,535 blocks of cadences.
int stamp_flux(const float* img, const uint8_t* masks, const int32_t* r0s, const int32_t* c0s,
               float* out, int N, int T, int H, int W, int h, int w, void* stream)
{
  if (N == 0 || T == 0) return (int)cudaSuccess;
  if ((long long)(h + 1) * W >= (1LL << 29) || (T + kTimeBlock - 1) / kTimeBlock > 65535)
    return (int)cudaErrorInvalidValue;
  const bool quads = reinterpret_cast<uintptr_t>(img) % 16 == 0 && (long long)H * W % 4 == 0;
  return quads ? launch<4>(img, masks, r0s, c0s, out, N, T, H, W, h, w, (cudaStream_t)stream)
               : launch<1>(img, masks, r0s, c0s, out, N, T, H, W, h, w, (cudaStream_t)stream);
}

}  // extern "C"
