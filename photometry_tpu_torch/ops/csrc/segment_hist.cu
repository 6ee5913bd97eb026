// Exact per-frame (segment x bucket) count tables, for sm_90a.
//
// Replaces the TPU's Pallas kernel photometry_tpu/ops/hist_pallas.py:44
// (_kernel, launched by segment_histogram_tpu), which builds the same table
//
//     hist[f, s, b] = #{i : seg[i] == s, bucket[f, i] == b, good[f, i]}
//
// as one-hot matrix products on the MXU, because a TPU has no fast scatter.
// Hopper has fast shared-memory atomics, so the table is counted directly:
//
// - grid (blocks_per_frame, F) of 1,024-thread blocks, each with a private
//   n_seg x n_buckets int32 table in dynamic shared memory (39 x 512 x 4 B
//   = 80 KB for the prepare stage's rings; the launch opts in above 48 KB).
//   Two such blocks fill an SM's 2,048 threads, and the wrapper sizes the
//   grid from the occupancy so that all blocks run in one wave;
// - a thread reads 4 samples per step (16 B of buckets, 16 B of segments,
//   4 B of `good`) where the three arrays share their alignment; a scalar
//   head and tail cover the rest, and misaligned inputs take a scalar loop;
// - one shared-memory atomic per counted sample: merging a warp's samples
//   of one cell first (`__match_any_sync`) measured slower, also on real
//   buckets, because only ~9% of a frame's samples fall in a ring;
// - samples with seg or bucket out of range, or not good, are skipped (as
//   ops.stats.segment_kde_mode builds `good`);
// - the block adds the non-zero cells of its table to the frame's int32
//   table in global memory, and a second kernel writes the float32 output
//   (one path for every N: float32 atomics into the output would save the
//   second kernel but are exact only up to 2^24 samples a frame).
//
// Counts are integers and exact whatever order the atomics land in.
// Bound: the bytes of the inputs (5 B per sample and frame, the 4 B of seg
// once) and of the table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

// One good sample with seg and bucket in range adds one to its cell.
__device__ __forceinline__ void count(int32_t* table, int s, int b, bool g, int n_seg,
                                      int n_buckets)
{
    if (g && (unsigned)s < (unsigned)n_seg && (unsigned)b < (unsigned)n_buckets)
        atomicAdd(&table[s * n_buckets + b], 1);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
segment_hist_kernel(const int32_t* __restrict__ seg, const int32_t* __restrict__ bucket,
                    const uint8_t* __restrict__ good, int32_t* __restrict__ counts,
                    long long N, int n_seg, int n_buckets, int head)
{
    extern __shared__ int32_t table[];
    const int cells = n_seg * n_buckets;
    for (int j = threadIdx.x; j < cells; j += kThreads) table[j] = 0;
    __syncthreads();

    const long long f = blockIdx.y;
    const int32_t* b_f = bucket + f * N;
    const uint8_t* g_f = good + f * N;
    const long long step = (long long)gridDim.x * kThreads;
    if (kVec) {
        const long long nvec = (N - head) / 4;
        const int4* s4 = reinterpret_cast<const int4*>(seg + head);
        const int4* b4 = reinterpret_cast<const int4*>(b_f + head);
        const uchar4* g4 = reinterpret_cast<const uchar4*>(g_f + head);
        for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < nvec; v += step) {
            const int4 s = s4[v], b = b4[v];
            const uchar4 g = g4[v];
            count(table, s.x, b.x, g.x, n_seg, n_buckets);
            count(table, s.y, b.y, g.y, n_seg, n_buckets);
            count(table, s.z, b.z, g.z, n_seg, n_buckets);
            count(table, s.w, b.w, g.w, n_seg, n_buckets);
        }
        if (blockIdx.x == 0 && threadIdx.x < 8) {    // scalar head [0, head), tail [t0, N)
            const long long t0 = head + 4 * nvec;
            const int k = threadIdx.x;
            const long long i = k < head ? k : t0 + (k - head);
            if (i < N) count(table, seg[i], b_f[i], g_f[i], n_seg, n_buckets);
        }
    } else {
        for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < N; i += step)
            count(table, seg[i], b_f[i], g_f[i], n_seg, n_buckets);
    }
    __syncthreads();

    int32_t* out = counts + f * cells;
    for (int j = threadIdx.x; j < cells; j += kThreads) {
        const int v = table[j];
        if (v) atomicAdd(&out[j], v);
    }
}

__global__ void to_float_kernel(const int32_t* __restrict__ in, float* __restrict__ out,
                                long long n)
{
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = (float)in[i];
}

}  // namespace

// The largest n_seg * n_buckets one block can hold on the current device.
extern "C" int segment_hist_max_cells()
{
    int dev = 0, bytes = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)
        != cudaSuccess) return 0;
    return bytes / (int)sizeof(int32_t);
}

// Blocks of a n_seg x n_buckets table that run at once on the whole device
// (blocks per SM times SMs), or a negative CUDA error.
extern "C" int segment_hist_resident_blocks(int n_seg, int n_buckets)
{
    const int smem = n_seg * n_buckets * (int)sizeof(int32_t);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(segment_hist_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, segment_hist_kernel<true>,
                                                          kThreads, smem);
    return e == cudaSuccess ? per_sm * sms : -(int)e;
}

// seg (N,) int32; bucket (F, N) int32; good (F, N) uint8/bool; counts
// (F, n_seg, n_buckets) int32 scratch; out (F, n_seg, n_buckets) float32.
// head: the scalar samples before the arrays' 16-byte boundary (0-3, the
// same for seg, bucket and good, and N % 4 == 0 unless F == 1), or -1 for
// the scalar loop.  Returns 0 or the CUDA error of the first failing call.
extern "C" int segment_hist(const void* seg, const void* bucket, const void* good,
                            void* counts, void* out, int F, long long N, int n_seg,
                            int n_buckets, int blocks_per_frame, int head, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    const size_t cells = (size_t)n_seg * (size_t)n_buckets;
    const size_t smem = cells * sizeof(int32_t);
    auto kernel = head >= 0 ? segment_hist_kernel<true> : segment_hist_kernel<false>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaMemsetAsync(counts, 0, (size_t)F * smem, st);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3(blocks_per_frame, F), kThreads, smem, st>>>(
        (const int32_t*)seg, (const int32_t*)bucket, (const uint8_t*)good, (int32_t*)counts,
        N, n_seg, n_buckets, head);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const long long n = (long long)F * (long long)cells;
    to_float_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        (const int32_t*)counts, (float*)out, n);
    return (int)cudaGetLastError();
}
