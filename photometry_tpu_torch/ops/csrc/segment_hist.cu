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
// - grid (blocks_per_frame, F); each block keeps a private n_seg x n_buckets
//   int32 table in dynamic shared memory (40 x 512 x 4 B = 80 KB for the
//   prepare stage's rings, above the 48 KB default: the launch opts in);
// - the block strides over its frame's samples with coalesced loads of seg
//   (shared by every frame), bucket and good, and adds one to its table
//   with a shared-memory atomic for every good sample whose segment and
//   bucket are in range (seg < 0, seg >= n_seg and !good are skipped, as
//   ops.stats.segment_kde_mode builds `good`);
// - it then adds the non-zero cells of its table to the frame's int32 table
//   in global memory, and a second kernel writes the float32 output.
//
// Counts are integers and exact whatever order the atomics land in.
// Bound: the bytes of the inputs (9 B per sample, seg once) and of the
// table; on the card the atomics to the few buckets around the sky mode
// serialise, which this first version accepts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
segment_hist_kernel(const int32_t* __restrict__ seg, const int32_t* __restrict__ bucket,
                    const uint8_t* __restrict__ good, int32_t* __restrict__ counts,
                    long long N, int n_seg, int n_buckets)
{
    extern __shared__ int32_t table[];
    const int cells = n_seg * n_buckets;
    for (int j = threadIdx.x; j < cells; j += blockDim.x) table[j] = 0;
    __syncthreads();

    const long long f = blockIdx.y;
    const int32_t* b_f = bucket + f * N;
    const uint8_t* g_f = good + f * N;
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < N; i += step) {
        if (!g_f[i]) continue;
        const int s = seg[i];
        const int b = b_f[i];
        if ((unsigned)s < (unsigned)n_seg && (unsigned)b < (unsigned)n_buckets)
            atomicAdd(&table[s * n_buckets + b], 1);
    }
    __syncthreads();

    int32_t* out = counts + f * cells;
    for (int j = threadIdx.x; j < cells; j += blockDim.x) {
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

// seg (N,) int32; bucket (F, N) int32; good (F, N) uint8/bool; counts
// (F, n_seg, n_buckets) int32 scratch; out (F, n_seg, n_buckets) float32.
// Returns 0 or the CUDA error of the first failing call.
extern "C" int segment_hist(const void* seg, const void* bucket, const void* good,
                            void* counts, void* out, int F, long long N, int n_seg,
                            int n_buckets, int blocks_per_frame, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    const size_t cells = (size_t)n_seg * (size_t)n_buckets;
    const size_t smem = cells * sizeof(int32_t);
    cudaError_t e = cudaFuncSetAttribute(segment_hist_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaMemsetAsync(counts, 0, (size_t)F * smem, st);
    if (e != cudaSuccess) return (int)e;
    segment_hist_kernel<<<dim3(blocks_per_frame, F), kThreads, smem, st>>>(
        (const int32_t*)seg, (const int32_t*)bucket, (const uint8_t*)good, (int32_t*)counts,
        N, n_seg, n_buckets);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const long long n = (long long)F * (long long)cells;
    to_float_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        (const int32_t*)counts, (float*)out, n);
    return (int)cudaGetLastError();
}
