// Exact 15x15 median filter of (F, H, W) float32 frames, for sm_90a.
//
// Replaces the TPU's Pallas kernel photometry_tpu/ops/median_pallas.py:62
// (_kernel, launched by _median15_padded), and computes what the prepare
// stage's production path photometry_tpu/ops/filters.py:_median_block
// computes: the 113th smallest of the 225 samples around every pixel, with
// scipy 'reflect' borders (numpy 'symmetric': the edge sample repeats), on
// NaN-free input (callers nan_to_num first).
//
// Selection works on int32 order keys: float32 values map monotonically
// onto them (sign bit kept, the other 31 bits flipped for negatives), so
// -0.0 and +0.0 stay apart and a 3.4e38 pixel (nan_to_num of +inf) is just
// the largest key.  Brackets, gathers and picks compare keys as integers;
// the passes' counts compare values as floats against probe values that
// are never -0.0, which gives the same counts (a bracket holding only
// -0.0 and +0.0 is finished on keys).
// Any exact selection returns the key that the JAX path's bisection
// returns, so the output is bit-identical to the JAX filter's.
//
// What bounds it.  By bytes the frame is read once and written once
// (33.6 MB per 2048 x 2048 frame, ~10 us at 3.35 TB/s); the selection is
// the cost.  The first design bisected every pixel's key interval on its
// own, 8-ary, for up to 12 passes x 225 samples x 7 compare-and-adds
// (~37,800 integer operations a pixel): per-pixel probes share no work
// ("windowed counting is only separable for SHARED thresholds",
// median_pallas.py:14-19).
//
// Design: shared probes over a vertical strip of windows.  A thread owns 8
// vertically adjacent outputs of one column.  Their windows lie in a strip
// of 22 rows x 15 columns, and window g is rows g..g+14 of it, so one count
// per strip row serves all 8 outputs: a probe costs 330 compares for 8
// windows instead of 1,800, and prefix sums over the row counts give each
// window's count.  Each output keeps its own bracket (lo, hi] with
// count(<= lo) < 113 <= count(<= hi), and every pass counts 8 probes
// placed inside the distinct brackets of the unfinished outputs (one
// bracket shared by all 8 gets all 8 probes, a 9-way split).  The passes
// stop when
//   - the strip holds at most MG = 16 keys in the union of the brackets:
//     those keys are gathered with their strip row into shared memory,
//     ranked against each other in registers into key order, and each
//     output walks them to its own rank; or
//   - every output's bracket holds at most MS = 12 keys of its window, or a
//     single key: each output gathers its own few keys and picks the one
//     with fewer than `need` keys below it and at least `need` at or below.
// The gathers store without branching (a predicated store and count), so
// lanes of a warp do not serialize on them.
// Every pass shrinks every unfinished bracket at least 2x, so no more than
// 32 passes run on any input (ties: a bracket of one key is finished).
// Operations a pixel: ~810 a pass (22 x 15 keys x 8 probes, compare and
// add, over 8 outputs, plus bookkeeping); the numpy model of this
// selection in tests/test_torch_prepare_ops.py counts 2.4-3.4 passes a
// strip on noise and on star fields, and a warp waits for its slowest
// strip (3-4 passes).  With ~300 more to gather and rank, ~2,400-3,600 a
// pixel against ~37,800.  The pass compares values as floats on the FP32
// pipes (half the integer pipe's rate otherwise); the gathers and picks
// stay on integer keys.  On an H100 the finish does not run at its count
// (timed without their finish, the passes take well under half the
// time), so the kernel runs ~4.4x faster than the first design, not ~10x.
//
// Layout: a block of 32 x 4 threads owns a 32 x 32 tile of outputs of one
// frame and stages the 46 x 46 halo in shared memory as order keys and as
// values, reflecting the indices at the frame edges itself (periodic with
// period 2n, so frames narrower than the 7-pixel halo fold again).  A warp reads
// 32 neighbouring keys of one row: conflict-free.  The candidate lists are
// [slot][thread] in shared memory, conflict-free too.  Offsets are 64-bit:
// F * H * W exceeds int32 at full-CCD chunks.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int K = 15;
constexpr int HALF = K / 2;
constexpr int TARGET = K * K / 2 + 1;   // 113
constexpr int G = 8;                    // outputs a thread, stacked vertically
constexpr int R = G + K - 1;            // 22 strip rows
constexpr int TX = 32;                  // threads along x
constexpr int TYT = 4;                  // thread rows
constexpr int NT = TX * TYT;            // 128 threads
constexpr int TH = TYT * G;             // 32 output rows a block
constexpr int SW = TX + 2 * HALF;       // 46
constexpr int SH = TH + 2 * HALF;       // 46
constexpr int NP = 8;                   // probes a pass
constexpr int MG = 16;                  // strip keys gathered for all 8 outputs
constexpr int MS = 12;                  // window keys gathered for one output
constexpr int MAX_PASSES = 40;          // > 32: never reached

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

// Per probe, how many of strip row r's 15 values are <= it.  The compares
// are float compares on the values (fs) against the probes' values (fm),
// counted in float: the FP32 pipes take them, not the integer pipe, which
// doubles their rate.  They equal the key compares for every probe but
// -0.0 (key -1), which the probes avoid (see the pass loop).
__device__ __forceinline__ void row_counts(const float* fs, int r, const float (&fm)[NP],
                                           int (&rc)[NP])
{
    float f[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) f[j] = 0.f;
#pragma unroll
    for (int c = 0; c < K; ++c) {
        const float v = fs[r * SW + c];
#pragma unroll
        for (int j = 0; j < NP; ++j) f[j] += (v <= fm[j]) ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) rc[j] = __float_as_int(f[j] + 8388608.0f) - 0x4B000000;  // exact
}

// A bracket (lo, hi] of the two keys of -0.0 and +0.0, which no float probe
// splits: an output left with it is finished by counting its -0.0 keys.
__device__ __forceinline__ bool signed_zeros(int lo, int hi) { return lo == -2 && hi == 0; }

// a[0] <- a[1] <- ... <- a[n-1] <- a[0]: the loops over outputs stay rolled
// (one copy of their code) and always work on slot 0.
template <int n>
__device__ __forceinline__ void rotate(int (&a)[n])
{
    const int t = a[0];
#pragma unroll
    for (int k = 0; k + 1 < n; ++k) a[k] = a[k + 1];
    a[n - 1] = t;
}

__global__ void __launch_bounds__(NT)
median15_kernel(const float* __restrict__ in, float* __restrict__ out, int H, int W)
{
    __shared__ int tile[SH][SW];          // the halo as order keys
    __shared__ float ftile[SH][SW];       // and as values
    // Gathered keys (then in key order) and their strip rows, gathered and
    // in key order, [slot][thread]: 32-bit entries, so lanes at different
    // slots never share a bank.
    __shared__ int ckey[MG][NT];
    __shared__ int crow[MG][NT];
    __shared__ int srow[MG][NT];
    const long long plane = (long long)H * W;
    const float* src = in + (long long)blockIdx.z * plane;
    const int x0 = blockIdx.x * TX;
    const int y0 = blockIdx.y * TH;
    const int tid = threadIdx.y * TX + threadIdx.x;
    for (int j = tid; j < SH * SW; j += NT) {
        const int ty = j / SW, tx = j % SW;
        const int gy = reflect(y0 + ty - HALF, H);
        const int gx = reflect(x0 + tx - HALF, W);
        const float v = src[(long long)gy * W + gx];
        tile[ty][tx] = ordkey(v);
        ftile[ty][tx] = v;
    }
    __syncthreads();
    const int x = x0 + threadIdx.x, ybase = y0 + threadIdx.y * G;
    if (x >= W || ybase >= H) return;
    const int* s = &tile[threadIdx.y * G][threadIdx.x];   // strip row r, column c: s[r * SW + c]
    const float* fs = &ftile[threadIdx.y * G][threadIdx.x];

    int mn = INT_MAX, mx = INT_MIN;
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = 0; c < K; ++c) {
            const int v = s[r * SW + c];
            mn = min(mn, v);
            mx = max(mx, v);
        }
    }
    // Per output: bracket (lo, hi], its window counts cl = count(<= lo) <
    // TARGET <= ch = count(<= hi), and the strip's counts sl, sh at lo, hi.
    int lo[G], hi[G], cl[G], ch[G], sl[G], sh[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
        lo[g] = mn - 1;   // the most negative finite key is > INT_MIN
        hi[g] = mx;
        cl[g] = 0;
        ch[g] = K * K;
        sl[g] = 0;
        sh[g] = R * K;
    }

    bool group = false;
    int LO = 0, HI = 0, sLO = 0, sHI = 0;
#pragma unroll 1
    for (int pass = 0;; ++pass) {
        // The union of the brackets (they overlap: the answers are near).
        LO = lo[0];
        HI = hi[0];
        sLO = sl[0];
        sHI = sh[0];
#pragma unroll
        for (int g = 1; g < G; ++g) {
            if (lo[g] < LO) { LO = lo[g]; sLO = sl[g]; }
            if (hi[g] > HI) { HI = hi[g]; sHI = sh[g]; }
        }
        if (sHI - sLO <= MG) { group = true; break; }
        bool open[G];
        bool any = false;
#pragma unroll
        for (int g = 0; g < G; ++g) {
            open[g] = (unsigned)hi[g] - (unsigned)lo[g] > 1u && ch[g] - cl[g] > MS
                      && !signed_zeros(lo[g], hi[g]);
            any |= open[g];
        }
        if (!any || pass == MAX_PASSES) break;

        // Distinct brackets of the open outputs, in output order.
        bool first[G];
        int idx[G], nb = 0;
#pragma unroll
        for (int g = 0; g < G; ++g) {
            bool f = open[g];
#pragma unroll
            for (int e = 0; e < g; ++e)
                f = f && !(open[e] && lo[e] == lo[g] && hi[e] == hi[g]);
            first[g] = f;
            idx[g] = nb;
            nb += f;
        }
        // Probe j splits distinct bracket j % nb at (q + 1) / (n + 1), where
        // q = j / nb and n counts the probes that bracket gets.
        int m[NP];
#pragma unroll
        for (int j = 0; j < NP; ++j) {
            const int b = j % nb, q = j / nb;
            const int n = (NP - 1 - b) / nb + 1;
            int l = 0, h = 0;
#pragma unroll
            for (int g = 0; g < G; ++g) {
                if (first[g] && idx[g] == b) { l = lo[g]; h = hi[g]; }
            }
            const unsigned d = (unsigned)h - (unsigned)l;           // >= 2
            const unsigned frac = (unsigned)((float)(q + 1) * (4294967296.0f / (float)(n + 1)));
            const unsigned step = min(max(__umulhi(d, frac), 1u), d - 1u);
            m[j] = (int)((unsigned)l + step);
            // Not -0.0: a float compare would count +0.0 below it.  The
            // bracket holds 0 or -2 then (it is not (-2, 0]).
            if (m[j] == -1) m[j] = h > 0 ? 0 : -2;
        }
        float fm[NP];
#pragma unroll
        for (int j = 0; j < NP; ++j) fm[j] = from_ordkey(m[j]);

        // Window g is strip rows g .. g + 14: count rows 0..14 into P (rows
        // 0..6 also kept 4 bits a probe in top[]), then slide down a row per
        // output.  lj, hj: the probe that moved an output's lo, hi.
        int P[NP], tsum[NP], rc[NP], top[G - 1], lj[G], hj[G];
#pragma unroll
        for (int j = 0; j < NP; ++j) { P[j] = 0; tsum[j] = 0; }
#pragma unroll
        for (int k = 0; k < G - 1; ++k) top[k] = 0;
#pragma unroll 1
        for (int r = 0; r < G - 1; ++r) {
            row_counts(fs, r, fm, rc);
            int packed = 0;
#pragma unroll
            for (int j = 0; j < NP; ++j) {
                P[j] += rc[j];
                tsum[j] += rc[j];
                packed |= rc[j] << (4 * j);
            }
            rotate(top);
            top[G - 2] = packed;
        }
#pragma unroll 1
        for (int r = G - 1; r < K; ++r) {
            row_counts(fs, r, fm, rc);
#pragma unroll
            for (int j = 0; j < NP; ++j) P[j] += rc[j];
        }
#pragma unroll 1
        for (int g = 0; g < G; ++g) {
            lj[0] = -1;
            hj[0] = -1;
#pragma unroll
            for (int j = 0; j < NP; ++j) {
                if (P[j] >= TARGET) {
                    if (m[j] < hi[0]) { hi[0] = m[j]; ch[0] = P[j]; hj[0] = j; }
                } else if (m[j] > lo[0]) {
                    lo[0] = m[j]; cl[0] = P[j]; lj[0] = j;
                }
            }
            rotate(lo); rotate(hi); rotate(cl); rotate(ch); rotate(sl); rotate(sh);
            rotate(lj); rotate(hj);
            if (g < G - 1) {
                row_counts(fs, K + g, fm, rc);
#pragma unroll
                for (int j = 0; j < NP; ++j) P[j] += rc[j] - ((top[0] >> (4 * j)) & 15);
                rotate(top);
            }
        }
        // The strip's counts at the new bounds: P holds rows 7..21, tsum 0..6.
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
            for (int j = 0; j < NP; ++j) {
                if (lj[g] == j) sl[g] = P[j] + tsum[j];
                if (hj[g] == j) sh[g] = P[j] + tsum[j];
            }
        }
    }

    float* dst = out + (long long)blockIdx.z * plane + (long long)ybase * W + x;
    const int rows_out = min(G, H - ybase);
    if (group) {
        // The strip's keys in (LO, HI] with their strip rows; ranked in
        // registers (ties by slot) into key order; each output walks them.
        int n = 0;
#pragma unroll 1
        for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int c = 0; c < K; ++c) {
                const int v = s[r * SW + c];
                const bool in = (unsigned)v - (unsigned)LO - 1u < (unsigned)HI - (unsigned)LO;
                if (in) { ckey[n][tid] = v; crow[n][tid] = r; }
                n += in;
            }
        }
        int v[MG];
#pragma unroll
        for (int k = 0; k < MG; ++k) v[k] = k < n ? ckey[k][tid] : INT_MAX;   // > every key
#pragma unroll
        for (int i = 0; i < MG; ++i) {
            if (i < n) {
                int rank = 0;
#pragma unroll
                for (int j = 0; j < i; ++j) rank += v[j] <= v[i];
#pragma unroll
                for (int j = i + 1; j < MG; ++j) rank += v[j] < v[i];
                ckey[rank][tid] = v[i];          // v[] holds the keys now
                srow[rank][tid] = crow[i][tid];
            }
        }
#pragma unroll 1
        for (int g = 0; g < rows_out; ++g) {
            int need = TARGET - cl[0], ans = hi[0];
#pragma unroll
            for (int k = 0; k < MG; ++k) {
                if (k < n && need > 0) {
                    const int u = ckey[k][tid], r = srow[k][tid];
                    need -= u > lo[0] && r >= g && r < g + K;
                    if (need == 0) ans = u;
                }
            }
            dst[(long long)g * W] = from_ordkey(ans);
            rotate(lo); rotate(hi); rotate(cl);
        }
    } else {
#pragma unroll 1
        for (int g = 0; g < rows_out; ++g) {
            int ans = hi[0];
            if (signed_zeros(lo[0], hi[0])) {
                // (lo, hi] = {-0.0, +0.0}: -0.0 if enough of them.
                int nz = 0;
#pragma unroll 1
                for (int r = g; r < g + K; ++r) {
#pragma unroll
                    for (int c = 0; c < K; ++c) nz += s[r * SW + c] == -1;
                }
                ans = TARGET - cl[0] <= nz ? -1 : 0;
            } else if ((unsigned)hi[0] - (unsigned)lo[0] > 1u) {
                // At most MS keys of window g lie in (lo, hi]: the answer is
                // the one with fewer than `need` keys below it and at least
                // `need` at or below it.
                int n = 0;
#pragma unroll 1
                for (int r = g; r < g + K; ++r) {
#pragma unroll
                    for (int c = 0; c < K; ++c) {
                        const int v = s[r * SW + c];
                        const bool in = (unsigned)v - (unsigned)lo[0] - 1u
                                        < (unsigned)hi[0] - (unsigned)lo[0];
                        // n < MS: a bracket left wide at MAX_PASSES stays in the list.
                        if (in && n < MS) ckey[n][tid] = v;
                        n += in;
                    }
                }
                const int need = TARGET - cl[0];
                int v[MS];
#pragma unroll
                for (int k = 0; k < MS; ++k) v[k] = k < n ? ckey[k][tid] : INT_MAX;
#pragma unroll
                for (int i = 0; i < MS; ++i) {
                    int below = 0, at = 0;
#pragma unroll
                    for (int j = 0; j < MS; ++j) {
                        below += v[j] < v[i];
                        at += v[j] <= v[i];
                    }
                    if (i < n && below < need && need <= at) ans = v[i];
                }
            }
            dst[(long long)g * W] = from_ordkey(ans);
            rotate(lo); rotate(hi); rotate(cl);
        }
    }
}

}  // namespace

// in, out: (F, H, W) float32, contiguous.  Returns 0 or the CUDA error.
extern "C" int median15(const void* in, void* out, int F, int H, int W, void* stream)
{
    const dim3 grid((W + TX - 1) / TX, (H + TH - 1) / TH, F);
    median15_kernel<<<grid, dim3(TX, TYT), 0, (cudaStream_t)stream>>>(
        (const float*)in, (float*)out, H, W);
    return (int)cudaGetLastError();
}
