// Fused warm-start Levenberg-Marquardt PSF fit, one warp per instance.
//
// Replaces photometry_tpu/models/psf_pallas.py:_kernel (the Pallas TPU
// kernel behind fused_warm_fit) and computes the same function as
// photometry_tpu_torch/models/psf_fused.py:fused_warm_fit_plain.
//
// What it computes.  Per instance b (one target at one cadence), with S
// stars packed p = [rows(S), cols(S), fluxes(S)] on an h x w stamp:
//   1. Gaussian_d weights once: w = 1/max(|img0 + bkg| + var_const, 1e-9)
//      on finite pixels, 0 elsewhere, img0 = img with non-finite set to 0.
//   2. n_iters damped Gauss-Newton steps: render every star through the
//      K-term SVD-separable Catmull-Rom table (q, dq/drow, dq/dcol, 5 px
//      cutoff), form the 3S x 3S JtJ and Jt(img0 - model) with dummy-star
//      rows and columns zeroed, damp the diagonal a_jj*(1+1e-3) + 1e-8,
//      solve by Cholesky, update with the clips (rows in [-2, h+1] and
//      cols in [-2, w+1] for valid stars, fluxes >= 0).
//   3. A final render: the main target's flux variance from the Cholesky
//      factor of JtJ + 1e-6*max(max diag, 1)*I (inverse column norms),
//      and the MOMF residual sum over (miniw & finite) of img0 - model.
// Outputs params (B, 3S), flux_ap (B,), fluxvar (B,), float32.
//
// The table.  One axis of the render is
//   vals[i][k] = sum_j wb[j](t) * Fz[clamp(b, b_lo, b_hi) - b_lo + i*os + j][k]
// with y0 = -coord*os + center, b = floor(y0) - 1, t = y0 - floor(y0), wb
// the Catmull-Rom weights, and vals zeroed where y0 + i*os lies outside
// [0, L0-1] (models/prf.py:_axis_values).  Fz is the zero-padded (Lz, K)
// factor table, a few KB per axis, staged in shared memory per block.
//
// Why not the TPU's layout.  The TPU kernel puts 128 instances on the
// lanes, flattens pixels onto sublanes and selects table rows with one-hot
// matmuls, because a TPU has no fast gather.  Here a warp owns an
// instance; S (1..8) and K (1..4) are template parameters.
//
// The render.  The axis values are (value, derivative) pairs, one 8-byte
// load each.  Skipping stars beyond the cutoff of a whole pass (a warp
// vote) measured slower: the branches cost more registers than they save.
//
// The normal equations on the tensor cores.  Each pass renders 32 pixels,
// one per lane, and stages the weighted rows X = sqrt(w) * [J | img0 -
// model] (3S + 1 values, zero-padded to 16 or 32 columns) column-major in
// a per-warp shared tile.  X^T X = [JtWJ, JtWg; ...] then comes from
// mma.sync m16n8k8 on TF32 in the 3xTF32 scheme: X = H + L with H rounded
// to TF32 and L = X - H, and X^T X ~ H^T H + H^T L + L^T H, where L^T H is
// the transpose of H^T L, added when the fragments are gathered: two
// products a tile.  No product is formed in plain TF32, and X keeps ~22 of
// its 24 bits.  A's fragment of X^T and B's fragments of X are the same
// registers.  The accumulators are the MMA's C fragments (16 floats a lane
// for S <= 5, 64 for S = 6..8), so the 120-300 register partial sums and
// the 5-round shuffle butterfly of a SIMT reduction are gone, and more
// warps fit on an SM.
//
// The solve.  The C fragments go through shared memory to rows: lane i
// holds row i of JtWJ and (JtWg)_i.  A right-looking Cholesky broadcasts
// each pivot and each L[k][j] by shuffle (3S steps, no per-lane
// ~1,000-operation chain), with the forward substitution fused in; the
// back substitution walks the columns of L that lane m kept in registers.
// Each pivot takes one rsqrt, and the chain multiplies by 1 / L[j][j]
// where the first design divided.  Every lane ends with the whole step and
// updates its copy of p.  Pivot clamp max(d, 1e-30), damping, clips and
// NaN propagation (nmax, nclip) are those of ops/smallsolve.py and the
// TPU kernel.
//
// What bounds it.  Operations: per instance and iteration the normal
// equations, 3S(3S+1) + 9S flops per pixel (the tensor cores' share, three
// TF32 products each in 3xTF32), plus the render, ~S(10 + 6K) per pixel,
// on the float32 pipes; the bytes (one stamp of images, backgrounds and
// mask, a few hundred bytes of parameters) are two orders below the card's
// ridge point.  Offsets into the (B, h, w) inputs are 64-bit.
//
// Float order differs from the JAX kernel and the plain torch fitter
// (pixels summed by the tensor cores, a right-looking Cholesky), so
// results agree to float32 reduction order, not bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kKMax = 4;
constexpr int kSMax = 8;
constexpr int kHWMax = 32;
constexpr int kMaxWarps = 8;               // instances per block, at most
constexpr int kLd = 40;                    // column stride of the staged tile (conflict-free)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLambda = 1e-3f;

// Catmull-Rom basis: wb[j] = sum_p t^p * kCRM[p][j] (ops/spline.py:CRM).
__constant__ float kCRM[4][4] = {{0.0f, 1.0f, 0.0f, 0.0f},
                                 {-0.5f, 0.0f, 0.5f, 0.0f},
                                 {1.0f, -2.5f, 2.0f, -0.5f},
                                 {-0.5f, 1.5f, -1.5f, 0.5f}};

struct Args {
  const float* img;
  const float* bkg;
  const uint8_t* miniw;
  const float* p0;
  const uint8_t* valid;
  const float* onehot;
  const float* Fu;
  const float* Fv;
  float* params;
  float* flux_ap;
  float* fluxvar;
  long long B;
  int h, w, os;
  int bu_lo, bu_hi, L0u, Lzu;
  float cy;
  int bv_lo, bv_hi, L0v, Lzv;
  float cx;
  int n_iters;
  float var_const, cutoff2;
};

// max and clip that keep a NaN, as jnp.maximum / torch.clamp do.
__device__ __forceinline__ float nmax(float a, float b) { return a != a ? a : fmaxf(a, b); }
__device__ __forceinline__ float nclip(float a, float lo, float hi) {
  return a != a ? a : fminf(fmaxf(a, lo), hi);
}

// 16-column groups of the staged rows [J | g]: 1 for S <= 5, 2 for S = 6..8.
__host__ __device__ constexpr int n_groups(int S) { return (3 * S + 16) / 16; }

// Floats of one warp's shared memory: img0 and sqrt(w) (h*w each), the
// axis values (u, du) (S*K rows of h pairs) and (v, dv) (S*K rows of w
// pairs), the staged tile (16*NC columns of kLd) and the gathered matrix
// (16*NC rows of 16*NC+1).  An even count keeps the pairs 8-byte aligned.
__host__ __device__ constexpr int warp_floats(int S, int K, int h, int w) {
  return 2 * h * w + 2 * S * K * (h + w) + 16 * n_groups(S) * kLd +
         16 * n_groups(S) * (16 * n_groups(S) + 1);
}

// Floats of the block's two factor tables, rounded up to keep what follows aligned.
__host__ __device__ constexpr int table_floats(int K, int Lzu, int Lzv) {
  return ((Lzu + Lzv) * K + 3) & ~3;
}

// One axis query row i of one star: K (value, derivative) pairs, written
// with stride `stride` (the axis length) between the k terms.
template <int K>
__device__ __forceinline__ void axis_row(const float* __restrict__ F, int os, int b_lo, int b_hi,
                                         int L0, float center, float coord, int i, float2* out,
                                         int stride) {
  // (0 - coord)*os + center, rounded as the JAX and torch versions round it:
  const float y0 = __fadd_rn(__fmul_rn(-coord, (float)os), center);
  const float fl = floorf(y0);
  const float t = __fsub_rn(y0, fl);
  const int b = (int)fl - 1;
  const int idx = min(max(b, b_lo), b_hi) - b_lo;
  const float tp[4] = {1.0f, t, t * t, t * t * t};
  const float dtp[4] = {0.0f, 1.0f, 2.0f * t, 3.0f * t * t};
  float wb[4], dwb[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float a = 0.0f, d = 0.0f;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      a += tp[p] * kCRM[p][j];
      d += dtp[p] * kCRM[p][j];
    }
    wb[j] = a;
    dwb[j] = d;
  }
  const float yi = __fadd_rn(y0, (float)(i * os));
  const bool ok = yi >= 0.0f && yi <= (float)(L0 - 1);
  const int row = idx + i * os;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float a = 0.0f, d = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float f = F[(row + j) * K + k];
      a += wb[j] * f;
      d += dwb[j] * f;
    }
    out[k * stride] = ok ? make_float2(a, d * (float)(-os)) : make_float2(0.0f, 0.0f);
  }
}

// The axis values at p: lanes 0..h-1 take the rows, lanes h..h+w-1 the columns.
template <int S, int K>
__device__ __forceinline__ void eval_axes(const Args& a, const float* Fu, const float* Fv,
                                          const float (&p)[3 * S], float2* ax, int lane) {
  const int h = a.h, w = a.w;
  float2* ud = ax;
  float2* vd = ud + S * K * h;
  for (int q = lane; q < h + w; q += 32) {
    if (q < h) {
#pragma unroll
      for (int s = 0; s < S; ++s)
        axis_row<K>(Fu, a.os, a.bu_lo, a.bu_hi, a.L0u, a.cy, p[s], q, ud + s * K * h + q, h);
    } else {
      const int c = q - h;
#pragma unroll
      for (int s = 0; s < S; ++s)
        axis_row<K>(Fv, a.os, a.bv_lo, a.bv_hi, a.L0v, a.cx, p[S + s], c, vd + s * K * w + c,
                    w);
    }
  }
  __syncwarp();
}

// x = hi + lo (the 3xTF32 split): hi is x rounded to TF32's 10 mantissa
// bits (to nearest, ties away; finite x), lo = x - hi exactly, whose bits
// the tensor core reads as TF32 (dropping at most its 2 lowest), so hi + lo
// keeps ~22 of float32's 24 bits.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += A(16x8, TF32) * B(8x8, TF32), float32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// M = X^T X over the stamp at p, X = sqrt(w) * [J | img0 - model], into the
// warp's gathered matrix msh (row stride 16*NC+1): JtWJ in [0, 3S)^2 and
// JtWg in column 3S.  X = H + L (split, as fragments are loaded), and
// X^T X ~ H^T H + H^T L + (H^T L)^T: two products a tile, the transpose
// added when gathering.  The tile keeps pixel j of a pass at slot (j & ~7)
// | (j & 3) << 1 | (j >> 2 & 1), so a lane's fragment pair (pixels k0,
// k0 + 4) is one 8-byte load.  (Splitting once at staging, into a hi and
// a lo tile, measured no faster.)  With kFinal, fap gets the MOMF residual
// sum over the pixels where mw is set and the image x is finite (every
// lane).
template <int S, int K, bool kFinal>
__device__ __forceinline__ void normal_eq(const Args& a, const float* img0, const float* sw,
                                          const float2* ax, float* xt, float* msh,
                                          const float* __restrict__ x,
                                          const uint8_t* __restrict__ mw,
                                          const float (&p)[3 * S], float& fap, int lane) {
  constexpr int P3 = 3 * S;
  constexpr int NC = n_groups(S);
  constexpr int LM = 16 * NC + 1;
  const int h = a.h, w = a.w, npix = h * w;
  const float2* ud = ax;
  const float2* vd = ud + S * K * h;
  const int g = lane >> 2, q = lane & 3;    // mma fragment row group, column in group
  const int slot = (lane & ~7) | (lane & 3) << 1 | (lane >> 2 & 1);
  float hh[NC][2 * NC][4], hl[NC][2 * NC][4];
#pragma unroll
  for (int m = 0; m < NC; ++m)
#pragma unroll
    for (int n = 0; n < 2 * NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) hh[m][n][e] = hl[m][n][e] = 0.0f;
  fap = 0.0f;
  for (int base = 0; base < npix; base += 32) {
    const int pix = base + lane;
    float X[P3 + 1];
#pragma unroll
    for (int i = 0; i <= P3; ++i) X[i] = 0.0f;
    const bool in = pix < npix;               // lanes past the stamp stage zeros
    const int pc = in ? pix : npix - 1;
    const int r = pc / w;
    const int cc = pc - r * w;
    float mdl = 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float dr = (float)r - p[s];
      const float dc = (float)cc - p[S + s];
      const bool cut = in && __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(dc, dc)) < a.cutoff2;
      float qq = 0.0f, qr = 0.0f, qc = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float2 uv = ud[(s * K + k) * h + r], ve = vd[(s * K + k) * w + cc];
        qq += uv.x * ve.x;
        qr += uv.y * ve.x;
        qc += uv.x * ve.y;
      }
      if (!cut) qq = qr = qc = 0.0f;
      const float f = p[2 * S + s];
      mdl += qq * f;
      X[s] = qr * f;
      X[S + s] = qc * f;
      X[2 * S + s] = qq;
    }
    const float swt = sw[pc];
    const float diff = img0[pc] - mdl;
#pragma unroll
    for (int i = 0; i < P3; ++i) X[i] = in ? X[i] * swt : 0.0f;
    X[P3] = in ? diff * swt : 0.0f;
    if (kFinal) fap += (in && mw[pc] && isfinite(x[pc])) ? diff : 0.0f;
#pragma unroll
    for (int i = 0; i <= P3; ++i) xt[i * kLd + slot] = X[i];
    __syncwarp();
    const int nk = min(4, (npix - base + 7) >> 3);
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      if (kb < nk) {
        uint32_t hi[NC][4], lo[NC][4];
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          // (X[k0][c], X[k0+4][c]) for k0 = 8kb + q and c = 16m + g, then c + 8:
          const float* col = xt + (16 * m + g) * kLd + kb * 8 + 2 * q;
          const float2 c0 = *reinterpret_cast<const float2*>(col);
          const float2 c8 = *reinterpret_cast<const float2*>(col + 8 * kLd);
          split(c0.x, hi[m][0], lo[m][0]);
          split(c8.x, hi[m][1], lo[m][1]);
          split(c0.y, hi[m][2], lo[m][2]);
          split(c8.y, hi[m][3], lo[m][3]);
        }
#pragma unroll
        for (int m = 0; m < NC; ++m)
#pragma unroll
          for (int n = 0; n < 2 * NC; ++n) {
            // B = X[:, 8n..8n+7] is A's fragment of group n/2: regs (0, 2) or (1, 3).
            const int gm = n >> 1, o = n & 1;
            mma(hh[m][n], hi[m], hi[gm][o], hi[gm][o + 2]);
            mma(hl[m][n], hi[m], lo[gm][o], lo[gm][o + 2]);
          }
      }
    }
    __syncwarp();
  }
  // C fragment element e of tile (m, n) is M[16m + g + 8(e >> 1)][8n + 2q + (e & 1)].
#pragma unroll
  for (int m = 0; m < NC; ++m)
#pragma unroll
    for (int n = 0; n < 2 * NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        msh[(16 * m + g + 8 * (e >> 1)) * LM + 8 * n + 2 * q + (e & 1)] = hh[m][n][e] + hl[m][n][e];
  __syncwarp();
#pragma unroll
  for (int m = 0; m < NC; ++m)
#pragma unroll
    for (int n = 0; n < 2 * NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        msh[(8 * n + 2 * q + (e & 1)) * LM + 16 * m + g + 8 * (e >> 1)] += hl[m][n][e];
  if (kFinal) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) fap += __shfl_xor_sync(kFull, fap, off);
  }
  __syncwarp();
}

// Lane i < 3S: row i of JtWJ into r and (JtWg)_i into t, dummy-star rows
// and columns frozen (other lanes read row 0; their values are not used).
template <int S>
__device__ __forceinline__ void load_row(const float* msh, const float (&pv)[S], unsigned vbits,
                                         int lane, float (&r)[3 * S], float& t) {
  constexpr int P3 = 3 * S;
  constexpr int LM = 16 * n_groups(S) + 1;
  const int i = lane < P3 ? lane : 0;
  const float pvi = (vbits >> (i % S)) & 1u ? 1.0f : 0.0f;
#pragma unroll
  for (int j = 0; j < P3; ++j) r[j] = msh[i * LM + j] * pvi * pv[j % S];
  t = msh[i * LM + P3] * pvi;
}

// Cholesky of the symmetric P3 x P3 matrix whose row i lane i holds in r,
// right-looking, with the max(d, 1e-30) pivot clamp of ops/smallsolve.py:
// lane i ends with row i of L in r[0..i], every lane with 1 / L[j][j] in
// di (one rsqrt a pivot; the chain of 3S steps has no division).  With
// kSolve, t is lane i's b_i and x gets A^-1 b in every lane.
template <int P3, bool kSolve>
__device__ __forceinline__ void chol(float (&r)[P3], float t, float (&di)[P3], float (&x)[P3],
                                     int lane) {
  float col[P3];                            // lane m: col[k] = L[k][m] for k > m
#pragma unroll
  for (int k = 0; k < P3; ++k) col[k] = 0.0f;
#pragma unroll
  for (int j = 0; j < P3; ++j) {
    const float d = nmax(__shfl_sync(kFull, r[j], j), 1e-30f);
    const float inv = rsqrtf(d);
    di[j] = inv;
    const float lij = r[j] * inv;            // L[i][j] in lane i > j
    r[j] = lane == j ? d * inv : lij;
    if (kSolve) {                            // forward: y_j = (b_j - sum L[j][k] y_k) / L[j][j]
      const float yj = __shfl_sync(kFull, t, j) * inv;
      t = lane == j ? yj : (lane > j ? t - lij * yj : t);
    }
#pragma unroll
    for (int k = j + 1; k < P3; ++k) {
      const float lkj = __shfl_sync(kFull, lij, k);
      r[k] -= lij * lkj;
      if (kSolve) col[k] = lane == j ? lkj : col[k];
    }
  }
  if (kSolve) {                              // back: L^T x = y, lane m keeps y_m in t
#pragma unroll
    for (int i = P3 - 1; i >= 0; --i) {
      const float xi = __shfl_sync(kFull, t, i) * di[i];
      x[i] = xi;
      t = lane < i ? t - col[i] * xi : t;
    }
  }
}

// Two full blocks an SM (<= 128 registers) measured fastest for S <= 5;
// S = 6..8 needs more registers than that and keeps one.
template <int S, int K>
__global__ void __launch_bounds__(kMaxWarps * 32, S <= 5 ? 2 : 1)
psf_warm_fit_kernel(const Args a) {
  constexpr int P3 = 3 * S;
  constexpr int NC = n_groups(S);
  extern __shared__ float smem[];
  const int h = a.h, w = a.w, npix = a.h * a.w;
  const int nw = blockDim.x >> 5;
  float* Fu = smem;
  float* Fv = Fu + a.Lzu * K;
  for (int e = threadIdx.x; e < a.Lzu * K; e += blockDim.x) Fu[e] = a.Fu[e];
  for (int e = threadIdx.x; e < a.Lzv * K; e += blockDim.x) Fv[e] = a.Fv[e];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * nw + warp;
  if (b >= a.B) return;                     // whole warps leave; no block sync follows
  float* img0 = smem + table_floats(K, a.Lzu, a.Lzv) + warp * warp_floats(S, K, h, w);
  float* sw = img0 + npix;
  float2* ax = reinterpret_cast<float2*>(sw + npix);
  float* xt = reinterpret_cast<float*>(ax + S * K * (h + w));
  float* msh = xt + 16 * NC * kLd;
  for (int e = lane; e < 16 * NC * kLd; e += 32) xt[e] = 0.0f;   // padding columns stay 0

  const size_t base = (size_t)b * (size_t)npix;
  for (int pix = lane; pix < npix; pix += 32) {
    const float x = a.img[base + pix];
    const bool good = isfinite(x);
    const float x0 = good ? x : 0.0f;
    const float var = fabsf(x0 + a.bkg[base + pix]) + a.var_const;
    img0[pix] = x0;
    sw[pix] = good ? sqrtf(1.0f / nmax(var, 1e-9f)) : 0.0f;
  }
  float p[P3], pv[S], r[P3], di[P3], dp[P3], t, fap;
  unsigned vbits = 0;
#pragma unroll
  for (int i = 0; i < P3; ++i) p[i] = a.p0[(size_t)b * P3 + i];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    pv[s] = a.valid[(size_t)b * S + s] ? 1.0f : 0.0f;
    vbits |= a.valid[(size_t)b * S + s] ? 1u << s : 0u;
  }
  __syncwarp();

  for (int it = 0; it < a.n_iters; ++it) {
    eval_axes<S, K>(a, Fu, Fv, p, ax, lane);
    normal_eq<S, K, false>(a, img0, sw, ax, xt, msh, nullptr, nullptr, p, fap, lane);
    load_row<S>(msh, pv, vbits, lane, r, t);
#pragma unroll
    for (int j = 0; j < P3; ++j) r[j] = lane == j ? r[j] * (1.0f + kLambda) + 1e-8f : r[j];
    chol<P3, true>(r, t, di, dp, lane);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float rn = p[s] + dp[s] * pv[s];
      const float cn = p[S + s] + dp[S + s] * pv[s];
      p[s] = pv[s] > 0.0f ? nclip(rn, -2.0f, (float)(h + 1)) : rn;
      p[S + s] = pv[s] > 0.0f ? nclip(cn, -2.0f, (float)(w + 1)) : cn;
      p[2 * S + s] = nmax(p[2 * S + s] + dp[2 * S + s] * pv[s], 0.0f);
    }
  }

  // Final covariance and MOMF correction.
  eval_axes<S, K>(a, Fu, Fv, p, ax, lane);
  normal_eq<S, K, true>(a, img0, sw, ax, xt, msh, a.img + base, a.miniw + base, p, fap, lane);
  load_row<S>(msh, pv, vbits, lane, r, t);
  float dmax = __shfl_sync(kFull, r[0], 0);
#pragma unroll
  for (int i = 1; i < P3; ++i) dmax = nmax(dmax, __shfl_sync(kFull, r[i], i));
  const float ridge = 1e-6f * nmax(dmax, 1.0f);
#pragma unroll
  for (int j = 0; j < P3; ++j) r[j] = lane == j ? r[j] + ridge : r[j];
  chol<P3, false>(r, t, di, dp, lane);
  float var_t = 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) {             // diag(A^-1)[kk] = |(L^-1)[:, kk]|^2
    const int kk = 2 * S + s;
    float y = lane == kk ? 1.0f : 0.0f;     // lane i: the rhs e_kk, then its update
    float var = 0.0f;
#pragma unroll
    for (int j = kk; j < P3; ++j) {
      const float xj = __shfl_sync(kFull, y, j) * di[j];
      var += xj * xj;
      y = lane > j ? y - r[j] * xj : y;
    }
    var_t += var * a.onehot[(size_t)b * S + s];
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < P3; ++i) a.params[(size_t)b * P3 + i] = p[i];
    a.flux_ap[b] = fap;
    a.fluxvar[b] = var_t;
  }
}

template <int S, int K>
int launch(const Args& a, int warps, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  auto bytes = [&](int nw) {
    return sizeof(float) *
           ((size_t)table_floats(K, a.Lzu, a.Lzv) + (size_t)nw * warp_floats(S, K, a.h, a.w));
  };
  while (warps > 1 && bytes(warps) > (size_t)optin) --warps;
  const size_t smem = bytes(warps);
  e = cudaFuncSetAttribute(psf_warm_fit_kernel<S, K>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (a.B + warps - 1) / warps;
  psf_warm_fit_kernel<S, K><<<(unsigned)blocks, warps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int S>
int launch_k(const Args& a, int K, int warps, cudaStream_t stream) {
  switch (K) {
    case 1: return launch<S, 1>(a, warps, stream);
    case 2: return launch<S, 2>(a, warps, stream);
    case 3: return launch<S, 3>(a, warps, stream);
    default: return launch<S, 4>(a, warps, stream);
  }
}

}  // namespace

// warps: instances per block (1..8), fewer where the shared memory of that
// many does not fit one block.
extern "C" int psf_warm_fit(const float* img, const float* bkg, const uint8_t* miniw,
                            const float* p0, const uint8_t* valid, const float* onehot,
                            const float* Fu, const float* Fv, float* params, float* flux_ap,
                            float* fluxvar, long long B, int h, int w, int S, int K, int os,
                            int bu_lo, int bu_hi, int L0u, int Lzu, float cy, int bv_lo,
                            int bv_hi, int L0v, int Lzv, float cx, int n_iters,
                            float var_const, float cutoff, int warps, void* stream) {
  if (B <= 0 || B > 0x7fffffffLL || h < 1 || w < 1 || h > kHWMax || w > kHWMax || K < 1 ||
      K > kKMax || os < 1 || S < 1 || S > kSMax || n_iters < 0 || warps < 1 ||
      warps > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  const Args a{img, bkg, miniw, p0, valid, onehot, Fu, Fv, params, flux_ap, fluxvar, B, h, w,
               os, bu_lo, bu_hi, L0u, Lzu, cy, bv_lo, bv_hi, L0v, Lzv, cx, n_iters,
               var_const, cutoff * cutoff};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (S) {
    case 1: return launch_k<1>(a, K, warps, s);
    case 2: return launch_k<2>(a, K, warps, s);
    case 3: return launch_k<3>(a, K, warps, s);
    case 4: return launch_k<4>(a, K, warps, s);
    case 5: return launch_k<5>(a, K, warps, s);
    case 6: return launch_k<6>(a, K, warps, s);
    case 7: return launch_k<7>(a, K, warps, s);
    default: return launch_k<8>(a, K, warps, s);
  }
}
