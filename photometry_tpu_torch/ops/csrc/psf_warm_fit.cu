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
// instance and reads its (h, w) stamp row-major: lanes stride its pixels
// (<= 32 each), every lane keeps the 3S(3S+1)/2 + 3S partial sums of JtJ
// and Jtg in registers, and one xor butterfly of warp shuffles adds them.
// Float addition commutes, so the butterfly leaves the same bits in every
// lane, and each lane then runs the small Cholesky, the solve and the
// update redundantly in registers: no shared-memory round trip and no
// divergence.  S (1..8) and K (1..4) are template parameters, so every
// register array is indexed by constants.
//
// What bounds it.  Operations: per instance and iteration about
// 3S(3S+1)/2 + 3S multiply-adds per pixel for the normal equations plus
// 3K per star and pixel for the render; the bytes (one stamp of images,
// backgrounds and mask, a few hundred bytes of parameters) are two orders
// below the card's ridge point.  S = 8 needs ~300 accumulators a thread
// and spills; S <= 5 (the production pad) fits the 255-register budget.
// No tensor cores are used.  Offsets into the (B, h, w) inputs are 64-bit.
//
// Float order differs from the JAX kernel and the plain torch fitter
// (pixels summed per lane then by butterfly; a left-looking Cholesky like
// the TPU kernel's), so results agree to float32 reduction order, not bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kKMax = 4;
constexpr int kSMax = 8;
constexpr int kHWMax = 32;
constexpr int kWarps = 4;                  // instances per block
constexpr int kThreads = kWarps * 32;
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

__device__ __forceinline__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// One axis query row i of one star: K values and K derivatives, written
// with stride `stride` (the axis length) between the k terms.
template <int K>
__device__ __forceinline__ void axis_row(const float* __restrict__ F, int os, int b_lo, int b_hi,
                                         int L0, float center, float coord, int i, float* val,
                                         float* dval, int stride) {
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
    val[k * stride] = ok ? a : 0.0f;
    dval[k * stride] = ok ? d * (float)(-os) : 0.0f;
  }
}

// Per-warp shared memory: img0[h*w], wgt[h*w], then the axis values
// u, du (S*K rows of h) and v, dv (S*K rows of w).
template <int S, int K>
__device__ __forceinline__ void eval_axes(const Args& a, const float* Fu, const float* Fv,
                                          const float (&p)[3 * S], float* ax, int lane) {
  const int h = a.h, w = a.w;
  float* u = ax;
  float* du = u + S * K * h;
  float* v = du + S * K * h;
  float* dv = v + S * K * w;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (lane < h)
      axis_row<K>(Fu, a.os, a.bu_lo, a.bu_hi, a.L0u, a.cy, p[s], lane, u + s * K * h + lane,
                  du + s * K * h + lane, h);
    if (lane < w)
      axis_row<K>(Fv, a.os, a.bv_lo, a.bv_hi, a.L0v, a.cx, p[S + s], lane, v + s * K * w + lane,
                  dv + s * K * w + lane, w);
  }
  __syncwarp();
}

// Weighted normal equations at p, reduced over the warp: acc holds the
// packed lower triangle of JtJ, jtg = Jt(img0 - model); with kFinal, fap
// gets the MOMF residual sum over the pixels where mw is set and the
// image x is finite.
template <int S, int K, bool kFinal>
__device__ __forceinline__ void normal_eq(const Args& a, const float* img0, const float* wgt,
                                          const float* ax, const float* __restrict__ x,
                                          const uint8_t* __restrict__ mw,
                                          const float (&p)[3 * S], const float (&pv)[S],
                                          float (&acc)[3 * S * (3 * S + 1) / 2],
                                          float (&jtg)[3 * S], float& fap, int lane) {
  constexpr int P3 = 3 * S;
  constexpr int NT = P3 * (P3 + 1) / 2;
  const int h = a.h, w = a.w;
  const float* u = ax;
  const float* du = u + S * K * h;
  const float* v = du + S * K * h;
  const float* dv = v + S * K * w;
#pragma unroll
  for (int e = 0; e < NT; ++e) acc[e] = 0.0f;
#pragma unroll
  for (int i = 0; i < P3; ++i) jtg[i] = 0.0f;
  fap = 0.0f;
  const int npix = h * w;
  for (int pix = lane; pix < npix; pix += 32) {
    const int r = pix / w;
    const int c = pix - r * w;
    float A[P3];
    float mdl = 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float dr = (float)r - p[s];
      const float dc = (float)c - p[S + s];
      const bool cut = __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(dc, dc)) < a.cutoff2;
      float q = 0.0f, qr = 0.0f, qc = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float uu = u[(s * K + k) * h + r], dd = du[(s * K + k) * h + r];
        const float vv = v[(s * K + k) * w + c], ee = dv[(s * K + k) * w + c];
        q += uu * vv;
        qr += dd * vv;
        qc += uu * ee;
      }
      if (!cut) q = qr = qc = 0.0f;
      const float f = p[2 * S + s];
      mdl += q * f;
      A[s] = qr * f;
      A[S + s] = qc * f;
      A[2 * S + s] = q;
    }
    const float wt = wgt[pix];
    const float diff = img0[pix] - mdl;
#pragma unroll
    for (int i = 0; i < P3; ++i) {
      const float awi = A[i] * wt;
#pragma unroll
      for (int j = 0; j <= i; ++j) acc[tri(i, j)] += awi * A[j];
      jtg[i] += awi * diff;
    }
    if (kFinal) fap += (mw[pix] && isfinite(x[pix])) ? diff : 0.0f;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int e = 0; e < NT; ++e) acc[e] += __shfl_xor_sync(kFull, acc[e], off);
#pragma unroll
    for (int i = 0; i < P3; ++i) jtg[i] += __shfl_xor_sync(kFull, jtg[i], off);
    if (kFinal) fap += __shfl_xor_sync(kFull, fap, off);
  }
  // dummy-star rows and columns frozen:
#pragma unroll
  for (int i = 0; i < P3; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) acc[tri(i, j)] = acc[tri(i, j)] * pv[i % S] * pv[j % S];
    jtg[i] *= pv[i % S];
  }
}

// In-place left-looking Cholesky of the packed lower triangle, with the
// max(d, 1e-30) pivot clamp of ops/smallsolve.py.
template <int P3>
__device__ __forceinline__ void chol(float (&L)[P3 * (P3 + 1) / 2], bool damp) {
#pragma unroll
  for (int j = 0; j < P3; ++j) {
    float ajj = L[tri(j, j)];
    if (damp) ajj = ajj * (1.0f + kLambda) + 1e-8f;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < j; ++k) s += L[tri(j, k)] * L[tri(j, k)];
    const float ljj = sqrtf(nmax(ajj - s, 1e-30f));
    L[tri(j, j)] = ljj;
    const float inv = 1.0f / ljj;
#pragma unroll
    for (int i = j + 1; i < P3; ++i) {
      float t = 0.0f;
#pragma unroll
      for (int k = 0; k < j; ++k) t += L[tri(i, k)] * L[tri(j, k)];
      L[tri(i, j)] = (L[tri(i, j)] - t) * inv;
    }
  }
}

template <int S, int K>
__global__ void __launch_bounds__(kThreads) psf_warm_fit_kernel(const Args a) {
  constexpr int P3 = 3 * S;
  constexpr int NT = P3 * (P3 + 1) / 2;
  extern __shared__ float smem[];
  const int h = a.h, w = a.w, npix = a.h * a.w;
  float* Fu = smem;
  float* Fv = Fu + a.Lzu * K;
  for (int e = threadIdx.x; e < a.Lzu * K; e += kThreads) Fu[e] = a.Fu[e];
  for (int e = threadIdx.x; e < a.Lzv * K; e += kThreads) Fv[e] = a.Fv[e];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + warp;
  if (b >= a.B) return;                     // whole warps leave; no block sync follows
  const int per_warp = 2 * npix + 2 * S * K * (h + w);
  float* img0 = Fv + a.Lzv * K + warp * per_warp;
  float* wgt = img0 + npix;
  float* ax = wgt + npix;

  const size_t base = (size_t)b * (size_t)npix;
  for (int pix = lane; pix < npix; pix += 32) {
    const float x = a.img[base + pix];
    const bool good = isfinite(x);
    const float x0 = good ? x : 0.0f;
    const float var = fabsf(x0 + a.bkg[base + pix]) + a.var_const;
    img0[pix] = x0;
    wgt[pix] = good ? 1.0f / nmax(var, 1e-9f) : 0.0f;
  }
  float p[P3], pv[S], jtg[P3], acc[NT], fap;
#pragma unroll
  for (int i = 0; i < P3; ++i) p[i] = a.p0[(size_t)b * P3 + i];
#pragma unroll
  for (int s = 0; s < S; ++s) pv[s] = a.valid[(size_t)b * S + s] ? 1.0f : 0.0f;
  __syncwarp();

  for (int it = 0; it < a.n_iters; ++it) {
    eval_axes<S, K>(a, Fu, Fv, p, ax, lane);
    normal_eq<S, K, false>(a, img0, wgt, ax, nullptr, nullptr, p, pv, acc, jtg, fap, lane);
    chol<P3>(acc, true);
#pragma unroll
    for (int i = 0; i < P3; ++i) {          // L y = Jtg
      float t = jtg[i];
#pragma unroll
      for (int k = 0; k < i; ++k) t -= acc[tri(i, k)] * jtg[k];
      jtg[i] = t / acc[tri(i, i)];
    }
#pragma unroll
    for (int i = P3 - 1; i >= 0; --i) {     // L^T dp = y
      float t = jtg[i];
#pragma unroll
      for (int k = i + 1; k < P3; ++k) t -= acc[tri(k, i)] * jtg[k];
      jtg[i] = t / acc[tri(i, i)];
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float rn = p[s] + jtg[s] * pv[s];
      const float cn = p[S + s] + jtg[S + s] * pv[s];
      p[s] = pv[s] > 0.0f ? nclip(rn, -2.0f, (float)(h + 1)) : rn;
      p[S + s] = pv[s] > 0.0f ? nclip(cn, -2.0f, (float)(w + 1)) : cn;
      p[2 * S + s] = nmax(p[2 * S + s] + jtg[2 * S + s] * pv[s], 0.0f);
    }
    __syncwarp();                           // all lanes done reading ax
  }

  // Final covariance and MOMF correction.
  eval_axes<S, K>(a, Fu, Fv, p, ax, lane);
  normal_eq<S, K, true>(a, img0, wgt, ax, a.img + base, a.miniw + base, p, pv, acc, jtg, fap,
                        lane);
  float dmax = acc[tri(0, 0)];
#pragma unroll
  for (int i = 1; i < P3; ++i) dmax = nmax(dmax, acc[tri(i, i)]);
  const float ridge = 1e-6f * nmax(dmax, 1.0f);
#pragma unroll
  for (int i = 0; i < P3; ++i) acc[tri(i, i)] += ridge;
  chol<P3>(acc, false);
  float var_t = 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) {             // diag(A^-1)[kk] = |(L^-1)[:, kk]|^2
    const int kk = 2 * S + s;
    float x[P3];
    float var = 0.0f;
#pragma unroll
    for (int i = kk; i < P3; ++i) {
      float t = i == kk ? 1.0f : 0.0f;
#pragma unroll
      for (int k = kk; k < i; ++k) t -= acc[tri(i, k)] * x[k];
      x[i] = t / acc[tri(i, i)];
      var += x[i] * x[i];
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
int launch(const Args& a, cudaStream_t stream) {
  const int per_warp = 2 * a.h * a.w + 2 * S * K * (a.h + a.w);
  const size_t smem = sizeof(float) * ((size_t)(a.Lzu + a.Lzv) * K + (size_t)kWarps * per_warp);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        psf_warm_fit_kernel<S, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (a.B + kWarps - 1) / kWarps;
  psf_warm_fit_kernel<S, K><<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int S>
int launch_k(const Args& a, int K, cudaStream_t stream) {
  switch (K) {
    case 1: return launch<S, 1>(a, stream);
    case 2: return launch<S, 2>(a, stream);
    case 3: return launch<S, 3>(a, stream);
    default: return launch<S, 4>(a, stream);
  }
}

}  // namespace

extern "C" int psf_warm_fit(const float* img, const float* bkg, const uint8_t* miniw,
                            const float* p0, const uint8_t* valid, const float* onehot,
                            const float* Fu, const float* Fv, float* params, float* flux_ap,
                            float* fluxvar, long long B, int h, int w, int S, int K, int os,
                            int bu_lo, int bu_hi, int L0u, int Lzu, float cy, int bv_lo,
                            int bv_hi, int L0v, int Lzv, float cx, int n_iters,
                            float var_const, float cutoff, void* stream) {
  if (B <= 0 || (B + kWarps - 1) / kWarps > 0x7fffffffLL || h < 1 || w < 1 || h > kHWMax ||
      w > kHWMax || K < 1 || K > kKMax || os < 1 || S < 1 || S > kSMax || n_iters < 0)
    return (int)cudaErrorInvalidValue;
  const Args a{img, bkg, miniw, p0, valid, onehot, Fu, Fv, params, flux_ap, fluxvar, B, h, w,
               os, bu_lo, bu_hi, L0u, Lzu, cy, bv_lo, bv_hi, L0v, Lzv, cx, n_iters,
               var_const, cutoff * cutoff};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (S) {
    case 1: return launch_k<1>(a, K, s);
    case 2: return launch_k<2>(a, K, s);
    case 3: return launch_k<3>(a, K, s);
    case 4: return launch_k<4>(a, K, s);
    case 5: return launch_k<5>(a, K, s);
    case 6: return launch_k<6>(a, K, s);
    case 7: return launch_k<7>(a, K, s);
    default: return launch_k<8>(a, K, s);
  }
}
