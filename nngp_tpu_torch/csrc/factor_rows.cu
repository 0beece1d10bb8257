// Compressed Vecchia factor rows, two entries over one row body.
//
// For each (chain, row) the conditional of position 0 given positions 1..m
// of the (m+1) x (m+1) neighbour-set correlation K:
//   L L' = K[1:, 1:],  u = L^-1 K[1:, 0],  d = max(K[0][0] - u'u, d_floor),
//   z = L'^-1 u,       row = [1/sqrt(d), -z_j / sqrt(d) * mask[r][1+j]],
// with the padded positions of row r (mask 0) forced to identity first.
//
//   factor_rows_launch   K given: K [B, k, k] f32 (B = chains x rows).
//   factor_build_launch  K never written: each entry is computed where the
//                        row body consumes it, from the host-f64 squared
//                        distances nn_dist2 [n, k, k, G] f32 (G range
//                        groups) and the natural shape params [C, n_shape]
//                        (the G ranges, then Matérn's nu), for the rows
//                        0..R-1 or a row list (halo mode).
//
// Replaces nngp_tpu's vecchia_linv (nngp_tpu/ops/vecchia.py:116, the rows
// :83, the correlation ops/covariance.py:145 with Matérn's _matern :273 and
// ops/bessel.py:145 kv) as the sampler runs it: inside the jitted
// gibbs_iteration (nngp_tpu/models/gaussian.py:805), where XLA fuses the
// correlation and the factor arithmetic into one pass and each
// multiply-subtract of the unrolled Cholesky, the two solves and
// d = 1 - u'u into one rounding.  It is not a Pallas kernel: it is the
// counterpart of XLA's fusion.
//
// Row body (factor_row): nngp_tpu_torch/ops/vecchia.py:linv_rows_reference
// op for op: Cholesky sums in increasing t, the pivot clamped at 1e-12
// before sqrtf, 1/L[j][j] then a multiply, the solves' divisions, d floored
// at d_floor; each s - a*b is one fmaf(-a, b, s); sqrtf and the divisions
// are IEEE (nvcc's -prec-sqrt and -prec-div defaults; no fast-math).  m = 0
// gives rows of 1.
//
// Correlation (factor_build): ops/covariance.py:correlation_from_sqdist op
// for op, on the CUDA math library's expf, logf, sinhf, coshf and sqrtf:
// d2 = sum_g d2g[g] / (r_g * r_g) in increasing g, d = sqrtf(max(d2, 0)),
// then expf(-d) or the Matérn of ops/covariance.py:_matern (the
// complementary series at d <= 0.29, 2^(1-nu)/Gamma(nu) d^nu K_nu(d)
// beyond, exactly 1 at d <= 1e-8) with K_nu by ops/bessel.py (Temme's
// series at d <= 2, Steed's CF2 beyond, the upward recurrence).  Every
// product, sum and quotient of the correlation is pinned with __fmul_rn,
// __fadd_rn, __fsub_rn and __fdiv_rn, so nvcc contracts none of them into
// an fma and the order is the twin's as PyTorch's CUDA kernels evaluate it
// (one rounding an op; a tensor divided by a Python number is a multiply by
// its float reciprocal there, and n / x is (1 / x) * n).  Padded pairs take
// the identity without an evaluation; the diagonal is 1 (the twin's
// K * valid2 + eye * (1 - valid2) at d = 0).  CF2's per-lane freeze is a
// break: a frozen lane's h and s never change again.  The per-chain Matérn
// quantities (mu, l, the Chebyshev Gamma ratios, lgamma, the series' g)
// are computed once a chain in each block, by one thread, in the twin's
// order (matern_chain), so the build stays one launch.
//
// Bound.  factor_rows reads K once and writes the rows: (k^2 + k) x 4 bytes
// a (chain, row), 168 B at m = 5.  factor_build reads the geometry once,
// n (k^2 G + k) x 4 bytes, and writes C R k x 4: 15.4 MB at 3 chains and
// 64,274 rows (4.6 us at 3.35 TB/s), 158.9 MB at 96 chains; the exponential
// correlation's 15 evaluations a (chain, row) at m = 5 are far below that.
// Matérn's Bessel (20 series terms or up to 40 CF2 steps an evaluation)
// makes it bound by operations.  Design: one thread a (chain, row), with L,
// u and z in registers (m is a template parameter, every loop unrolled).
// factor_rows stages its slab of K through shared memory with coalesced
// loads (row stride k^2 | 1, odd, so the threads' reads fall in distinct
// banks) and its rows back the same way.  factor_build stages its T rows'
// nn_dist2 slab the same way (stride k^2 G | 1) once, then loops over a
// group of chains (blockIdx.y), so the geometry is read once a chain group
// and not once a chain; each chain's rows go out through shared memory.
// Matérn's evaluation is one out-of-line function, so the unrolled body
// calls it and does not repeat it.
//
// Build: whole, or in parts selected by FACTOR_PART (a bit mask: 1 the
// K-input entry, 2 the fused build's exponential instantiations, 4 its
// Matérn ones) and FACTOR_M (the one m instantiated; all of 0..16 when it
// is -1), so that a caller builds, in seconds, only the part and the m it
// runs (ops/vecchia.py:_factor_library).  Built whole it takes minutes.

#include <cuda_runtime.h>

#include <type_traits>

#ifndef FACTOR_PART
#define FACTOR_PART 7
#endif
#ifndef FACTOR_M
#define FACTOR_M -1
#endif

namespace {

constexpr int kPart = FACTOR_PART;
constexpr int kMaxM = 16;
// The per-chain Matérn quantities (matern_chain): nu, mu = nu - l, l,
// fact = pi mu / sin(pi mu), gam1, gam2, 1/Gamma(1+mu), 1/Gamma(1-mu),
// lognorm = (1 - nu) ln 2 - lgamma(nu), g = Gamma(1-nu)/Gamma(1+nu).
constexpr int kMaternConsts = 10;
// Enough blocks for about four waves of the 132 SMs before chains are
// grouped into one block.
constexpr long long kTargetBlocks = 132 * 16;

// One rounding an op, never contracted into an fma.
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}

// The row body: kef(i, j) is entry (i, j) of the identity-forced K
// (i >= j), mv the row's mask, out its k entries.
template <int M, class Kef>
__device__ __forceinline__ void factor_row(const Kef& kef, const float* mv,
                                           float d_floor, float* out) {
  if constexpr (M == 0) {
    out[0] = 1.0f;
  } else {
    float L[M][M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      float s = kef(1 + j, 1 + j);
#pragma unroll
      for (int q = 0; q < j; ++q) s = fmaf(-L[j][q], L[j][q], s);
      s = s < 1e-12f ? 1e-12f : s;
      L[j][j] = sqrtf(s);
      const float inv_ljj = 1.0f / L[j][j];
#pragma unroll
      for (int i = j + 1; i < M; ++i) {
        float s2 = kef(1 + i, 1 + j);
#pragma unroll
        for (int q = 0; q < j; ++q) s2 = fmaf(-L[i][q], L[j][q], s2);
        L[i][j] = s2 * inv_ljj;
      }
    }
    float u[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float s = kef(1 + i, 0);
#pragma unroll
      for (int q = 0; q < i; ++q) s = fmaf(-L[i][q], u[q], s);
      u[i] = s / L[i][i];
    }
    float d = kef(0, 0);
#pragma unroll
    for (int j = 0; j < M; ++j) d = fmaf(-u[j], u[j], d);
    d = d < d_floor ? d_floor : d;
    float z[M];
#pragma unroll
    for (int i = M - 1; i >= 0; --i) {
      float s = u[i];
#pragma unroll
      for (int q = i + 1; q < M; ++q) s = fmaf(-L[q][i], z[q], s);
      z[i] = s / L[i][i];
    }
    const float inv_sqrt_d = 1.0f / sqrtf(d);
    out[0] = inv_sqrt_d;
#pragma unroll
    for (int j = 0; j < M; ++j) out[1 + j] = -z[j] * inv_sqrt_d * mv[1 + j];
  }
}

// ---- factor_rows: K given ---------------------------------------------------

// Threads a block: as many as keep the staged K under 48 KB of static
// shared memory.
template <int M>
__host__ __device__ constexpr int block_threads() {
  constexpr int pad = ((M + 1) * (M + 1)) | 1;
  return pad * 128 * 4 <= 48 * 1024 ? 128 : pad * 64 * 4 <= 48 * 1024 ? 64 : 32;
}

template <int M>
__global__ void __launch_bounds__(block_threads<M>())
factor_rows_kernel(const float* __restrict__ K, const float* __restrict__ mask,
                   float* __restrict__ rows, long long B, int R,
                   float d_floor) {
  constexpr int k = M + 1, kk = k * k, pad = kk | 1, ko = k | 1;
  constexpr int T = block_threads<M>();
  __shared__ float sK[T * pad];

  const long long b0 = (long long)blockIdx.x * T;
  const int nb = (int)(B - b0 < T ? B - b0 : T);
  const float* src = K + b0 * kk;
  for (int e = threadIdx.x; e < nb * kk; e += T) {
    const int r = e / kk;
    sK[r * pad + (e - r * kk)] = src[e];
  }
  __syncthreads();

  const int t = threadIdx.x;
  float out[k];
  if (t < nb) {
    const float* Kt = sK + t * pad;
    const float* mk = mask + (long long)((b0 + t) % R) * k;
    float mv[k];
#pragma unroll
    for (int j = 0; j < k; ++j) mv[j] = mk[j];
    // K * valid2 + eye * (1 - valid2)
    auto kef = [&](int i, int j) {
      const float v = mv[i] * mv[j];
      return Kt[i * k + j] * v + (i == j ? 1.0f : 0.0f) * (1.0f - v);
    };
    factor_row<M>(kef, mv, d_floor, out);
  }
  __syncthreads();   // every thread has read its K: reuse sK for the rows
  if (t < nb) {
#pragma unroll
    for (int j = 0; j < k; ++j) sK[t * ko + j] = out[j];
  }
  __syncthreads();
  float* dst = rows + b0 * k;
  for (int e = threadIdx.x; e < nb * k; e += T) {
    const int r = e / k;
    dst[e] = sK[r * ko + (e - r * k)];
  }
}

template <int M>
cudaError_t launch_rows(const float* K, const float* mask, float* rows,
                        long long B, int R, float d_floor, cudaStream_t st) {
  constexpr int T = block_threads<M>();
  const long long blocks = (B + T - 1) / T;
  factor_rows_kernel<M><<<(unsigned int)blocks, T, 0, st>>>(K, mask, rows, B,
                                                             R, d_floor);
  return cudaGetLastError();
}

// ---- the Matérn correlation (ops/covariance.py:_matern, ops/bessel.py) ----

struct Matern {
  float nu, mu, fact, gam1, gam2, gampl, gammi, lognorm, g;
  int l;
};

constexpr float kPi = (float)3.14159265358979323846;
constexpr float kLn2 = (float)0.69314718055994530942;

// ops/bessel.py _chebev: Clenshaw's d, dd = 2 x d - dd + c, d over the
// coefficients N-1..1, then x d - dd + c0 / 2 (c0half, that product
// rounded once, as Python computes it before torch adds it).
template <int N>
__device__ __forceinline__ float chebev(const float* c, float c0half,
                                        float x) {
  float d = 0.0f, dd = 0.0f;
#pragma unroll
  for (int i = N - 1; i >= 1; --i) {
    const float t = add(sub(mul(mul(x, 2.0f), d), dd), c[i]);
    dd = d;
    d = t;
  }
  return add(sub(mul(x, d), dd), c0half);
}

// ops/bessel.py _beschb: gam1, gam2, 1/Gamma(1+mu), 1/Gamma(1-mu), from
// the Chebyshev coefficients _C1, _C2, each rounded to float as torch adds
// a Python number to a float32 tensor.
__device__ void beschb(float mu, float& gam1, float& gam2, float& gampl,
                       float& gammi) {
  const float c1[7] = {
      -1.142022680371168e0, 6.5165112670737e-3, 3.087090173086e-4,
      -3.4706269649e-6, 6.9437664e-9, 3.67795e-11, -1.356e-13};
  const float c2[8] = {
      1.843740587300905e0, -7.68528408447867e-2, 1.2719271366546e-3,
      -4.9717367042e-6, -3.31261198e-8, 2.423096e-10, -1.702e-13, -1.49e-15};
  const float xx = sub(mul(mul(mu, 8.0f), mu), 1.0f);
  gam1 = chebev<7>(c1, (float)(0.5 * -1.142022680371168e0), xx);
  gam2 = chebev<8>(c2, (float)(0.5 * 1.843740587300905e0), xx);
  gampl = sub(gam2, mul(mu, gam1));
  gammi = add(gam2, mul(mu, gam1));
}

// The per-chain quantities at smoothness nu, in the twin's order:
// ops/bessel.py kv's split nu = mu + l and _temme_small_x's fact,
// ops/covariance.py _matern's lognorm and _matern_comp_small's g.
__device__ void matern_chain(float nu, float* q) {
  const float l = floorf(add(nu, 0.5f));
  const float mu = sub(nu, l);
  float gam1, gam2, gampl, gammi;
  beschb(mu, gam1, gam2, gampl, gammi);
  const float pimu = mul(mu, kPi);
  const float fact = fabsf(pimu) < 1e-12f ? 1.0f : dvd(pimu, sinf(pimu));
  const float lognorm = sub(mul(sub(1.0f, nu), kLn2), lgammaf(nu));
  const float mu2 = sub(1.0f, nu);
  float u1, u2, gampl2, gammi2;
  beschb(mu2, u1, u2, gampl2, gammi2);
  const float g = dvd(gammi2, mul(mul(mu2, sub(1.0f, mu2)), gampl2));
  const float v[kMaternConsts] = {nu, mu, l, fact, gam1, gam2, gampl, gammi,
                                  lognorm, g};
#pragma unroll
  for (int i = 0; i < kMaternConsts; ++i) q[i] = v[i];
}

// K_mu(x), K_{mu+1}(x) for x <= 2, Temme's series (ops/bessel.py
// _temme_small_x, 20 terms).
__device__ void temme_small_x(float x, const Matern& c, float& k0, float& k1) {
  const float x2 = mul(0.5f, x);
  const float dl = -logf(x2);
  float e = mul(c.mu, dl);
  const float fact2 = fabsf(e) < 1e-12f ? 1.0f : dvd(sinhf(e), e);
  float ff = mul(c.fact,
                 add(mul(c.gam1, coshf(e)), mul(mul(c.gam2, fact2), dl)));
  float total = ff;
  e = expf(e);
  float p = dvd(mul(0.5f, e), c.gampl);
  float q = mul(dvd(1.0f, mul(e, c.gammi)), 0.5f);
  float cc = 1.0f;
  const float d2 = mul(x2, x2);
  float total1 = p;
  const float mm = mul(c.mu, c.mu);
  for (int i = 1; i <= 20; ++i) {
    const float fi = (float)i;
    ff = dvd(add(add(mul(fi, ff), p), q), sub(fi * fi, mm));
    cc = mul(mul(cc, d2), 1.0f / fi);
    p = dvd(p, sub(fi, c.mu));
    q = dvd(q, add(c.mu, fi));
    total = add(total, mul(cc, ff));
    total1 = add(total1, mul(cc, sub(p, mul(fi, ff))));
  }
  k0 = total;
  k1 = mul(total1, mul(dvd(1.0f, x), 2.0f));
}

// K_mu(x), K_{mu+1}(x) for x > 2, Steed's CF2 (ops/bessel.py _cf2_large_x,
// at most 40 steps, renormalized every step, frozen once the series
// increment is negligible).
__device__ void cf2_large_x(float x, const Matern& c, float& k0, float& k1) {
  float b = mul(add(x, 1.0f), 2.0f);
  float d = dvd(1.0f, b);
  float h = d, delh = d;
  float q1 = 0.0f, q2 = 1.0f;
  const float a1 = sub(0.25f, mul(c.mu, c.mu));
  float q = a1, cc = a1, a = -a1;
  float s = add(mul(q, delh), 1.0f);
  for (int i = 2; i < 42; ++i) {
    a = sub(a, 2.0f * (float)(i - 1));
    cc = mul(mul(-a, cc), 1.0f / (float)i);
    const float qnew = dvd(sub(q1, mul(b, q2)), a);
    q1 = q2;
    q2 = qnew;
    q = add(q, mul(cc, qnew));
    const float r = fmaxf(fabsf(cc), 1e-30f);
    cc = dvd(cc, r);
    q1 = mul(q1, r);
    q2 = mul(q2, r);
    b = add(b, 2.0f);
    float denom = add(b, mul(a, d));
    denom = fabsf(denom) < 1e-30f ? 1e-30f : denom;
    d = dvd(1.0f, denom);
    const float delh_new = mul(sub(mul(b, d), 1.0f), delh);
    const float dels = mul(q, delh_new);
    delh = delh_new;
    h = add(h, delh_new);
    const float s_new = add(s, dels);
    s = s_new;
    if (fabsf(dels) < mul(1e-8f, fabsf(s_new))) break;
  }
  h = mul(a1, h);
  const float kmu =
      dvd(mul(sqrtf(mul(dvd(1.0f, mul(x, 2.0f)), kPi)), expf(-x)), s);
  k0 = kmu;
  k1 = dvd(mul(kmu, sub(add(add(c.mu, x), 0.5f), h)), x);
}

// 1 - C(x) for x <= 0.29, the ascending series (ops/covariance.py
// _matern_comp_small).
__device__ float matern_comp_small(float x, const Matern& c) {
  const float q = mul(mul(0.25f, x), x);
  float t2 = 1.0f, S2 = 1.0f;
  float t1 = dvd(q, sub(1.0f, c.nu));
  float S1 = t1;
  for (int k = 1; k < 6; ++k) {
    const float fk = (float)k;
    t2 = dvd(mul(t2, q), mul(add(c.nu, fk), fk));
    S2 = add(S2, t2);
    if (k >= 2) {
      t1 = dvd(mul(t1, q), mul(sub(fk, c.nu), fk));
      S1 = add(S1, t1);
    }
  }
  const float xh = fmaxf(mul(0.5f, x), 1e-30f);
  return sub(mul(mul(c.g, expf(mul(mul(c.nu, 2.0f), logf(xh)))), S2), S1);
}

// The Matérn correlation at scaled distance d (ops/covariance.py:_matern);
// out of line, so the unrolled row body calls it.
__device__ __noinline__ float matern_corr(float d, Matern c) {
  if (d <= 1e-8f) return 1.0f;
  const float x = fmaxf(d, 1e-8f);
  if (x <= 0.29f) return sub(1.0f, matern_comp_small(x, c));
  float k0, k1;
  if (x <= 2.0f) {
    temme_small_x(fmaxf(x, 1e-30f), c, k0, k1);
  } else {
    cf2_large_x(x, c, k0, k1);
  }
  // upward recurrence K_{j+1} = K_{j-1} + 2 (mu + j) / x K_j up to l
  for (int j = 1; j <= c.l; ++j) {
    const float k2 = add(k0, mul(dvd(mul(add(c.mu, (float)j), 2.0f), x), k1));
    k0 = k1;
    k1 = k2;
  }
  return mul(expf(add(c.lognorm, mul(c.nu, logf(x)))), k0);
}

// ---- factor_build: K never written ------------------------------------------

template <int M, bool kMatern>
__global__ void __launch_bounds__(128)
factor_build_kernel(const float* __restrict__ d2g,
                    const float* __restrict__ mask,
                    const float* __restrict__ natural,
                    const long long* __restrict__ rows,
                    float* __restrict__ out, int C, int R, int G, int n_shape,
                    int chains_per_block, float d_floor) {
  constexpr int k = M + 1, ko = k | 1;
  const int kkG = k * k * G, pad = kkG | 1, T = blockDim.x;
  extern __shared__ float smem[];
  float* sD = smem;                    // [T][pad]  the rows' nn_dist2
  float* sO = sD + T * pad;            // [T][ko]   one chain's rows out
  float* sC = sO + T * ko;             // [G + kMaternConsts] the chain's

  const long long b0 = (long long)blockIdx.x * T;
  const int nb = (int)(R - b0 < T ? R - b0 : T);
  for (int e = threadIdx.x; e < nb * kkG; e += T) {
    const int r = e / kkG, off = e - r * kkG;
    const long long src = rows ? rows[b0 + r] : b0 + r;
    sD[r * pad + off] = d2g[src * kkG + off];
  }
  const int t = threadIdx.x;
  float mv[k];
  if (t < nb) {
    const long long src = rows ? rows[b0 + t] : b0 + t;
#pragma unroll
    for (int j = 0; j < k; ++j) mv[j] = mask[src * k + j];
  }
  const float* Dt = sD + t * pad;

  const int c0 = blockIdx.y * chains_per_block;
  const int c1 = c0 + chains_per_block < C ? c0 + chains_per_block : C;
  for (int c = c0; c < c1; ++c) {
    if (t < G) {
      const float r = natural[(long long)c * n_shape + t];
      sC[t] = mul(r, r);
    } else if (kMatern && t == G) {
      matern_chain(natural[(long long)c * n_shape + G], sC + G);
    }
    __syncthreads();   // the slab (first chain) and the chain's constants
    float res[k];
    if (t < nb) {
      Matern mc{};
      if constexpr (kMatern) {
        const float* q = sC + G;
        mc = Matern{q[0], q[1], q[3], q[4], q[5], q[6], q[7], q[8], q[9],
                    (int)q[2]};
      }
      auto kef = [&](int i, int j) -> float {
        if (i == j) return 1.0f;
        const float v = mv[i] * mv[j];
        if (v == 0.0f) return 0.0f;
        const float* p = Dt + (i * k + j) * G;
        float d2 = dvd(p[0], sC[0]);
        for (int g = 1; g < G; ++g) d2 = add(d2, dvd(p[g], sC[g]));
        const float d = sqrtf(fmaxf(d2, 0.0f));
        if constexpr (kMatern) {
          return mul(matern_corr(d, mc), v);
        } else {
          return mul(expf(-d), v);
        }
      };
      factor_row<M>(kef, mv, d_floor, res);
#pragma unroll
      for (int j = 0; j < k; ++j) sO[t * ko + j] = res[j];
    }
    __syncthreads();
    float* dst = out + ((long long)c * R + b0) * k;
    for (int e = t; e < nb * k; e += T) {
      const int r = e / k;
      dst[e] = sO[r * ko + (e - r * k)];
    }
    __syncthreads();   // sO and sC are reused by the next chain
  }
}

template <int M>
cudaError_t launch_build(bool matern, const float* d2g, const float* mask,
                         const float* natural, const long long* rows,
                         float* out, int C, int R, int G, int n_shape,
                         float d_floor, cudaStream_t st) {
  constexpr int k = M + 1, ko = k | 1;
  const long long pad = ((long long)k * k * G) | 1;
  auto smem = [&](int T) {
    return (size_t)(T * (pad + ko) + G + kMaternConsts) * sizeof(float);
  };
  int T = 128;
  while (T > 32 && smem(T) > 48 * 1024) T /= 2;
  const size_t bytes = smem(T);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  const long long bx = (R + T - 1) / T;
  long long ny = (kTargetBlocks + bx - 1) / bx;
  ny = ny < C ? ny : C;
  ny = ny < 65535 ? ny : 65535;
  const int per = (int)((C + ny - 1) / ny);
  const dim3 grid((unsigned int)bx, (unsigned int)((C + per - 1) / per));
  auto go = [&](auto kern) {
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (e != cudaSuccess) return e;
    }
    kern<<<grid, T, bytes, st>>>(d2g, mask, natural, rows, out, C, R, G,
                                 n_shape, per, d_floor);
    return cudaGetLastError();
  };
  if (matern) {
    if constexpr ((kPart & 4) != 0) return go(factor_build_kernel<M, true>);
  } else {
    if constexpr ((kPart & 2) != 0) return go(factor_build_kernel<M, false>);
  }
  return cudaErrorNotSupported;   // this part was built without it
}

// m -> the instantiation for M = m (those this build holds).
template <int M, class F>
cudaError_t dispatch(int m, F&& f) {
  if constexpr (FACTOR_M < 0 || M == FACTOR_M) {
    if (m == M) return f(std::integral_constant<int, M>{});
  }
  if constexpr (M < kMaxM) return dispatch<M + 1>(m, f);
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry points, bound with ctypes; each launches on `stream` and returns
// the CUDA error (0 = launched).  m neighbours, 0 <= m <= kMaxM (the
// wrapper's FACTOR_ROWS_MAX_M).

#if FACTOR_PART & 1
// B (chain, row) pairs of R rows each.
extern "C" int factor_rows_launch(const float* K, const float* mask,
                                  float* rows, long long B, int R, int m,
                                  float d_floor, void* stream) {
  if (m < 0 || m > kMaxM || R <= 0 || B <= 0 || B % R != 0)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch<0>(m, [&](auto M) {
    return launch_rows<decltype(M)::value>(K, mask, rows, B, R, d_floor,
                                           (cudaStream_t)stream);
  });
}
#endif

#if FACTOR_PART & 6
// out [C, R, m+1] from nn_dist2 [n, m+1, m+1, G], nn_mask [n, m+1] and
// natural [C, n_shape] (the G ranges, then nu when matern != 0); row r of
// the output is graph row rows[r], or r when rows is null.
extern "C" int factor_build_launch(const float* d2g, const float* mask,
                                   const float* natural, const long long* rows,
                                   float* out, int C, int R, int m, int G,
                                   int n_shape, int matern, float d_floor,
                                   void* stream) {
  if (m < 0 || m > kMaxM || C <= 0 || R <= 0 || G <= 0 ||
      n_shape < G + (matern ? 1 : 0))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch<0>(m, [&](auto M) {
    return launch_build<decltype(M)::value>(matern != 0, d2g, mask, natural,
                                            rows, out, C, R, G,
                                            n_shape, d_floor,
                                            (cudaStream_t)stream);
  });
}
#endif
