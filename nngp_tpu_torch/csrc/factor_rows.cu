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
//                        0..R-1 or a row list (halo mode).  The
//                        exponential families run in float32; the Matérn
//                        ones take float64 natural params, widen the
//                        distances (exactly) and run in float64 through
//                        K, the Cholesky and the solves, rounding each row
//                        entry once to float32.
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
// Row body (factor_row, on float or double values V):
// nngp_tpu_torch/ops/vecchia.py:linv_rows_reference op for op: Cholesky
// sums in increasing t, the pivot clamped at 1e-12 before the square root,
// 1/L[j][j] then a multiply, the solves' divisions, d floored at d_floor.
// In float each s - a*b is one fmaf(-a, b, s) (the twin's _msub: float32
// products are exact in float64, so only the subtraction rounds); in double
// it is __dmul_rn then __dsub_rn, two roundings, as _msub computes it on
// float64 tensors.  Square roots and divisions are IEEE (sqrtf and
// __fdiv_rn, nvcc's -prec-sqrt and -prec-div defaults; __dsqrt_rn and
// __ddiv_rn; no fast-math).  m = 0 gives rows of 1.
//
// Correlation (factor_build): d2 = sum_g d2g[g] / (r_g * r_g) in
// increasing g, d = sqrt(max(d2, 0)), then expf(-d) (float32, the CUDA
// math library's expf) or, in float64, the Matérn of
// ops/covariance.py:_matern (the complementary series at d <= 0.29,
// 2^(1-nu)/Gamma(nu) d^nu K_nu(d) beyond, exactly 1 at d <= 1e-8) with K_nu
// by ops/bessel.py's algorithms (Temme's 20-term series at d <= 2, Steed's
// CF2 beyond, frozen at 1e-10 as the float64 twin freezes it, the upward
// recurrence) on the CUDA math library's double exp, log, sinh, cosh, sin
// and lgamma.  Near singular (ranges at a few neighbour distances, nu near
// 1) the conditional variance d amplifies an ulp of K by 1/d, so a float32
// K, however accurate, decides the rows' error; hence Matérn's K stays in
// float64 through the Cholesky.  The distances, the exponential
// correlation, CF2 and the per-chain quantities follow
// ops/covariance.py:correlation_from_sqdist and ops/bessel.py op for op:
// each product, sum and quotient pinned with __fmul_rn / __dmul_rn,
// __fadd_rn / __dadd_rn, __fsub_rn / __dsub_rn and __fdiv_rn / __ddiv_rn,
// so nvcc contracts none of them into an fma and the order is the twin's as
// PyTorch's CUDA kernels evaluate it (one rounding an op; a tensor divided
// by a Python number is a multiply by its reciprocal there, and n / x is
// (1 / x) * n).  CF2 keeps the twin's algorithm and its divisions (its
// 1/denom depends on x; about a sixth of the pairs at the Heavy-metals
// fit's states lie beyond 2), and its per-lane freeze is a break: a frozen
// lane's h and s never change again.
//
// Where the Matérn evaluation reassociates: Temme's series and the
// complementary series carry no division.  Their divisors depend on the
// chain's nu alone, so each chain's coefficients (Temme's P_i = 1 / prod
// (j - mu), Q_i = 1 / prod (j + mu), W_i = 1 / (i^2 - mu^2) and 1/i; the
// series' 1/(1 - nu), 1/((nu + k) k), 1/((k - nu) k)) are built once in
// each block, an entry a thread (matern_tables), and the per-chain
// quantities (mu, l, the Chebyshev Gamma ratios, lgamma, the series' g) once
// for 32 chains, a lane a chain (matern_chain); so the build stays one
// launch.  An evaluation runs each term on multiplies and fmas against
// broadcast reads of those tables, takes 1/x once (K_{mu+1} and the
// recurrence), and after Temme's series closes with (2/Gamma(nu)) (x/2)^mu
// (x/2)^l K_nu, so it takes one log and no closing exp.  That moves K by
// about 1e-15 relative in float64 (tests/test_torch_matern.py holds the
// recurrences to the twin's within 1e-12), far below the one float32
// rounding of each row entry.  The kernel is held to its plain twin
// (ops/vecchia.py:vecchia_linv_reference on ops/bessel.py, the yardstick,
// unchanged) within BUILD_TOL = 1e-4 on the rows, and near singular to a
// float64 oracle's log-determinant within 1e-5 (tests/test_torch_cuda.py).
// Padded pairs take the identity without an evaluation; the diagonal is 1
// (the twin's K * valid2 + eye * (1 - valid2) at d = 0).
//
// Bound.  factor_rows reads K once and writes the rows: (k^2 + k) x 4 bytes
// a (chain, row), 168 B at m = 5.  factor_build reads the geometry once,
// n (k^2 G + k) x 4 bytes, and writes C R k x 4: 15.4 MB at 3 chains and
// 64,274 rows (4.6 us at 3.35 TB/s), 158.9 MB at 96 chains; the exponential
// correlation's 15 evaluations a (chain, row) at m = 5 are far below that.
// Matérn's Bessel in float64 (20 series terms or up to 40 CF2 steps an
// evaluation, on the card's float64 rate, half its float32 one, with no
// special-function unit) makes it bound by operations.  Design: one
// thread a (chain, row), with L, u and z in registers (m is a template
// parameter, every loop unrolled).
// factor_rows stages its slab of K through shared memory with coalesced
// loads (row stride k^2 | 1, odd, so the threads' reads fall in distinct
// banks) and its rows back the same way.  factor_build stages its T rows'
// nn_dist2 slab the same way (stride k^2 G | 1) once, then loops over a
// group of chains (blockIdx.y), so the geometry is read once a chain group
// and not once a chain; each chain's rows go out through shared memory.
// Matérn's evaluation is one out-of-line function, so the unrolled body
// calls it and does not repeat it; its tables sit in static shared memory
// (sMat), which only the Matérn instantiation holds.
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
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double dvd(double a, double b) {
  return __ddiv_rn(a, b);
}
// s - a*b as the twin's _msub: one fmaf in float, two roundings in double.
__device__ __forceinline__ float msub(float s, float a, float b) {
  return fmaf(-a, b, s);
}
__device__ __forceinline__ double msub(double s, double a, double b) {
  return __dsub_rn(s, __dmul_rn(a, b));
}
__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return __dsqrt_rn(x); }
// The pivot's clamp (the twin's clamp_min(s, 1e-12) in its dtype).
template <class V>
__device__ __forceinline__ V pivot_min() {
  if constexpr (std::is_same_v<V, float>) {
    return 1e-12f;
  } else {
    return 1e-12;
  }
}

// The row body on values V (float or double): kef(i, j) is entry (i, j)
// of the identity-forced K (i >= j), mv the row's mask, out its k entries.
// Its products and quotients outside msub feed no sum, so nvcc contracts
// none of them; the divisions are IEEE in both types.
template <int M, class V, class Kef>
__device__ __forceinline__ void factor_row(const Kef& kef, const float* mv,
                                           V d_floor, V* out) {
  if constexpr (M == 0) {
    out[0] = V(1);
  } else {
    V L[M][M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      V s = kef(1 + j, 1 + j);
#pragma unroll
      for (int q = 0; q < j; ++q) s = msub(s, L[j][q], L[j][q]);
      s = s < pivot_min<V>() ? pivot_min<V>() : s;
      L[j][j] = root(s);
      const V inv_ljj = V(1) / L[j][j];
#pragma unroll
      for (int i = j + 1; i < M; ++i) {
        V s2 = kef(1 + i, 1 + j);
#pragma unroll
        for (int q = 0; q < j; ++q) s2 = msub(s2, L[i][q], L[j][q]);
        L[i][j] = s2 * inv_ljj;
      }
    }
    V u[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      V s = kef(1 + i, 0);
#pragma unroll
      for (int q = 0; q < i; ++q) s = msub(s, L[i][q], u[q]);
      u[i] = s / L[i][i];
    }
    V d = kef(0, 0);
#pragma unroll
    for (int j = 0; j < M; ++j) d = msub(d, u[j], u[j]);
    d = d < d_floor ? d_floor : d;
    V z[M];
#pragma unroll
    for (int i = M - 1; i >= 0; --i) {
      V s = u[i];
#pragma unroll
      for (int q = i + 1; q < M; ++q) s = msub(s, L[q][i], z[q]);
      z[i] = s / L[i][i];
    }
    const V inv_sqrt_d = V(1) / root(d);
    out[0] = inv_sqrt_d;
#pragma unroll
    for (int j = 0; j < M; ++j)
      out[1 + j] = -z[j] * inv_sqrt_d * V(mv[1 + j]);
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

// ---- the Matérn correlation in float64 (ops/covariance.py:_matern,
// ops/bessel.py, on float64 tensors) ----------------------------------------

constexpr double kPi = 3.14159265358979323846;    // math.pi
constexpr double kLn2 = 0.69314718055994530942;   // math.log(2.0)

// The per-chain Matérn quantities (matern_chain), by index.
enum MaternConst {
  kNu, kMu, kL,                // nu = mu + l, |mu| <= 1/2
  kFact, kGam1, kGam2,         // pi mu / sin(pi mu), the Chebyshev gam1, gam2
  kP0, kQ0,                    // 0.5 / gampl, 0.5 / gammi (beschb's)
  kLognorm,                    // (1 - nu) ln 2 - lgamma(nu)
  kNorm,                       // 2 / Gamma(nu) = exp(ln 2 - lgamma(nu))
  kG,                          // Gamma(1-nu) / Gamma(1+nu)
  kMaternConsts
};
constexpr int kTerms = 20;     // Temme's terms (ops/bessel.py _SERIES_ITERS)
constexpr int kSeries = 6;     // ops/covariance.py _MATERN_SERIES_K
constexpr int kChunk = 32;     // chains whose quantities one warp computes
// The chain's coefficients, one thread an entry: Temme's P, Q, W of the
// kTerms terms, then the complementary series' 1/(1-nu), its kSeries - 1
// t2 factors and kSeries - 2 t1 factors.
constexpr int kTableEntries = 3 * kTerms + 1 + (kSeries - 1) + (kSeries - 2);

// The Matérn instantiation's own shared memory, at fixed addresses so that
// the out-of-line evaluation reads it with broadcast loads at constant
// offsets.  term[i - 1] = {P_i, Q_i}, wr[i - 1] = {W_i, 1/i} with
//   P_i = 1 / prod_{j<=i} (j - mu),  Q_i = 1 / prod_{j<=i} (j + mu),
//   W_i = 1 / (i^2 - mu^2);
// comp = {1/(1-nu), 1/((nu+k) k) for k = 1..5, 1/((k-nu) k) for k = 2..5};
// chain[s] the quantities of the chain c with (c - c0) % kChunk == s among
// the kChunk chains the block walks next.
struct MaternShared {
  double2 term[kTerms];
  double2 wr[kTerms];
  double comp[kSeries + kSeries - 2];
  double chain[kChunk][kMaternConsts];
};
__shared__ MaternShared sMat;

// ops/bessel.py _chebev: Clenshaw's d, dd = 2 x d - dd + c, d over the
// coefficients N-1..1, then x d - dd + c0 / 2 (c0half, that product as
// Python computes it before torch adds it).
template <int N>
__device__ __forceinline__ double chebev(const double* c, double c0half,
                                         double x) {
  double d = 0.0, dd = 0.0;
#pragma unroll
  for (int i = N - 1; i >= 1; --i) {
    const double t = add(sub(mul(mul(x, 2.0), d), dd), c[i]);
    dd = d;
    d = t;
  }
  return add(sub(mul(x, d), dd), c0half);
}

// ops/bessel.py _beschb: gam1, gam2, 1/Gamma(1+mu), 1/Gamma(1-mu), from
// the Chebyshev coefficients _C1, _C2 (Python's doubles).
__device__ void beschb(double mu, double& gam1, double& gam2, double& gampl,
                       double& gammi) {
  const double c1[7] = {
      -1.142022680371168e0, 6.5165112670737e-3, 3.087090173086e-4,
      -3.4706269649e-6, 6.9437664e-9, 3.67795e-11, -1.356e-13};
  const double c2[8] = {
      1.843740587300905e0, -7.68528408447867e-2, 1.2719271366546e-3,
      -4.9717367042e-6, -3.31261198e-8, 2.423096e-10, -1.702e-13, -1.49e-15};
  const double xx = sub(mul(mul(mu, 8.0), mu), 1.0);
  gam1 = chebev<7>(c1, 0.5 * -1.142022680371168e0, xx);
  gam2 = chebev<8>(c2, 0.5 * 1.843740587300905e0, xx);
  gampl = sub(gam2, mul(mu, gam1));
  gammi = add(gam2, mul(mu, gam1));
}

// ops/bessel.py kv's split nu = mu + l with |mu| <= 1/2.
__device__ __forceinline__ double split_l(double nu) {
  return floor(add(nu, 0.5));
}

// The per-chain quantities at smoothness nu, in the twin's order:
// ops/bessel.py kv's split and _temme_small_x's fact, ops/covariance.py
// _matern's lognorm and _matern_comp_small's g.
__device__ void matern_chain(double nu, double* q) {
  const double l = split_l(nu);
  const double mu = sub(nu, l);
  double gam1, gam2, gampl, gammi;
  beschb(mu, gam1, gam2, gampl, gammi);
  const double pimu = mul(mu, kPi);
  q[kNu] = nu;
  q[kMu] = mu;
  q[kL] = l;
  q[kFact] = fabs(pimu) < 1e-12 ? 1.0 : dvd(pimu, sin(pimu));
  q[kGam1] = gam1;
  q[kGam2] = gam2;
  q[kP0] = dvd(0.5, gampl);
  q[kQ0] = dvd(0.5, gammi);
  const double lg = lgamma(nu);
  q[kLognorm] = sub(mul(sub(1.0, nu), kLn2), lg);
  q[kNorm] = exp(sub(kLn2, lg));
  const double mu2 = sub(1.0, nu);
  double u1, u2, gampl2, gammi2;
  beschb(mu2, u1, u2, gampl2, gammi2);
  q[kG] = dvd(gammi2, mul(mul(mu2, sub(1.0, mu2)), gampl2));
}

// Entries t, t + T, ... of the chain's coefficients at smoothness nu
// (MaternShared's term, wr and comp): each a product of at most kTerms
// factors and one division, so the block's threads build them at once.
__device__ void matern_tables(double nu, int t, int T) {
  const double mu = sub(nu, split_l(nu));
  for (int e = t; e < kTableEntries; e += T) {
    if (e < 2 * kTerms) {
      const int i = e % kTerms + 1;
      const double s = e < kTerms ? -mu : mu;
      double prod = 1.0;
      for (int j = 1; j <= i; ++j) prod = mul(prod, add((double)j, s));
      double2& pq = sMat.term[i - 1];
      (e < kTerms ? pq.x : pq.y) = dvd(1.0, prod);
    } else if (e < 3 * kTerms) {
      const int i = e - 2 * kTerms + 1;
      const double fi = (double)i;
      sMat.wr[i - 1] = make_double2(
          dvd(1.0, sub(fi * fi, mul(mu, mu))), dvd(1.0, fi));
    } else {
      const int j = e - 3 * kTerms;   // 0: 1/(1-nu); 1..5: t2's; 6..9: t1's
      const double fk = (double)(j < kSeries ? j : j - kSeries + 2);
      sMat.comp[j] =
          j == 0 ? dvd(1.0, sub(1.0, nu))
                 : dvd(1.0, mul(j < kSeries ? add(nu, fk) : sub(fk, nu), fk));
    }
  }
}

// K_mu(x), K_{mu+1}(x) for 0.29 < x <= 2, Temme's series (ops/bessel.py
// _temme_small_x, 20 terms) on the chain's tables: a term is
//   ff_i = (i ff_{i-1} + p_{i-1} + q_{i-1}) W_i,  c_i = c_{i-1} (x/2)^2 / i,
//   p_i = (0.5 E / Gamma(1+mu)^-1) P_i,  q_i = (0.5 / (E Gamma(1-mu)^-1)) Q_i,
// with E = exp(mu dl), dl = -log(x/2): multiplies and fmas, no division.
// inv_e = 1/E = (x/2)^mu, for the closing.
__device__ __forceinline__ void temme_small_x(double x, double invx,
                                              const double* c, double& k0,
                                              double& k1, double& inv_e) {
  const double x2 = 0.5 * x;
  const double dl = -log(x2);
  const double e = c[kMu] * dl;
  const double fact2 = fabs(e) < 1e-12 ? 1.0 : sinh(e) / e;
  double ff = c[kFact] * (c[kGam1] * cosh(e) + c[kGam2] * fact2 * dl);
  const double big_e = exp(e);
  inv_e = 1.0 / big_e;
  const double pe = big_e * c[kP0], qe = inv_e * c[kQ0];
  const double d2 = x2 * x2;
  double p = pe, q = qe, cc = 1.0, total = ff, total1 = pe;
#pragma unroll
  for (int i = 1; i <= kTerms; ++i) {
    const double2 pq = sMat.term[i - 1], wr = sMat.wr[i - 1];
    ff = fma((double)i, ff, p + q) * wr.x;
    cc = cc * d2 * wr.y;
    p = pe * pq.x;
    q = qe * pq.y;
    total = fma(cc, ff, total);
    total1 = fma(cc, fma(-(double)i, ff, p), total1);
  }
  k0 = total;
  k1 = total1 * (2.0 * invx);
}

// K_mu(x), K_{mu+1}(x) for x > 2, Steed's CF2 (ops/bessel.py _cf2_large_x,
// at most 40 steps, renormalized every step, frozen once the series
// increment is below 1e-10 of the sum, the float64 twin's eps).  Its
// divisions stay: 1/denom depends on x.
__device__ void cf2_large_x(double x, double mu, double& k0, double& k1) {
  double b = mul(add(x, 1.0), 2.0);
  double d = dvd(1.0, b);
  double h = d, delh = d;
  double q1 = 0.0, q2 = 1.0;
  const double a1 = sub(0.25, mul(mu, mu));
  double q = a1, cc = a1, a = -a1;
  double s = add(mul(q, delh), 1.0);
  for (int i = 2; i < 42; ++i) {
    a = sub(a, 2.0 * (double)(i - 1));
    cc = mul(mul(-a, cc), dvd(1.0, (double)i));
    const double qnew = dvd(sub(q1, mul(b, q2)), a);
    q1 = q2;
    q2 = qnew;
    q = add(q, mul(cc, qnew));
    const double r = fmax(fabs(cc), 1e-30);
    cc = dvd(cc, r);
    q1 = mul(q1, r);
    q2 = mul(q2, r);
    b = add(b, 2.0);
    double denom = add(b, mul(a, d));
    denom = fabs(denom) < 1e-30 ? 1e-30 : denom;
    d = dvd(1.0, denom);
    const double delh_new = mul(sub(mul(b, d), 1.0), delh);
    const double dels = mul(q, delh_new);
    delh = delh_new;
    h = add(h, delh_new);
    const double s_new = add(s, dels);
    s = s_new;
    if (fabs(dels) < mul(fabs(s_new), 1e-10)) break;
  }
  h = mul(a1, h);
  const double kmu =
      dvd(mul(__dsqrt_rn(mul(dvd(1.0, mul(x, 2.0)), kPi)), exp(-x)), s);
  k0 = kmu;
  k1 = dvd(mul(kmu, sub(add(add(mu, x), 0.5), h)), x);
}

// 1 - C(x) for x <= 0.29, the ascending series (ops/covariance.py
// _matern_comp_small) on the chain's factors.
__device__ __forceinline__ double matern_comp_small(double x,
                                                    const double* c) {
  const double q = 0.25 * x * x;
  double t2 = 1.0, S2 = 1.0;
  double t1 = q * sMat.comp[0];
  double S1 = t1;
#pragma unroll
  for (int k = 1; k < kSeries; ++k) {
    t2 = t2 * q * sMat.comp[k];
    S2 += t2;
    if (k >= 2) {
      t1 = t1 * q * sMat.comp[kSeries + k - 2];
      S1 += t1;
    }
  }
  const double xh = fmax(0.5 * x, 1e-30);
  return c[kG] * exp(2.0 * c[kNu] * log(xh)) * S2 - S1;
}

// The Matérn correlation at scaled distance d (ops/covariance.py:_matern)
// for the chain in slot `slot` of sMat.chain; out of line, so the unrolled
// row body calls it.  Beyond the series, 2^(1-nu)/Gamma(nu) x^nu K_nu(x):
// after Temme's series x^nu = 2^nu (x/2)^mu (x/2)^l, so the closing is
// (2/Gamma(nu)) (1/E) (x/2)^l K_nu, multiplies alone; after CF2 it is
// exp(lognorm + nu log x) K_nu.
__device__ __noinline__ double matern_corr(double d, int slot) {
  const double* c = sMat.chain[slot];
  if (d <= 1e-8) return 1.0;
  const double x = fmax(d, 1e-8);
  if (x <= 0.29) return 1.0 - matern_comp_small(x, c);
  const double invx = 1.0 / x;
  const int l = (int)c[kL];
  double k0, k1, scale;
  if (x <= 2.0) {
    double inv_e;
    temme_small_x(x, invx, c, k0, k1, inv_e);
    scale = c[kNorm] * inv_e;
    for (int j = 1; j <= l; ++j) scale *= 0.5 * x;
  } else {
    cf2_large_x(x, c[kMu], k0, k1);
    scale = exp(add(c[kLognorm], mul(c[kNu], log(x))));
  }
  // upward recurrence K_{j+1} = K_{j-1} + 2 (mu + j) / x K_j up to l
  for (int j = 1; j <= l; ++j) {
    const double k2 = fma(2.0 * (c[kMu] + j) * invx, k1, k0);
    k0 = k1;
    k1 = k2;
  }
  return scale * k0;
}

// ---- factor_build: K never written ------------------------------------------

// Offset, in floats, of the per-chain constants after the T rows' slab
// and rows out: rounded up to 8 bytes for the Matérn instantiation's
// doubles.
__host__ __device__ inline int consts_offset(int T, int pad, int ko) {
  return (T * (pad + ko) + 1) & ~1;
}

// Matérn's values are double (each row rounded once to float on its way
// out), the exponential families' float; so are their natural params.
template <bool kMatern>
using BuildValue = std::conditional_t<kMatern, double, float>;

template <int M, bool kMatern>
__global__ void __launch_bounds__(128)
factor_build_kernel(const float* __restrict__ d2g,
                    const float* __restrict__ mask,
                    const BuildValue<kMatern>* __restrict__ natural,
                    const long long* __restrict__ rows,
                    float* __restrict__ out, int C, int R, int G, int n_shape,
                    int chains_per_block, BuildValue<kMatern> d_floor) {
  using V = BuildValue<kMatern>;
  constexpr int k = M + 1, ko = k | 1;
  const int kkG = k * k * G, pad = kkG | 1, T = blockDim.x;
  extern __shared__ __align__(16) float smem[];
  float* sD = smem;                    // [T][pad]  the rows' nn_dist2
  float* sO = sD + T * pad;            // [T][ko]   one chain's rows out
  // [G] the chain's squared ranges
  V* sC = reinterpret_cast<V*>(smem + consts_offset(T, pad, ko));

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
      const V r = natural[(long long)c * n_shape + t];
      sC[t] = mul(r, r);
    }
    if constexpr (kMatern) {
      // the next kChunk chains' quantities, a lane each, then this chain's
      // coefficients, an entry a thread
      if ((c - c0) % kChunk == 0 && t < kChunk && c + t < c1)
        matern_chain(natural[(long long)(c + t) * n_shape + G],
                     sMat.chain[t]);
      matern_tables(natural[(long long)c * n_shape + G], t, T);
    }
    __syncthreads();   // the slab (first chain) and the chain's constants
    V res[k];
    if (t < nb) {
      auto kef = [&](int i, int j) -> V {
        if (i == j) return V(1);
        const float v = mv[i] * mv[j];
        if (v == 0.0f) return V(0);
        const float* p = Dt + (i * k + j) * G;
        V d2 = dvd(V(p[0]), sC[0]);
        for (int g = 1; g < G; ++g) d2 = add(d2, dvd(V(p[g]), sC[g]));
        if constexpr (kMatern) {
          const double d = __dsqrt_rn(fmax(d2, 0.0));
          return mul(matern_corr(d, (c - c0) % kChunk), (double)v);
        } else {
          const float d = sqrtf(fmaxf(d2, 0.0f));
          return mul(expf(-d), v);
        }
      };
      factor_row<M>(kef, mv, d_floor, res);
#pragma unroll
      for (int j = 0; j < k; ++j) sO[t * ko + j] = (float)res[j];
    }
    __syncthreads();
    float* dst = out + ((long long)c * R + b0) * k;
    for (int e = t; e < nb * k; e += T) {
      const int r = e / k;
      dst[e] = sO[r * ko + (e - r * k)];
    }
    __syncthreads();   // sO, sC and sMat are reused by the next chain
  }
}

template <int M>
cudaError_t launch_build(bool matern, const float* d2g, const float* mask,
                         const void* natural, const long long* rows,
                         float* out, int C, int R, int G, int n_shape,
                         double d_floor, cudaStream_t st) {
  constexpr int k = M + 1, ko = k | 1;
  // a slab too large for one block even at 32 threads: refused, before
  // the int offsets below could overflow
  if (((long long)k * k * G) * 32 * sizeof(float) > 227 * 1024)
    return cudaErrorInvalidValue;
  const int pad = (k * k * G) | 1;
  auto smem = [&](int T) {
    return (size_t)consts_offset(T, pad, ko) * sizeof(float) +
           (size_t)G * sizeof(double);
  };
  // the Matérn instantiation's static sMat comes on top of the dynamic bytes
  const size_t fixed = matern ? sizeof(MaternShared) : 0;
  int T = 128;
  while (T > 32 && smem(T) + fixed > 48 * 1024) T /= 2;
  const size_t bytes = smem(T);
  if (bytes + fixed > 227 * 1024) return cudaErrorInvalidValue;
  const long long bx = (R + T - 1) / T;
  long long ny = (kTargetBlocks + bx - 1) / bx;
  ny = ny < C ? ny : C;
  ny = ny < 65535 ? ny : 65535;
  const int per = (int)((C + ny - 1) / ny);
  const dim3 grid((unsigned int)bx, (unsigned int)((C + per - 1) / per));
  auto go = [&](auto kern, auto nat) {
    if (bytes + fixed > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (e != cudaSuccess) return e;
    }
    kern<<<grid, T, bytes, st>>>(d2g, mask, nat, rows, out, C, R, G,
                                 n_shape, per, d_floor);
    return cudaGetLastError();
  };
  if (matern) {
    if constexpr ((kPart & 4) != 0)
      return go(factor_build_kernel<M, true>,
                static_cast<const double*>(natural));
  } else {
    if constexpr ((kPart & 2) != 0)
      return go(factor_build_kernel<M, false>,
                static_cast<const float*>(natural));
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
// natural [C, n_shape] (the G ranges, then nu when matern != 0: double
// then, float otherwise); row r of the output is graph row rows[r], or r
// when rows is null.  d_floor is a double: the Matérn rows floor d at it
// in float64, the exponential ones at its float.
extern "C" int factor_build_launch(const float* d2g, const float* mask,
                                   const void* natural, const long long* rows,
                                   float* out, int C, int R, int m, int G,
                                   int n_shape, int matern, double d_floor,
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
