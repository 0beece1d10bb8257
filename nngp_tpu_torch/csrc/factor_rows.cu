// Compressed Vecchia factor rows from neighbour-set correlations: for each
// (batch, row) b, the conditional of position 0 given positions 1..m of the
// (m+1) x (m+1) correlation K[b],
//   L L' = K[b][1:, 1:],  u = L^-1 K[b][1:, 0],  d = max(K[b][0][0] - u'u, d_floor),
//   z = L'^-1 u,          rows[b] = [1/sqrt(d), -z_j / sqrt(d) * mask[r][1+j]],
// with the padded positions of row r (mask 0) forced to identity first.
//
// Replaces the factor half of nngp_tpu's vecchia_linv
// (nngp_tpu/ops/vecchia.py:83 linv_rows_from_K) as the sampler runs it:
// inside the jitted gibbs_iteration (nngp_tpu/models/gaussian.py:805), where
// XLA fuses each multiply-subtract of the unrolled Cholesky, the two solves
// and d = 1 - u'u into one rounding.  It is not a Pallas kernel: it is the
// counterpart of XLA's fused factor arithmetic.  The term order is
// nngp_tpu_torch/ops/vecchia.py:linv_rows_reference's, op for op: the
// padded rows and columns forced to identity, Cholesky sums in increasing t,
// the pivot clamped at 1e-12 before sqrtf, 1/L[j][j] then a multiply, the
// solves' divisions, d floored at d_floor; each s - a*b is one fmaf(-a, b,
// s), and sqrtf and the divisions are IEEE (nvcc's -prec-sqrt and -prec-div
// defaults; no fast-math).  m = 0 gives rows of 1.
//
// Layout: K [B, k, k] f32 (B = the leading dimensions, chains then rows),
// mask [R, k] f32 (0/1, row r = b mod R), rows [B, k] f32; k = m + 1.
//
// Bound.  The function reads K once and writes the rows: (k^2 + k) x 4 bytes
// a (batch, row), 168 B at m = 5, so 32.4 MB at 3 chains and 64,274 rows
// (9.7 us at 3.35 TB/s) and 1.04 GB at 96 chains (0.31 ms); its ~m^3/6 + 2m^2
// float32 operations a row are far below that.  Design: one thread a (batch,
// row), with L, u and z in registers (m is a template parameter, every loop
// unrolled); a block stages its slab of K, contiguous in device memory,
// through shared memory with coalesced loads (row stride k^2 | 1, odd, so
// the threads' reads fall in distinct banks), and its rows back the same
// way.  A simple kernel: no attempt yet to fuse the correlation into it.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxM = 16;

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
cudaError_t launch(const float* K, const float* mask, float* rows,
                   long long B, int R, float d_floor, cudaStream_t st) {
  constexpr int T = block_threads<M>();
  const long long blocks = (B + T - 1) / T;
  factor_rows_kernel<M><<<(unsigned int)blocks, T, 0, st>>>(K, mask, rows, B,
                                                             R, d_floor);
  return cudaGetLastError();
}

template <int M>
cudaError_t dispatch(int m, const float* K, const float* mask, float* rows,
                     long long B, int R, float d_floor, cudaStream_t st) {
  if (m == M) return launch<M>(K, mask, rows, B, R, d_floor, st);
  if constexpr (M < kMaxM)
    return dispatch<M + 1>(m, K, mask, rows, B, R, d_floor, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point, bound with ctypes: launches on `stream` for B (batch, row)
// pairs of R rows each, m neighbours (0 <= m <= kMaxM, the wrapper's
// FACTOR_ROWS_MAX_M); returns the CUDA error (0 = launched).
extern "C" int factor_rows_launch(const float* K, const float* mask,
                                  float* rows, long long B, int R, int m,
                                  float d_floor, void* stream) {
  if (m < 0 || m > kMaxM || R <= 0 || B <= 0 || B % R != 0)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch<0>(m, K, mask, rows, B, R, d_floor,
                          (cudaStream_t)stream);
}
