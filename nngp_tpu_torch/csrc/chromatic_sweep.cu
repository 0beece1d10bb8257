// Chromatic Gibbs sweeps of the NNGP latent field, all sweeps of one
// iteration in one launch.
//
// Replaces the Pallas TPU kernel nngp_tpu/ops/pallas_sweep.py:
// _pallas_sweeps_call (kernel body _make_kernel).  It computes what that
// kernel computes, not how: the TPU needed routed lane gathers, transposed
// field copies and a 0/1-matrix reduction on the MXU because its vector
// unit cannot gather; a GPU thread reads w[nbr] directly.
//
// For each sweep s < S, each colour c in order, and each site i of colour c
// (chain = cluster index):
//   prior_i = sum_{j ~ i} Q_ij (w_j - beta0)         (moralized neighbours)
//   w_i    <- beta0 - (inv_scale * prior_i - inv_noise * rs_i) / P_i
//             + z_{s,i} / sqrt(P_i)
// with P_i = inv_scale Q_ii + inv_noise #obs(i) and rs_i the residual sum,
// both precomputed per iteration (mcmc_nngp_update_Gaussian.R:254-275).
//
// Design: one cluster of kClusterBlocks thread blocks per chain (Hopper
// thread block clusters) walks the sweeps and colours in colour-major
// order, the order of the Pallas kernel and of nngp_tpu's flat schedule.
// The cluster's threads stride over the colour's sites; same-colour sites
// are never moralized neighbours, so they update independently, and the
// cluster barrier after each colour (release/acquire at cluster scope)
// makes its writes visible to the whole cluster before the next colour
// reads them.  Neighbour values are read with ld.global.cg, from L2 and
// never from an SM's own L1, so no block can see a stale line written by
// another SM of the cluster.  Loop bounds depend only on the colour, so
// every thread reaches every barrier.  The field stays in global memory
// (257 KB per chain at n = 64,274, above the 227 KB of shared memory a
// block may hold) and lives in L2.
//
// Bound: dependent irregular gathers from L2, about S * n * D of them per
// chain and iteration (D = neighbours per site), plus one cluster barrier
// per colour.  Each site's neighbour sum is a chain of dependent loads
// (table entry, then Q value and field value), so the kernel keeps kUnroll
// neighbours' loads in flight per thread, and spreads each chain over a
// cluster of kClusterBlocks SMs.  Measured at 3 chains, n = 64,274, 10
// sweeps on an H100 SXM at 700 W: one block per chain, one neighbour at a
// time, 21.5 ms per call; a cluster of 8, one at a time, 8.2 ms; a cluster
// of 8 with 8 in flight, 4.5 ms.  Keeping the field in the cluster's
// distributed shared memory, ordering a colour's sites by degree (a warp
// waits for its highest-degree site; mean degree 14, max 89) and
// coalescing the neighbour-table reads are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (nngp_tpu_torch/ops/_build.py); no fast-math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
// blocks per chain: the portable maximum cluster size; the fastest of
// 1/2/4/8 at 3, 24, 96 and 192 chains on an H100 SXM at 700 W
constexpr int kClusterBlocks = 8;
constexpr int kUnroll = 8;  // neighbours whose loads are in flight together

__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(kThreads)
chromatic_sweeps_kernel(float* w,                       // [C, n+1]
                        const int* __restrict__ color_ptr,    // [n_colors+1]
                        const int* __restrict__ color_sites,  // [n]
                        int n_colors,
                        const int* __restrict__ nbr_sites,    // [n, D], pad n
                        const int* __restrict__ nbr_edge,     // [n, D], pad E
                        int D,
                        const float* __restrict__ q_edges,    // [C, E+1]
                        int n_q,                              // E+1
                        const float* __restrict__ P,          // [C, n]
                        const float* __restrict__ rs,         // [C, n]
                        const float* __restrict__ noise,      // [C, S, n]
                        const float* __restrict__ scal,       // [C, 3]
                        int n, int S) {
  cg::cluster_group cluster = cg::this_cluster();
  const long long c = blockIdx.x / kClusterBlocks;
  const int first = cluster.block_rank() * blockDim.x + threadIdx.x;
  const int stride = kClusterBlocks * blockDim.x;
  // w is read and written by the whole cluster: L2 loads, no read-only cache
  float* wc = w + c * (long long)(n + 1);
  const float* qc = q_edges + c * (long long)n_q;
  const float* Pc = P + c * (long long)n;
  const float* rsc = rs + c * (long long)n;
  const float beta0 = scal[3 * c];
  const float inv_scale = scal[3 * c + 1];
  const float inv_noise = scal[3 * c + 2];

  for (int s = 0; s < S; ++s) {
    const float* z = noise + (c * S + s) * (long long)n;
    for (int col = 0; col < n_colors; ++col) {
      const int lo = color_ptr[col];
      const int hi = color_ptr[col + 1];
      for (int t = lo + first; t < hi; t += stride) {
        const int i = color_sites[t];
        const int* nb = nbr_sites + (long long)i * D;
        const int* ed = nbr_edge + (long long)i * D;
        // neighbour sum in row order, kUnroll neighbours' loads at a time;
        // padding (site n, edge E) reads w[n] = 0 and q[E] = 0 and adds an
        // exact zero, so the sum equals the plain one-by-one loop
        float prior = 0.0f;
        int j = 0;
        bool more = true;
        for (; more && j + kUnroll <= D; j += kUnroll) {
          int k[kUnroll];
          float v[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) k[u] = nb[j + u];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            v[u] = qc[ed[j + u]] * (__ldcg(wc + k[u]) - beta0);
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) prior += v[u];
          more = k[kUnroll - 1] < n;
        }
        for (; more && j < D; ++j) {
          const int k = nb[j];
          if (k >= n) break;
          prior += qc[ed[j]] * (__ldcg(wc + k) - beta0);
        }
        const float p = Pc[i];
        const float mean = beta0 - (inv_scale * prior - inv_noise * rsc[i]) / p;
        wc[i] = mean + z[i] * rsqrtf(p);
      }
      cluster.sync();
    }
  }
}

}  // namespace

// C entry point, bound with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int chromatic_sweeps_launch(
    float* w, const int* color_ptr, const int* color_sites, int n_colors,
    const int* nbr_sites, const int* nbr_edge, int D, const float* q_edges,
    int n_q, const float* P, const float* rs, const float* noise,
    const float* scal, int C, int n, int S, void* stream) {
  if (C > 0) {
    chromatic_sweeps_kernel<<<C * kClusterBlocks, kThreads, 0,
                              (cudaStream_t)stream>>>(
        w, color_ptr, color_sites, n_colors, nbr_sites, nbr_edge, D, q_edges,
        n_q, P, rs, noise, scal, n, S);
  }
  return (int)cudaGetLastError();
}
