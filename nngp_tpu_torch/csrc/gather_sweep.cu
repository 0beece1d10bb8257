// Whole-sweep gather/update of one field held on chip, in the distributed
// shared memory (DSMEM) of one thread-block cluster.
//
// Replaces the Pallas TPU kernel experiments/gather_bench.py:92 (body
// kernel_take :72), which keeps the field resident in VMEM and gathers it
// with jnp.take.  For each sweep s and each block step b in order:
//   g_i   = w[nbrs[b, i, :]]                          (W gathered values)
//   val_i = sum_j q[b, i, j] g_ij / P[b, i] + noise[s, b, i] rsqrt(P[b, i])
//   w[sites[b, i]] = val_i                             for every i at once
// Sites repeat within a block step (they are drawn with replacement); as in
// XLA's scatter the last occurrence wins.  The wrapper passes keep[b, i],
// true only for the last occurrence of each site in its block step, so no
// two threads ever write the same word.
//
// Design: one cluster of CS blocks (CS = 2, 4, 8 or 16) for the single
// field; 16 is beyond the portable cluster size and is allowed explicitly.
// The field of n floats (65,537 at the script's shapes, 262 KB: more than
// one block's 227 KB of shared memory) is dealt out round robin: w[k] lives
// in block k % CS at slot k / CS, so every block holds ceil(n / CS) floats.
// Each block step has a read phase (thread i loads its W neighbours through
// cluster.map_shared_rank, sums in neighbour order, and keeps val_i in a
// register), a cluster barrier, a write phase (the kept values are stored
// into the owning block's shared memory, local or remote), and a second
// cluster barrier.  The barriers have release/acquire semantics at cluster
// scope, so a read phase sees every write of the step before it, and no
// write can race a read of the same step.  Every thread runs the same
// number of steps, so every thread reaches every barrier.  After the last
// step each block copies its part back to w.
//
// Bound: per block step, B * W DSMEM loads (16,384 at the script's shapes)
// spread over CS SMs, the step's inputs from global memory (nbrs and q are
// 128 KB), and two cluster barriers; 600 steps in all, one after another.
// So the kernel prefetches the next step's inputs into registers (they do
// not depend on the field) while the current step gathers and waits at its
// barriers, and reads each site's neighbour and weight rows as 16-byte
// vectors.  The whole card has one cluster to run: 2 to 8 of its 132 SMs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (nngp_tpu_torch/ops/_build.py); no fast-math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kW = 16;           // neighbours per site (the wrapper checks)
constexpr int kMaxThreads = 512;  // sites of a block step per cluster block

// One block step's inputs for one site.
struct Step {
  int4 k[kW / 4];
  float4 c[kW / 4];
  float p, z;
  int site;
  bool keep;
};

__device__ __forceinline__ Step load_step(
    const int* __restrict__ nbrs, const float* __restrict__ q,
    const float* __restrict__ P, const float* __restrict__ noise,
    const int* __restrict__ sites, const unsigned char* __restrict__ keep,
    int n_blocks, int B, int t, int i) {
  Step st;
  const long long row = (long long)(t % n_blocks) * B + i;
  const int4* k4 = reinterpret_cast<const int4*>(nbrs) + row * (kW / 4);
  const float4* c4 = reinterpret_cast<const float4*>(q) + row * (kW / 4);
#pragma unroll
  for (int u = 0; u < kW / 4; ++u) {
    st.k[u] = __ldg(k4 + u);
    st.c[u] = __ldg(c4 + u);
  }
  st.p = __ldg(P + row);
  st.z = __ldg(noise + (long long)t * B + i);  // noise[s, b, i], t = s*NB + b
  st.site = __ldg(sites + row);
  st.keep = __ldg(keep + row) != 0;
  return st;
}

template <int CS>
__device__ __forceinline__ float* field_slot(cg::cluster_group& cluster,
                                             float* part, int k) {
  const unsigned u = static_cast<unsigned>(k);
  return cluster.map_shared_rank(part, u % CS) + u / CS;
}

template <int CS>
__global__ void __launch_bounds__(kMaxThreads)
gather_sweeps_kernel(float* __restrict__ w, int n,
                     const int* __restrict__ sites,          // [NB, B]
                     const unsigned char* __restrict__ keep,  // [NB, B]
                     const int* __restrict__ nbrs,            // [NB, B, kW]
                     const float* __restrict__ q,             // [NB, B, kW]
                     const float* __restrict__ P,             // [NB, B]
                     const float* __restrict__ noise,         // [S, NB, B]
                     int n_blocks, int B, int S) {
  extern __shared__ float part[];  // w[k] for k % CS == rank, at k / CS
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  for (int o = threadIdx.x; o * CS + rank < n; o += blockDim.x)
    part[o] = w[o * CS + rank];
  cluster.sync();  // every part is loaded before any block reads it

  const int i = rank * blockDim.x + threadIdx.x;  // site of the block step
  const bool active = i < B;
  const int steps = S * n_blocks;
  Step cur = {};
  if (active && steps > 0)
    cur = load_step(nbrs, q, P, noise, sites, keep, n_blocks, B, 0, i);
  for (int t = 0; t < steps; ++t) {
    Step next = cur;
    if (active && t + 1 < steps)
      next = load_step(nbrs, q, P, noise, sites, keep, n_blocks, B, t + 1, i);
    float val = 0.0f;
    if (active) {
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < kW / 4; ++u) {
        sum += cur.c[u].x * *field_slot<CS>(cluster, part, cur.k[u].x);
        sum += cur.c[u].y * *field_slot<CS>(cluster, part, cur.k[u].y);
        sum += cur.c[u].z * *field_slot<CS>(cluster, part, cur.k[u].z);
        sum += cur.c[u].w * *field_slot<CS>(cluster, part, cur.k[u].w);
      }
      val = sum / cur.p + cur.z * rsqrtf(cur.p);
    }
    cluster.sync();  // every read of this step is done
    if (active && cur.keep) *field_slot<CS>(cluster, part, cur.site) = val;
    cluster.sync();  // every write of this step is visible
    cur = next;
  }
  for (int o = threadIdx.x; o * CS + rank < n; o += blockDim.x)
    w[o * CS + rank] = part[o];
}

template <int CS>
int launch(float* w, int n, const int* sites, const unsigned char* keep,
           const int* nbrs, const float* q, const float* P, const float* noise,
           int n_blocks, int B, int S, cudaStream_t stream) {
  const int threads = ((B + CS - 1) / CS + 31) / 32 * 32;
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)((n + CS - 1) / CS) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      gather_sweeps_kernel<CS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (CS > 8) {
    e = cudaFuncSetAttribute(gather_sweeps_kernel<CS>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, gather_sweeps_kernel<CS>, w, n, sites, keep,
                         nbrs, q, P, noise, n_blocks, B, S);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes.  Launches on `stream` and returns a
// CUDA error code (0 = launched); `cluster` must be 2, 4, 8 or 16.
extern "C" int gather_sweeps_launch(float* w, int n, const int* sites,
                                    const unsigned char* keep, const int* nbrs,
                                    const float* q, const float* P,
                                    const float* noise, int n_blocks, int B,
                                    int S, int cluster, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (cluster) {
    case 2: return launch<2>(w, n, sites, keep, nbrs, q, P, noise, n_blocks, B, S, s);
    case 4: return launch<4>(w, n, sites, keep, nbrs, q, P, noise, n_blocks, B, S, s);
    case 8: return launch<8>(w, n, sites, keep, nbrs, q, P, noise, n_blocks, B, S, s);
    case 16: return launch<16>(w, n, sites, keep, nbrs, q, P, noise, n_blocks, B, S, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
