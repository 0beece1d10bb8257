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
// XLA's scatter the last occurrence wins: the plan holds only the sites
// with keep[b, i] (the last occurrence of each), so no two threads ever
// write the same word.
//
// What bounds it on an H100: every step reads what the step before it
// wrote, so the S * NB steps (600 at the script's shapes) are one chain of
// dependent steps, each ending in a barrier across the cluster.  The bytes
// (3.4 us at the script's shapes) are not the limit; the chain is.  Its
// floor, the step loop with its barriers alone, reads ~0.8 us a step at a
// cluster of 16 (0.48 ms a call; NVIDIA H100 80GB HBM3, 700 W,
// experiments/gather_bench.py).  A design that pulls every neighbour over
// the cluster network (15 of 16 loads remote at a cluster of 16) waits a
// DSMEM round trip per load and needs a second barrier a step before the
// writes; on the same card it read 2.0 ms a call.  Pushes whose addresses
// scatter over the owner's buffer cost a DSMEM sector each, so the layout
// below puts a warp's pushes to one rank side by side.
//
// Design: owner computes, products pushed.  One cluster of CS blocks (CS =
// 2, 4, 8 or 16; 16 is beyond the portable size and is allowed
// explicitly).  The field of n floats is dealt out round robin: w[k] lives
// in block k % CS ("rank") at slot k / CS.  A plan built once from the
// static inputs (sites, nbrs, q, keep) (experiments/gather_ops.py:
// gather_sweeps_plan) holds fixed-stride tables, one row per group
// g = b * CS + r (block step b on rank r), padded to the longest row:
//   pushes  every kept pair (i, j) whose neighbour nbrs[b, i, j] rank r
//           owns: (the neighbour's local slot, q[b, i, j], the rank that
//           owns sites[b, i], the product's slot in that rank's partials
//           buffer); ordered by destination rank, then i, then j; padding
//           has rank -1;
//   owned   every kept site that rank r owns: (its local slot, i), in
//           order of i; padding has slot -1;
//   where   for each owned site, the slots of its W products in neighbour
//           order (16 bits each).
// An owner's partials buffer holds one segment per source rank, in rank
// order, and a source fills its segment in its push order: the products a
// warp pushes to one rank land side by side, a few sectors a warp store.
// Fixed strides keep every table load one step deep: no offsets are read
// before an entry.  A step: (1) each rank reads its pushes' neighbours
// from its own shared memory, multiplies by q and stores the product into
// the owner's partials buffer (st.shared::cluster: posted, nothing waits on
// a remote round trip); (2) one cluster barrier, split into arrive.release
// and wait.acquire, with the next step's pushes and owned entries loaded in
// the gap; (3) each owner sums its sites' W products in neighbour order j =
// 0 .. W-1, computes sum / P + z * rsqrtf(P) and stores w[site] locally (P
// and z of the step's first owned site were loaded when the step began);
// (4) __syncthreads() before the next step's local reads.  Every read of
// the field is local; the only remote traffic is stores.  The products are
// formed on the neighbour's rank and summed in neighbour order, so two
// calls give the same bits.  512 threads a block: at a cluster of 16,
// 1,024 threads made the barriers dearer than the second push that a
// thread takes at 512 costs.
//
// Why one barrier a step is enough: the partials buffer alternates by step
// parity.  A rank pushes step t + 1's products into buffer (t + 1) % 2 only
// after passing step t's barrier, which no rank passes before every rank
// has arrived at it; a rank arrives at step t's barrier only after its
// step t - 1 reductions, the last reads of buffer (t - 1) % 2 = (t + 1) % 2.
// So no push overwrites a slot its owner may still read, and every push of
// step t is visible to its owner after step t's barrier (release/acquire
// at cluster scope).  The field itself is read and written by its own rank
// only, ordered by the barriers within the block.
//
// A second instantiation runs the step loop with its barriers alone (no
// field, plan, partial, P or noise touched): the chain's floor on this
// card, timed beside the kernel by experiments/gather_bench.py.
//
// Shared memory per block: ceil(n / CS) floats of field (rounded up to 4)
// and two partials buffers of W * n_owned floats each (n_owned: the plan's
// largest count of owned sites of one rank in one block step); the wrapper
// checks that they fit in 227 KB.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (nngp_tpu_torch/ops/_build.py); no fast-math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kW = 16;          // neighbours per site (the wrapper checks)
constexpr int kThreads = 512;   // threads per block
constexpr int kUnroll = 4;      // pushes a thread keeps in flight

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Stores v at the shared-memory address `local` (an offset in this block's
// shared window) of block `rank` of the cluster; posted, no reply awaited.
__device__ __forceinline__ void push(const float* local, int rank, float v) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(local));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(a), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(remote), "f"(v)
               : "memory");
}

// Loads of the read-only tables as volatile asm: the compiler keeps them
// where they stand, between the barrier's arrive and wait, instead of
// sinking them to their first use in the next step.
__device__ __forceinline__ int4 load_v4(const int4* p) {
  int4 v;
  asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ int2 load_v2(const int2* p) {
  int2 v;
  asm volatile("ld.global.nc.v2.s32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}

__device__ __forceinline__ float load_f32(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// Loads the pushes u * kThreads + e of a group's row below `count`.
__device__ __forceinline__ void load_pushes(int4 (&p)[kUnroll],
                                            const int4* __restrict__ row,
                                            int e, int count) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    p[u] = e + u * kThreads < count ? load_v4(row + e + u * kThreads)
                                    : make_int4(0, 0, -1, 0);
}

// Partial slot j of an owned site: W slots of 16 bits, two to an int.
__device__ __forceinline__ int slot_of(const int4 (&wh)[kW / 8], int j) {
  const int4 q = wh[j / 8];
  const int k = j % 8 / 2;
  const int v = k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
  return j % 2 == 0 ? v & 0xFFFF : static_cast<unsigned>(v) >> 16;
}

template <int CS, bool kBarriersOnly>
__global__ void __launch_bounds__(kThreads, 1)
gather_sweeps_kernel(float* __restrict__ w, int n,
                     const int4* __restrict__ pushes,  // [NB * CS, n_pushes]
                     int n_pushes,
                     const int2* __restrict__ owned,   // [NB * CS, n_owned]
                     const int4* __restrict__ where,   // [NB * CS, n_owned, 2]
                     int n_owned,
                     const float* __restrict__ P,      // [NB, B]
                     const float* __restrict__ noise,  // [S, NB, B]
                     int n_blocks, int B, int S) {
  extern __shared__ __align__(16) float smem[];
  const int field = ((n + CS - 1) / CS + 3) & ~3;
  const int slots = n_owned * kW;  // one partials buffer
  float* part = smem;  // w[k] for k % CS == rank, at k / CS
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  if (!kBarriersOnly)
    for (int o = tid; o * CS + rank < n; o += kThreads) part[o] = w[o * CS + rank];
  cluster.sync();  // every block runs, and holds its part, before any push

  const int steps = S * n_blocks;
  int b = 0;                        // block step of step t
  int4 pre[kUnroll];                // step t's first pushes, loaded ahead
  int2 own = make_int2(-1, 0);      // step t's first owned site, loaded ahead
  int4 wh[kW / 8] = {};             // and its partial slots
  if (!kBarriersOnly && steps > 0) {
    load_pushes(pre, pushes + (size_t)rank * n_pushes, tid, n_pushes);
    if (tid < n_owned) {
      const size_t k = (size_t)rank * n_owned + tid;
      own = load_v2(owned + k);
#pragma unroll
      for (int u = 0; u < kW / 8; ++u) wh[u] = load_v4(where + k * (kW / 8) + u);
    }
  }
  for (int t = 0; t < steps; ++t) {
    float* buf = smem + field + (t & 1) * slots;
    const size_t g = (size_t)b * CS + rank;
    float p = 1.0f, z = 0.0f;
    if (!kBarriersOnly) {
      if (own.x >= 0) {  // in flight through the pushes and the barrier
        p = load_f32(P + (size_t)b * B + own.y);
        z = load_f32(noise + (size_t)t * B + own.y);  // t = s * NB + b
      }
      for (int e = tid; e < n_pushes; e += kUnroll * kThreads) {
        int4 q4[kUnroll];
        if (e == tid) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) q4[u] = pre[u];
        } else {
          load_pushes(q4, pushes + g * n_pushes, e, n_pushes);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (q4[u].z >= 0)
            push(buf + q4[u].w, q4[u].z, part[q4[u].x] * __int_as_float(q4[u].y));
      }
    }
    cluster_arrive_release();
    // The gap: the next step's table entries do not depend on the field,
    // so they are loaded while the other ranks arrive.
    const int nb = b + 1 == n_blocks ? 0 : b + 1;
    const int2 mine = own;
    int4 mine_wh[kW / 8];
#pragma unroll
    for (int u = 0; u < kW / 8; ++u) mine_wh[u] = wh[u];
    if (!kBarriersOnly && t + 1 < steps) {
      const size_t ng = (size_t)nb * CS + rank;
      load_pushes(pre, pushes + ng * n_pushes, tid, n_pushes);
      if (tid < n_owned) {
        own = load_v2(owned + ng * n_owned + tid);
#pragma unroll
        for (int u = 0; u < kW / 8; ++u)
          wh[u] = load_v4(where + (ng * n_owned + tid) * (kW / 8) + u);
      }
    }
    cluster_wait_acquire();
    if (!kBarriersOnly) {
      for (int k = tid; k < n_owned; k += kThreads) {
        int2 o = mine;
        float pk = p, zk = z;
        int4 kw[kW / 8];
#pragma unroll
        for (int u = 0; u < kW / 8; ++u) kw[u] = mine_wh[u];
        if (k != tid) {
          o = __ldg(owned + g * n_owned + k);
#pragma unroll
          for (int u = 0; u < kW / 8; ++u)
            kw[u] = __ldg(where + (g * n_owned + k) * (kW / 8) + u);
          if (o.x >= 0) {
            pk = __ldg(P + (size_t)b * B + o.y);
            zk = __ldg(noise + (size_t)t * B + o.y);
          }
        }
        if (o.x < 0) continue;
        float x[kW];
#pragma unroll
        for (int j = 0; j < kW; ++j) x[j] = buf[slot_of(kw, j)];
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < kW; ++j) sum += x[j];  // neighbour order
        part[o.x] = sum / pk + zk * rsqrtf(pk);
      }
    }
    __syncthreads();  // this step's writes before the next step's reads
    b = nb;
  }
  if (!kBarriersOnly)
    for (int o = tid; o * CS + rank < n; o += kThreads) w[o * CS + rank] = part[o];
}

template <int CS, bool kBarriersOnly>
int launch(float* w, int n, const int4* pushes, int n_pushes,
           const int2* owned, const int4* where, int n_owned, const float* P,
           const float* noise, int n_blocks, int B, int S,
           cudaStream_t stream) {
  auto kernel = gather_sweeps_kernel<CS, kBarriersOnly>;
  const int field = ((n + CS - 1) / CS + 3) & ~3;
  const size_t smem = (size_t)(field + 2 * n_owned * kW) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (CS > 8) {
    e = cudaFuncSetAttribute(kernel,
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
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, w, n, pushes, n_pushes, owned, where,
                         n_owned, P, noise, n_blocks, B, S);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int CS>
int launch_mode(int barriers_only, float* w, int n, const int4* pushes,
                int n_pushes, const int2* owned, const int4* where,
                int n_owned, const float* P, const float* noise, int n_blocks,
                int B, int S, cudaStream_t s) {
  return barriers_only
             ? launch<CS, true>(w, n, pushes, n_pushes, owned, where, n_owned,
                                P, noise, n_blocks, B, S, s)
             : launch<CS, false>(w, n, pushes, n_pushes, owned, where, n_owned,
                                 P, noise, n_blocks, B, S, s);
}

}  // namespace

// C entry point, bound with ctypes.  Launches on `stream` and returns a
// CUDA error code (0 = launched); `cluster` must be 2, 4, 8 or 16.  The
// plan (pushes [NB * cluster, n_pushes] int4, owned [NB * cluster,
// n_owned] int2, where [NB * cluster, n_owned, W] uint16) is
// gather_sweeps_plan's for this cluster size; barriers_only = 1 runs the
// barriers alone.
extern "C" int gather_sweeps_launch(float* w, int n, const void* pushes,
                                    int n_pushes, const void* owned,
                                    const void* where, int n_owned,
                                    const float* P, const float* noise,
                                    int n_blocks, int B, int S, int cluster,
                                    int barriers_only, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int4* pu = static_cast<const int4*>(pushes);
  const int2* ow = static_cast<const int2*>(owned);
  const int4* wh = static_cast<const int4*>(where);
  switch (cluster) {
    case 2: return launch_mode<2>(barriers_only, w, n, pu, n_pushes, ow, wh, n_owned, P, noise, n_blocks, B, S, s);
    case 4: return launch_mode<4>(barriers_only, w, n, pu, n_pushes, ow, wh, n_owned, P, noise, n_blocks, B, S, s);
    case 8: return launch_mode<8>(barriers_only, w, n, pu, n_pushes, ow, wh, n_owned, P, noise, n_blocks, B, S, s);
    case 16: return launch_mode<16>(barriers_only, w, n, pu, n_pushes, ow, wh, n_owned, P, noise, n_blocks, B, S, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
