// Chromatic Gibbs sweeps of the NNGP latent field, all sweeps of one
// iteration for every chain in one launch.
//
// Replaces the Pallas TPU kernel nngp_tpu/ops/pallas_sweep.py:159
// (_pallas_sweeps_call, kernel body _make_kernel :44).  It computes what
// that kernel computes, not how: the TPU needed routed lane gathers,
// transposed field copies and a 0/1-matrix reduction on the MXU because
// its vector unit cannot gather; a GPU lane reads w[j] directly.
//
// For each sweep s < S, each colour in order, and each site i of the colour
// in every chain c:
//   prior_i = sum_{j ~ i} Q_ij (w_j - beta0)         (moralized neighbours)
//   w_i    <- beta0 - (inv_scale * prior_i - inv_noise * rs_i) / P_i
//             + z_{s,i} / sqrt(P_i)
// with P_i = inv_scale Q_ii + inv_noise #obs(i) and rs_i the residual sum,
// both precomputed per iteration (mcmc_nngp_update_Gaussian.R:254-275).
// Same-colour sites are never moralized neighbours, so a colour's sites
// update independently; colours run one after another.
//
// Bound.  At the main path's shapes (n = 64,274 sites, 11 colours, E =
// 455,670 edges, 2E = 911,340 directed neighbour entries, 3 chains, 10
// sweeps) the function must read the noise (7.7 MB), Q once per edge
// with the 2E edge ids that place it (5.5 + 3.6 MB), the neighbour CSR
// and the colour-major site order (4.2 MB), P and rs (1.5 MB), and the
// field in and out (1.5 MB): 24.1 MB, 7.2 us at 3.35 TB/s (at 96 chains
// 528 MB, 0.158 ms); its 97 M float32 operations take 1.5 us.
// (This design reads Q in plan order instead, one value per directed
// entry, 10.9 MB at 3 chains: the duplication is its cost, not the
// bound's.)  The real floor is the order of the steps: S x colours = 110
// colour steps, each ending in a barrier across the whole grid after a
// round trip of dependent L2 loads, about 1-3 us a step, so 0.1-0.35 ms.
//
// The earlier design (one 8-block cluster per chain, each thread walking
// its site's row of padded [n, 89] neighbour and edge-id tables, sites in
// site order) took 3.87 ms a call at 3 chains on an H100 SXM at 700 W,
// 35 us a colour step.  This design, against its four causes:
//  1. It used 24 of 132 SMs.  Now one cooperative launch covers the card:
//     the grid is SMs x resident blocks per SM (occupancy API), and each
//     colour step spreads the colour's sites of all chains over the whole
//     grid, with one grid barrier between steps: a counter in global
//     memory, released on arrival and acquired in the spin (the cooperative
//     launch guarantees that every block is resident, so the spin ends).
//     Nothing of a work item but the field gather depends on the field, so
//     each lane walks its items (its lane of each colour step, step after
//     step) as a pipeline three deep: while it gathers the field for one
//     item, it loads the next item's neighbour ids, Q values, P, rs and
//     noise, and the lane-table row of the one after, across the barriers.
//     After a barrier only the field gather, a shuffle sum and a store wait
//     on memory.
//  2. Three dependent loads a neighbour (table entry, edge id, Q value) at
//     32 sectors a warp-wide load.  Now the host's sweep plan lays the
//     neighbours out as a CSR in plan order (plan_ptr, plan_nbr), and the
//     caller gathers Q into the same order once an iteration (q_plan), so a
//     neighbour costs a coalesced (plan_nbr, q_plan) pair, then the field
//     gather.
//  3. A warp waited for its highest-degree site.  Now a group of lanes
//     takes one site, and its width follows the site's degree: the least
//     power of two (at most 32) whose lanes hold the degree at kUnroll
//     entries each.  The lanes read consecutive CSR entries and a
//     __shfl_xor_sync tree adds their sums.  Within a colour the plan
//     sorts sites by degree, highest first, so the widths never grow and
//     the lane table (ops/sweep.py:lane_table; lane_ptr, lane_tab: each
//     lane slot's site, first CSR entry, CSR end and group width) packs
//     the groups into warps with no group crossing a warp.
//  4. The padded tables were 2 x 22.9 MB; the CSR is 3.6 MB plus Q.
// The field stays in global memory and L2 and is read with ld.global.cg
// (never a stale L1 line written by another SM): random gathers from a
// cluster's distributed shared memory were slower than from L2 on the same
// card (csrc/gather_sweep.cu).  Sums are float32 in a fixed order (each
// lane's entries in CSR order, then the shuffle tree), no atomics, so
// repeat calls give the same bits.
//
// Work order within a colour step: site fastest (a chain's lane slots,
// then the next chain's).
//
// Measured on an H100 SXM at 700 W (chip_smoke.py, experiments/
// sweep_bench.py): 0.72 ms of device time a call at 3 chains, of which
// the 109 grid barriers alone take 0.25 ms, and 12.6 ms at 96 chains (the
// earlier design 3.9 and 28.8 ms); lanes by degree beat every single
// width, site fastest beats chain fastest at 96 chains and ties at 3.
// What is left at 3 chains is about 4 us a step beyond the barrier: the
// field gathers' L2 round trip and sectors, the store and the barrier's
// fence.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (nngp_tpu_torch/ops/_build.py); no fast-math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMinBlocks = 1;  // resident blocks per SM: at most 64 registers
// neighbour entries a lane holds (ops/sweep.py reads it to build the lane
// table)
constexpr int kUnroll = 5;

// The grid barrier.  `count` was zeroed before the launch; the k-th barrier
// (k = 1, 2, ...) ends once k * gridDim.x blocks arrived.  The block's
// threads meet at __syncthreads, then one thread releases (fence.acq_rel +
// red) and spins on an acquire load, as CUTLASS's GenericBarrier does.
__device__ __forceinline__ void grid_barrier(unsigned int* count,
                                             unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;\n\t"
                 "red.relaxed.gpu.global.add.u32 [%0], 1;"
                 :: "l"(count) : "memory");
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen) : "l"(count) : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

struct Inputs {
  float* w;                   // [C, n], read with ld.global.cg
  const float* q_plan;        // [C, nnz]
  const float* P;             // [C, n]
  const float* rs;            // [C, n]
  const float* noise;         // [C, S, n]
  const float* scal;          // [C, 3]
  const int* plan_nbr;        // [nnz]
  const int* lane_ptr;        // [n_colors+1], multiples of 32
  // [4, L]: site (-1 idle), the lane's first CSR entry, CSR end, width
  const int* lane_tab;
  int C, n, nnz, S, L, n_colors;
};

// Where a lane is in its walk: colour step k (sweep k / n_colors, colour
// k % n_colors) and its lane g of the step's C * slots lanes.  A lane's
// walk takes g = lane0, lane0 + n_lanes, ... while its warp has lanes left
// in the step (always at least one pass, so every warp meets every
// barrier), then the next step.
struct Cursor {
  int k, g, lo, slots;
};

__device__ __forceinline__ void enter_step(Cursor& at, const Inputs& in,
                                           int k, int lane0) {
  at.k = k;
  at.g = lane0;
  at.lo = at.slots = 0;
  if (k < in.S * in.n_colors) {
    const int col = k % in.n_colors;
    at.lo = __ldg(in.lane_ptr + col);
    at.slots = __ldg(in.lane_ptr + col + 1) - at.lo;
  }
}

__device__ __forceinline__ void advance(Cursor& at, const Inputs& in,
                                        int lane0, int n_lanes) {
  const int g = at.g + n_lanes;
  if (g - (lane0 & 31) < in.C * at.slots)
    at.g = g;
  else
    enter_step(at, in, at.k + 1, lane0);
}

// One lane's share of one work item (a site of one chain).  Nothing in it
// depends on the field, so it is loaded ahead: the slot's row first, then
// the neighbour entries, P, rs and noise, each an item earlier than used.
struct Item {
  bool active;
  int c, sub, width;          // chain, this lane among the site's lanes
  int i, k0, b;               // site, the lane's first CSR entry, CSR end
  int j[kUnroll];             // the lane's neighbour entries (-1: none)
  float q[kUnroll];
  float p, r, z;              // P, rs and the noise at the site, on sub 0
};

// Stage 1: the slot's row of the lane table (coalesced loads).  Work
// items are site fastest: a chain's slots of the colour, then the next
// chain's.
__device__ __forceinline__ void load_row(Item& it, const Inputs& in,
                                         const Cursor& at) {
  it.active = false;
  it.width = 1;
  if (at.k >= in.S * in.n_colors || at.g >= in.C * at.slots) return;
  it.c = at.g / at.slots;
  const int slot = at.g - it.c * at.slots;
  const int* row = in.lane_tab + at.lo + slot;
  it.i = __ldg(row);
  if (it.i < 0) return;
  it.active = true;
  it.k0 = __ldg(row + in.L);
  it.b = __ldg(row + 2 * in.L);
  it.width = __ldg(row + 3 * in.L);
  it.sub = slot & (it.width - 1);
}

// Stage 2: the lane's neighbour ids and Q values, and the site's P, rs and
// noise (sweep s).
__device__ __forceinline__ void load_entries(Item& it, const Inputs& in,
                                             int s) {
  if (!it.active) return;
  const float* qc = in.q_plan + (long long)it.c * in.nnz;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int k = it.k0 + u * it.width;
    it.j[u] = k < it.b ? __ldg(in.plan_nbr + k) : -1;
    it.q[u] = k < it.b ? __ldg(qc + k) : 0.0f;
  }
  if (it.sub == 0) {
    const long long ci = (long long)it.c * in.n + it.i;
    it.p = __ldg(in.P + ci);
    it.r = __ldg(in.rs + ci);
    it.z = __ldcs(in.noise + ((long long)it.c * in.S + s) * in.n + it.i);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
chromatic_sweeps_kernel(Inputs in, unsigned int* barrier) {
  const int lane0 = blockIdx.x * kThreads + threadIdx.x;
  const int n_lanes = gridDim.x * kThreads;
  const int steps = in.S * in.n_colors;

  // a three-deep pipeline along the lane's walk: `cur` is updated while
  // the entries of `next` and the row of `after` load
  Cursor at_cur, at_next, at_after;
  enter_step(at_cur, in, 0, lane0);
  at_next = at_cur;
  advance(at_next, in, lane0, n_lanes);
  at_after = at_next;
  advance(at_after, in, lane0, n_lanes);
  Item cur, next, after;
  load_row(cur, in, at_cur);
  load_entries(cur, in, 0);
  load_row(next, in, at_next);
  while (true) {
    // the field gather of `cur` (in flight while the next loads issue)
    float v[kUnroll], beta0 = 0.0f;
    if (cur.active) {
      const float* wc = in.w + (long long)cur.c * in.n;
      beta0 = __ldg(in.scal + 3 * cur.c);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = cur.j[u] >= 0 ? __ldcg(wc + cur.j[u]) : beta0;
    }
    load_entries(next, in, at_next.k / in.n_colors);
    load_row(after, in, at_after);

    // the neighbour sum: the lane's entries in CSR order (past the row's
    // end q = 0 and w_j - beta0 = 0, an exact zero), then a shuffle tree
    // over the site's lanes; every lane of the warp is here, and a group
    // starts at a multiple of its width, so every partner below the width
    // is in the same group
    float acc = 0.0f;
    if (cur.active) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc += cur.q[u] * (v[u] - beta0);
      // more than kUnroll * width entries (a width capped at 32, or a
      // table of one width for all sites)
      const float* wc = in.w + (long long)cur.c * in.n;
      const float* qc = in.q_plan + (long long)cur.c * in.nnz;
      const int stride = kUnroll * cur.width;
      for (int k = cur.k0 + stride; k < cur.b; k += stride) {
        int j[kUnroll];
        float q[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int kk = k + u * cur.width;
          j[u] = kk < cur.b ? __ldg(in.plan_nbr + kk) : -1;
          q[u] = kk < cur.b ? __ldg(qc + kk) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          v[u] = j[u] >= 0 ? __ldcg(wc + j[u]) : beta0;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc += q[u] * (v[u] - beta0);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float other = __shfl_xor_sync(0xffffffffu, acc, off);
      if (off < cur.width) acc += other;
    }
    if (cur.active && cur.sub == 0) {
      const float inv_scale = __ldg(in.scal + 3 * cur.c + 1);
      const float inv_noise = __ldg(in.scal + 3 * cur.c + 2);
      const float mean =
          beta0 - (inv_scale * acc - inv_noise * cur.r) / cur.p;
      in.w[(long long)cur.c * in.n + cur.i] = mean + cur.z * rsqrtf(cur.p);
    }

    if (at_next.k >= steps) break;
    if (at_next.k != at_cur.k)     // the colour step's writes, then the next
      grid_barrier(barrier, (unsigned int)at_next.k * gridDim.x);
    cur = next;
    next = after;
    at_cur = at_next;
    at_next = at_after;
    advance(at_after, in, lane0, n_lanes);
  }
}

// Blocks of the cooperative grid: SMs x resident blocks per SM; 0 on error.
int grid_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, (const void*)chromatic_sweeps_kernel, kThreads, 0) !=
          cudaSuccess)
    return 0;
  return sms * per_sm;
}

}  // namespace

// Neighbour entries one lane holds: ops/sweep.py builds the lane table
// with it.
extern "C" int chromatic_sweeps_lane_entries() { return kUnroll; }

// Threads of the cooperative grid on the current card.
extern "C" int chromatic_sweeps_grid() { return grid_blocks() * kThreads; }

// C entry point, bound with ctypes.  Zeroes the barrier counter and
// launches on `stream`; returns the CUDA error (0 = launched).
extern "C" int chromatic_sweeps_launch(
    float* w, const float* q_plan, const float* P, const float* rs,
    const float* noise, const float* scal, const int* plan_nbr,
    const int* lane_ptr, const int* lane_tab, unsigned int* barrier, int C,
    int n, int nnz, int S, int L, int n_colors, void* stream) {
  if (C <= 0 || n <= 0 || S <= 0 || n_colors <= 0)
    return (int)cudaGetLastError();
  const int blocks = grid_blocks();
  if (blocks <= 0) return (int)cudaErrorLaunchOutOfResources;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(barrier, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  Inputs in{w, q_plan, P, rs, noise, scal, plan_nbr, lane_ptr, lane_tab,
            C, n, nnz, S, L, n_colors};
  void* args[] = {&in, &barrier};
  err = cudaLaunchCooperativeKernel((const void*)chromatic_sweeps_kernel,
                                    dim3(blocks),
                                    dim3(kThreads), args, 0, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
