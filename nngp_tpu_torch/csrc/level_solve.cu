// The level-scheduled triangular solve L x = v of every chain in one launch.
//
// Replaces no Pallas kernel: nngp_tpu/ops/trisolve.py:level_solve is XLA, a
// fori_loop over the graph's level_segs tables with a gather and a divide
// a row.  The port's plain twin (ops/trisolve.py:level_solve_reference)
// walks the same rows in a Python loop, about ten launches a row, ~1,780 a
// call at the Heavy-metals graph's 178 rows; each gathers a few hundred
// sites in a few microseconds against ~20 us of host enqueue, so the card
// waited on the host.  This kernel does the whole walk in one launch.
//
// For each chain c and site i, in an order where every parent comes first:
//   x_i = (v_i - sum_{j=1..m} linv[c,i,j] x_{NN[i,j]}) / linv[c,i,0]
// over the parents j that exist.  The products and the sum, in index
// order j = 1..m, are float64 (each product of two float32 is exact), and
// x_i is rounded once to float32; no atomics, so repeat calls give the
// same bits, whatever the chain count.  (ops/trisolve.py:kernel_rows is
// this arithmetic in PyTorch: the plain twin and halo mode's solve use it
// on a card, and give the kernel's bits.)
//
// Schedule.  preprocess/coloring.py:level_steps merges the level_segs
// rows into steps (every site of a step has all its parents in earlier
// steps: the rows of one DAG level become one step) and lays them out as
// a CSR, built with the graph: step_ptr [S+1], the steps' sites (each
// step in increasing site order), and each site's parent columns in that
// order (-1 where nn_mask is 0).
//
// Bound.  The call must read linv (C n (m+1) float32), v and the tables
// (n (m+1) int32) and write x: 4 (C n (m+3) + n (m+1)) bytes, 180 MB at 96
// chains and the Heavy-metals graph (n = 58,097, m = 5), 53.7 us at 3.35
// TB/s; its 2 C n m float64 operations take ~2 us.  Two things keep a call
// above that.  The order of the steps: a step starts only when the one
// before has written its x, so each of the S steps (73 from 178 rows at
// chip_smoke.py's 64,274 sites) costs a round trip of a dependent load and
// a barrier, 1.1 us a step (this kernel on a path of 73 one-site
// steps).  And the
// sectors: a step's sites lie scattered over [0, n), so each 24-byte row
// and 4-byte v read, and each x written, touches its own 32-byte sectors,
// ~120 bytes of device memory a site and chain instead of 32.
//
// Design.
// - Chains never interact, so no grid-wide barrier: a chain is solved by
//   one block of 1,024 threads, and a block barrier separates the steps.
//   At 96 chains that fills 96 of an H100's 132 SMs.  (Thread-block
//   clusters of 2-8 blocks a chain took 0.92-2.06 ms at 96 chains and
//   saved 0.065 ms a call at 3; no benchmark cell has so few chains.)
// - Only the parents' x depends on earlier steps.  A thread walks its
//   items (positions tid, tid + threads, ... of each step) as a pipeline
//   two deep: before it solves an item, it loads the next one's site,
//   parent columns, factor row (24 bytes at m = 5) and v, across the
//   barrier when the next item lies in the next step.  After a barrier only
//   the parents' x loads, the float64 sum and the store wait.
// - x lives in global memory.  Every access to a chain's x comes from one
//   SM, so the loads go through L1: the carveout gives L1 the SM's memory
//   (no shared memory is used), where a chain's 232 KB of x at n = 58,097
//   nearly fits, and the streamed inputs are read with ld.global.cg so
//   they do not evict it.
// - 32-bit offsets within a chain (the wrapper checks n (m+1) < 2^31), a
//   64-bit chain base.
//
// Measured on an H100 SXM at 700 W (experiments/sweep_bench.py --solve,
// 64,274 sites): 0.69 ms of device time a call at 96 chains and 0.33 ms
// at 3, against 100 and 123 ms for the plain twin's row loop on the card.

#include <cuda_runtime.h>
#include <limits.h>

#ifndef LEVEL_SOLVE_M
#error "build with -DLEVEL_SOLVE_M=<parents a site>"
#endif

namespace {

constexpr int kM = LEVEL_SOLVE_M;           // parents a site
constexpr int kK = kM + 1;                  // entries of a factor row
constexpr int kThreads = 1024;              // a block

// What solving one site needs that no step writes: the site, its parents'
// columns (-1: none), its factor row and its right-hand side.
struct Item {
  int site;                                 // -1: no item
  int col[kM > 0 ? kM : 1];
  float row[kK];
  float v;
};

__device__ __forceinline__ Item load_item(int p, int end,
                                          const int* __restrict__ sites,
                                          const int* __restrict__ cols,
                                          const float* __restrict__ L,
                                          const float* __restrict__ V) {
  Item it;
  it.site = -1;
  if (p < end) {
    it.site = __ldcg(sites + p);
#pragma unroll
    for (int j = 0; j < kM; ++j) it.col[j] = __ldcg(cols + p * kM + j);
    const float* r = L + it.site * kK;
#pragma unroll
    for (int j = 0; j < kK; ++j) it.row[j] = __ldcg(r + j);
    it.v = __ldcg(V + it.site);
  }
  return it;
}

__device__ __forceinline__ void solve(const Item& it, float* X) {
  if (it.site < 0) return;
  float xp[kM > 0 ? kM : 1];
#pragma unroll
  for (int j = 0; j < kM; ++j) {
    const int c = it.col[j];
    xp[j] = c < 0 ? 0.f : X[c];
  }
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < kM; ++j)
    if (it.col[j] >= 0) s = fma((double)it.row[j + 1], (double)xp[j], s);
  X[it.site] = (float)(((double)it.v - s) / (double)it.row[0]);
}

// Block b solves chain b.
__global__ void __launch_bounds__(kThreads, 1)
level_solve_kernel(const float* __restrict__ linv, const float* __restrict__ v,
                   float* x, const int* __restrict__ step_ptr,
                   const int* __restrict__ sites, const int* __restrict__ cols,
                   int n, int n_steps) {
  const int chain = blockIdx.x;
  const int tid = threadIdx.x;
  constexpr int stride = kThreads;
  const float* L = linv + (size_t)chain * n * kK;
  const float* V = v + (size_t)chain * n;
  float* X = x + (size_t)chain * n;

  int lo = __ldg(step_ptr), hi = __ldg(step_ptr + 1);
  Item cur = load_item(lo + tid, hi, sites, cols, L, V);
  for (int s = 0; s < n_steps; ++s) {
    const int next_hi = s + 1 < n_steps ? __ldg(step_ptr + s + 2) : hi;
    if (lo + tid >= hi)        // no item in this step: fetch the next one's
      cur = load_item(hi + tid, next_hi, sites, cols, L, V);
    for (int p = lo + tid; p < hi; p += stride) {
      const int q = p + stride;
      const Item next = q < hi ? load_item(q, hi, sites, cols, L, V)
                               : load_item(hi + tid, next_hi, sites, cols, L, V);
      solve(cur, X);
      cur = next;
    }
    __syncthreads();
    lo = hi;
    hi = next_hi;
  }
}

cudaError_t prefer_l1() {   // once per process: no shared memory is used
  static const cudaError_t e = cudaFuncSetAttribute(
      level_solve_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxL1);
  return e;
}

}  // namespace

// C entry point, bound with ctypes.  linv [C, n, m+1], v and x [C, n]
// (float32), step_ptr [n_steps + 1], sites [n] and cols [n, m] (int32) are
// device pointers; one block solves a chain.  Launches on `stream`;
// returns the CUDA error (0 = launched).
extern "C" int level_solve_launch(const float* linv, const float* v, float* x,
                                  const int* step_ptr, const int* sites,
                                  const int* cols, int C, int n, int n_steps,
                                  void* stream) {
  if (C < 0 || n < 0 || n_steps < 0 || (long long)n * kK > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (C == 0 || n_steps == 0) return (int)cudaSuccess;
  const cudaError_t e = prefer_l1();
  if (e != cudaSuccess) return (int)e;
  level_solve_kernel<<<C, kThreads, 0, (cudaStream_t)stream>>>(
      linv, v, x, step_ptr, sites, cols, n, n_steps);
  return (int)cudaGetLastError();
}
