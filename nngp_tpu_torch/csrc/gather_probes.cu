// The gather, scatter and matmul probes of experiments/gather_probe.py and
// experiments/gather_probe2.py, as CUDA kernels.
//
// Replaces the Pallas TPU kernels those scripts build in try_kernel
// (gather_probe.py:27,42; gather_probe2.py:29), one body at a time.  The
// TPU scripts asked which gather forms Mosaic lowers into VMEM code; a GPU
// thread loads any address, so three kernels cover the twelve bodies:
//
// staged_gather_kernel<T> (f32 and i32): out = stage_n(... stage_1(src)),
//   each stage one of
//     rows   out[i, j] = x[idx[i, j], j]   take_along_axis(x, idx, axis=0)
//     cols   out[i, j] = x[i, idx[i, j]]   take_along_axis(x, idx, axis=1)
//     roll   out[i, j] = x[(i - shift) mod rows, j]   jnp.roll(x, shift, 0)
//     trans  out[i, j] = x[j, i]
//   One thread per output element walks back through the stages to the
//   source element and copies it, so no intermediate is stored.  Serves
//   k_sub, k_lane, k_chain (gather_probe.py:65,71,76) and k_sub, k_lane,
//   k_benes, k_roll, k_tr, k_sub2, k_lanei (gather_probe2.py:51-85).
//   Bound: one dependent index load per stage and one source load per
//   element, L2-resident at the probes' sizes (under 2 MB); launch latency
//   at 65k-131k elements.
//
// column_scatter_kernel (k_scat, gather_probe.py:82): out = 0, then
//   out[idx[i, 0], 0] = val[i, 0] for every i, the last i winning, as in
//   XLA's scatter.  Each block owns kScatterRows output rows; it scans the
//   whole index column and takes, per row, the largest i that names it
//   (atomicMax in shared memory: the result does not depend on the order
//   of the atomics), then writes its rows.  Bound: every block reads the
//   index column (4 KB at the probe's size); output writes are coalesced.
//
// matmul_f32_kernel (k_mm, gather_probe.py:93): C = A B in float32 with
//   FP32 FMAs (no TF32).  A cluster of KS blocks computes a BM x 128 tile
//   of C, block r over the r-th slice of the depth: tiles of 32 of depth
//   are staged through shared memory (A transposed), the next one loaded
//   into registers while the current one is multiplied, each thread an
//   8 x 4 register tile (two broadcast and one 16-byte shared load per 32
//   FMAs).  The partial tiles stay in the blocks' shared memory; then each
//   block adds, in rank order, the BM / KS rows it owns over the whole
//   cluster through distributed shared memory and writes them, so the sum
//   is deterministic.  Bound: at 512 x 1024 x 1024 x 128 (67 M FMAs, 2 us
//   at the card's FP32 rate) latency, not FMAs: on an H100 at 700 W a
//   launch takes 1.2 us, staging the tiles 4.7 us (10 MB from L2, B read
//   once per row tile), the products 3.9 us (about half the FMA issue
//   rate) and the cluster sum 0.9 us.  There are 16 row tiles of 32, so
//   the depth is split 16 ways (a non-portable cluster size, set
//   explicitly) for 256 blocks of 128 threads; 64-row tiles, an 8-way
//   split and 16- or 64-deep tiles were slower.

// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (nngp_tpu_torch/ops/_build.py); no fast-math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------- gathers

constexpr int kMaxStages = 4;
constexpr int kGatherThreads = 256;
enum StageKind : int { kRows = 0, kCols = 1, kRoll = 2, kTrans = 3 };

struct Stage {
  const int* idx;  // rows/cols: index map with this stage's output shape
  int kind;
  int out_cols;    // columns of this stage's output (row stride of idx)
  int in_rows;     // rows of this stage's input (the modulus of a roll)
  int shift;       // roll
};

struct Plan {
  Stage stage[kMaxStages];
  int n_stages;
  int out_rows, out_cols;
  int src_cols;
};

template <typename T>
__global__ void __launch_bounds__(kGatherThreads)
staged_gather_kernel(const T* __restrict__ src, T* __restrict__ out,
                     Plan plan) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)plan.out_rows * plan.out_cols) return;
  int i = (int)(e / plan.out_cols);
  int j = (int)(e - (long long)i * plan.out_cols);
#pragma unroll
  for (int t = kMaxStages - 1; t >= 0; --t) {
    if (t >= plan.n_stages) continue;
    const Stage& st = plan.stage[t];
    if (st.kind == kRows) {
      i = __ldg(st.idx + (long long)i * st.out_cols + j);
    } else if (st.kind == kCols) {
      j = __ldg(st.idx + (long long)i * st.out_cols + j);
    } else if (st.kind == kRoll) {
      i -= st.shift;  // 0 <= shift < in_rows (the wrapper reduces it)
      if (i < 0) i += st.in_rows;
    } else {
      const int k = i;
      i = j;
      j = k;
    }
  }
  out[e] = __ldg(src + (long long)i * plan.src_cols + j);
}

// ---------------------------------------------------------------- scatter

constexpr int kScatterRows = 32;
constexpr int kScatterThreads = 256;

__global__ void __launch_bounds__(kScatterThreads)
column_scatter_kernel(const float* __restrict__ val,  // [n_in, cols]
                      const int* __restrict__ idx,    // [n_in, cols]
                      int n_in, int cols,
                      float* __restrict__ out,        // [n_rows, cols]
                      int n_rows) {
  __shared__ int winner[kScatterRows];
  const int r0 = blockIdx.x * kScatterRows;
  for (int r = threadIdx.x; r < kScatterRows; r += blockDim.x) winner[r] = -1;
  __syncthreads();
  for (int i = threadIdx.x; i < n_in; i += blockDim.x) {
    const int r = __ldg(idx + (long long)i * cols) - r0;
    if (r >= 0 && r < kScatterRows) atomicMax(&winner[r], i);
  }
  __syncthreads();
  const int rows = min(kScatterRows, n_rows - r0);
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
    const int r = e / cols;
    const int c = e - r * cols;
    const int src = winner[r];
    out[(long long)(r0 + r) * cols + c] =
        (c == 0 && src >= 0) ? __ldg(val + (long long)src * cols) : 0.0f;
  }
}

// ----------------------------------------------------------------- matmul

constexpr int kDepth = 32;       // depth of a tile staged in shared memory
constexpr int kTileCols = 128;   // output columns per block

// Shared memory of one block: A tile transposed [kDepth][BM + 4] (rows
// padded, still 16-byte aligned), B tile [kDepth][kTileCols], and the
// block's partial product [BM][kTileCols].
template <int BM>
constexpr int mm_smem_floats() {
  return kDepth * (BM + 4) + kDepth * kTileCols + BM * kTileCols;
}

template <int BM, int KS>
__global__ void __launch_bounds__(BM / 8 * 32)
matmul_f32_kernel(const float* __restrict__ A,  // [M, K]
                  const float* __restrict__ Bm, // [K, N]
                  float* __restrict__ Cm,       // [M, N]
                  int M, int N, int K) {
  constexpr int T = BM / 8 * 32;      // threads: 8 rows x 4 columns each
  constexpr int kARows = BM + 4;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);
  float* Bs = As + kDepth * kARows;
  float* Ps = Bs + kDepth * kTileCols;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());  // depth slice
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * kTileCols;
  // this block's depth slice, whole tiles
  const int slice = (K + KS * kDepth - 1) / (KS * kDepth) * kDepth;
  const int k_lo = rank * slice, k_hi = min(K, k_lo + slice);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kDepth - 1) / kDepth : 0;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int kA4 = BM * kDepth / 4 / T;      // float4 of A per thread
  constexpr int kB4 = kDepth * kTileCols / 4 / T;   // float4 of B per thread
  float4 ra[kA4], rb[kB4];
  auto load = [&](int t) {
    const int k0 = k_lo + t * kDepth;
#pragma unroll
    for (int r = 0; r < kA4; ++r) {
      const int f = threadIdx.x + T * r;
      const int m = row0 + f / (kDepth / 4), k = k0 + 4 * (f % (kDepth / 4));
      ra[r] = (t < n_tiles && m < M && k < k_hi)
                  ? __ldg(reinterpret_cast<const float4*>(A + (long long)m * K + k))
                  : zero;
    }
#pragma unroll
    for (int r = 0; r < kB4; ++r) {
      const int f = threadIdx.x + T * r;
      const int k = k0 + f / (kTileCols / 4), n = col0 + 4 * (f % (kTileCols / 4));
      rb[r] = (t < n_tiles && k < k_hi && n < N)
                  ? __ldg(reinterpret_cast<const float4*>(Bm + (long long)k * N + n))
                  : zero;
    }
  };
  float acc[8][4] = {};
  load(0);
  for (int t = 0; t < n_tiles; ++t) {
#pragma unroll
    for (int r = 0; r < kA4; ++r) {
      const int f = threadIdx.x + T * r;
      const int m = f / (kDepth / 4), k = 4 * (f % (kDepth / 4));
      As[(k + 0) * kARows + m] = ra[r].x;
      As[(k + 1) * kARows + m] = ra[r].y;
      As[(k + 2) * kARows + m] = ra[r].z;
      As[(k + 3) * kARows + m] = ra[r].w;
    }
#pragma unroll
    for (int r = 0; r < kB4; ++r) {
      const int f = threadIdx.x + T * r;
      reinterpret_cast<float4*>(Bs)[f] = rb[r];
    }
    __syncthreads();
    load(t + 1);  // in flight during the products below
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const float4 a0 = reinterpret_cast<const float4*>(As + k * kARows + 8 * ty)[0];
      const float4 a1 = reinterpret_cast<const float4*>(As + k * kARows + 8 * ty)[1];
      const float4 b = reinterpret_cast<const float4*>(Bs + k * kTileCols)[tx];
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        acc[u][0] = fmaf(a[u], b.x, acc[u][0]);
        acc[u][1] = fmaf(a[u], b.y, acc[u][1]);
        acc[u][2] = fmaf(a[u], b.z, acc[u][2]);
        acc[u][3] = fmaf(a[u], b.w, acc[u][3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 8; ++u)
    reinterpret_cast<float4*>(Ps + (8 * ty + u) * kTileCols)[tx] =
        make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
  cluster.sync();  // every block's partial product is in its shared memory
  // block `rank` adds the rows it owns over the cluster, in rank order
  constexpr int kOwn = BM / KS;
  static_assert(BM % KS == 0, "every block owns whole rows of the tile");
  static_assert(kOwn * kTileCols / 4 <= T, "one float4 of the sum per thread");
  if (threadIdx.x < kOwn * kTileCols / 4) {
    const int r = rank * kOwn + threadIdx.x / (kTileCols / 4);
    const int c4 = threadIdx.x % (kTileCols / 4);
    float4 s = zero;
    for (int h = 0; h < KS; ++h) {
      const float4 p = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(Ps, h) + r * kTileCols)[c4];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    const int m = row0 + r, n = col0 + 4 * c4;
    if (m < M && n < N)
      *reinterpret_cast<float4*>(Cm + (long long)m * N + n) = s;
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// The cluster's shape: BM output rows per block, the depth split KS ways.
constexpr int kMmRows = 32;
constexpr int kMmSplit = 16;

}  // namespace

// C entry points, bound with ctypes.  Each launches on `stream` and returns
// cudaGetLastError() (0 = launched).

// kinds/idx/out_cols/in_rows/shifts: n_stages host entries, first stage
// first; is_int selects the int32 kernel over the float32 one.
extern "C" int staged_gather_launch(const void* src, void* out, int is_int,
                                    int src_cols, int out_rows, int out_cols,
                                    int n_stages, const int* kinds,
                                    const void* const* idx, const int* stage_cols,
                                    const int* in_rows, const int* shifts,
                                    void* stream) {
  if (n_stages < 0 || n_stages > kMaxStages) return (int)cudaErrorInvalidValue;
  Plan plan = {};
  plan.n_stages = n_stages;
  plan.out_rows = out_rows;
  plan.out_cols = out_cols;
  plan.src_cols = src_cols;
  for (int t = 0; t < n_stages; ++t) {
    plan.stage[t].idx = static_cast<const int*>(idx[t]);
    plan.stage[t].kind = kinds[t];
    plan.stage[t].out_cols = stage_cols[t];
    plan.stage[t].in_rows = in_rows[t];
    plan.stage[t].shift = shifts[t];
  }
  const long long n = (long long)out_rows * out_cols;
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kGatherThreads - 1) / kGatherThreads);
    cudaStream_t s = (cudaStream_t)stream;
    if (is_int)
      staged_gather_kernel<int><<<blocks, kGatherThreads, 0, s>>>(
          static_cast<const int*>(src), static_cast<int*>(out), plan);
    else
      staged_gather_kernel<float><<<blocks, kGatherThreads, 0, s>>>(
          static_cast<const float*>(src), static_cast<float*>(out), plan);
  }
  return (int)cudaGetLastError();
}

extern "C" int column_scatter_launch(const float* val, const int* idx, int n_in,
                                     int cols, float* out, int n_rows,
                                     void* stream) {
  if (n_rows > 0 && cols > 0) {
    const int blocks = (n_rows + kScatterRows - 1) / kScatterRows;
    column_scatter_kernel<<<blocks, kScatterThreads, 0, (cudaStream_t)stream>>>(
        val, idx, n_in, cols, out, n_rows);
  }
  return (int)cudaGetLastError();
}

// A, B, C row-major and 16-byte aligned; K and N multiples of 4.
extern "C" int matmul_f32_launch(const float* A, const float* B, float* C,
                                 int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  auto kernel = matmul_f32_kernel<kMmRows, kMmSplit>;
  const int smem = mm_smem_floats<kMmRows>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && kMmSplit > 8)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = kMmSplit;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kTileCols - 1) / kTileCols, (M + kMmRows - 1) / kMmRows,
                     kMmSplit);
  cfg.blockDim = dim3(kMmRows / 8 * 32, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, A, B, C, M, N, K);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
