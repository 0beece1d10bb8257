// The gather, scatter and matmul probes of experiments/gather_probe.py and
// experiments/gather_probe2.py, as CUDA kernels.
//
// Replaces the Pallas TPU kernels those scripts build in try_kernel
// (gather_probe.py:27,42; gather_probe2.py:29), one body at a time.  The
// TPU scripts asked which gather forms Mosaic lowers into VMEM code; a GPU
// thread loads any address, so three kernels cover the twelve bodies:
//
// staged_gather_kernel<T, N, Code> (f32 and i32): out = stage_N(...
//   stage_1(src)), each stage one of
//     rows   out[i, j] = x[idx[i, j], j]   take_along_axis(x, idx, axis=0)
//     cols   out[i, j] = x[i, idx[i, j]]   take_along_axis(x, idx, axis=1)
//     roll   out[i, j] = x[(i - shift) mod rows, j]   jnp.roll(x, shift, 0)
//     trans  out[i, j] = x[j, i]
//   Serves k_sub, k_lane, k_chain (gather_probe.py:65,71,76) and k_sub,
//   k_lane, k_benes, k_roll, k_tr, k_sub2, k_lanei (gather_probe2.py:51-85).
//   What bounds it on an H100: each body moves 0.1-1 MB, L2-resident, so
//   its bytes take ~0.1-0.4 us, while an empty kernel launched back to
//   back takes 1.726 us (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's
//   launch floor).  So the launch floor bounds it; then each stage's
//   dependent index load (an L2 round trip), and in a rows stage one
//   32-byte sector per element, since each element comes from its own row.
//   Design: the chain's stage kinds are template arguments (Code holds N
//   kinds, two bits each, first stage lowest): the walk back through the
//   stages is straight-line code, one instantiation per sequence of at
//   most 4 kinds, picked by staged_gather_launch.  A 2-D grid of (column
//   group, row) threads with 32-bit indices; each thread owns four
//   consecutive outputs of a row: it loads the last stage's index row as
//   one int4 (where the row is 16-byte aligned), walks the four elements
//   back with their loads in flight together, and stores one float4/int4.
//   The grid is one wave of the card's 132 SMs at most and strides over the
//   rows beyond it.  No intermediate is stored.
//
// transpose_kernel<T> (the chain of one trans stage, k_tr): a 32 x 33
//   shared-memory tile per block, so that the reads of src and the writes
//   of out both run along rows and coalesce.
//
// column_scatter_kernel (k_scat, gather_probe.py:82): out = 0, then
//   out[idx[i, 0], 0] = val[i, 0] for every i, the last i winning, as in
//   XLA's scatter.
//   What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W): the launch
//   floor (an empty kernel back to back: 1.68-1.90 us, by card) and the
//   index column.  A column of a row-major [n_in, cols] tensor puts each
//   element in its own 128-byte line, and an SM looks up about one line a
//   cycle (blocks reading 1,024, 2,048 and 4,096 lines an SM took 3.28,
//   3.60 and 4.5 us), so a block that reads the probe's column ([1024,
//   128]) spends ~0.5 us on lookups, whatever rows it owns.  The design
//   this replaces (16 blocks of 32 rows, 6.67 us) lost 2.45 us to its
//   fill's dependent val[winner] loads, which two threads a block waited
//   on once a pass, sixteen passes in turn, and ~1.8 us to 4-byte stores
//   from 16 SMs.
//   Design: one launch of 256-thread blocks, each owning R >= 8 rows of
//   out: one wave of at most 132 blocks where the rows allow it (R = 8,
//   64 blocks at the probe's shape), so that each SM reads the column
//   once whatever n_rows is, up to R = 6,144.  A block issues its first
//   1,024 index loads before anything else, stores the zeros of its rows
//   as float4s (scalars at a ragged edge) while they fly, then loads
//   val[i, 0] for each index that names one of its rows and keeps, per
//   row, the largest 64-bit key (i + 1) << 32 | bits(val[i, 0]) by
//   atomicMax in shared memory: the value rides with the winner, so no
//   load waits after the block barrier that precedes the column-0 stores,
//   and the result depends neither on the order of the atomics nor on the
//   call.  The order matters: against a scratch twin in one call, the
//   kernel stood 0.43 us behind while it subtracted r0 from each loaded
//   row before the fill (the subtraction held the fill's stores until the
//   loads returned), 0.19 us behind while its keys were zeroed ahead of
//   the loads, and 0.09 us behind with both fixed.  A 64-bit atomicMax on
//   shared memory compiles to a compare-and-swap loop (ATOMS.CAST.SPIN.64):
//   cheap at a few indices a row, serial where every index names one row.
//   Measured and not taken (scratch builds, one card a call): a cluster
//   that splits the column between its blocks (a cluster launch alone
//   costs 2.33-2.45 us against 1.76, and a 64-bit max pushed to another
//   block's shared memory, by atomicMax or red.shared::cluster.max.u64,
//   gave wrong winners where the 32-bit form was right); fill blocks
//   apart from scan blocks (no faster); the value loaded for every index
//   (+0.35 us: twice the lines); 4 to 16 rows a block (within 0.1 us).
//
// matmul_f32_kernel<KS> (k_mm, gather_probe.py:93, through try_kernel
//   :27,42): C = A B to float32 accuracy on the tensor cores, as 3xTF32.
//   Each operand x is split into hi = tf32(x) and lo = tf32(x - hi)
//   (cvt.rna; x - hi is exact in float32), and C = A_lo B_hi + A_hi B_lo +
//   A_hi B_hi.  The tensor cores' f32 accumulation truncates, so each
//   32-deep tile's twelve products go to fresh accumulators that are added
//   to the block's sums, rounded to nearest.
//   Design: a block of two warpgroups owns a 64 x 128 tile of C, 64
//   columns per warpgroup (wgmma.m64n64k8.tf32).  Thread 0 streams A's and
//   B's 32-deep tiles in by TMA (zero fill past the ragged edges) into two
//   stages behind mbarriers.  All 256 threads split each arrived stage into
//   hi/lo tiles in the 128-byte-swizzled K-major layout that the wgmma
//   descriptors name (tf32 wgmma takes K-major operands only, so B's tile
//   is transposed there), into one of two buffers, so that one tile's
//   products run while the next tile is split.  The depth is split KS ways
//   (a power of two up to 8, so that tiles x KS fill the 132 SMs) across
//   the blocks of one cluster; each block then adds, in rank order, the
//   rows it owns over the cluster through distributed shared memory, so
//   two calls give bit-identical C.  A cluster of 16 would need two blocks
//   on an SM to be resident at once, which these blocks' registers and
//   shared memory do not allow.
//   What bounds it (NVIDIA H100 80GB HBM3, 700 W): at the probe's
//   512 x 1024 x 128 (KS = 8, 64 blocks of 4 tiles) latency: the launch
//   (1.7 us), the split (~0.7 us a tile: a compare/select per cvt and 18 KB
//   of shared-memory traffic), the DSMEM sum (~1.1 us: each block reads a
//   whole 32 KB tile over the cluster network) and two cluster barriers.
//   At 2048 x 2048 x 512 (KS = 1) the split and the L2 traffic of 64 x 128
//   tiles.  The SIMT FP32 design this replaces spent 4.7 us staging
//   operands through registers and 3.9 us on FFMAs at the probe's shape.

// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (nngp_tpu_torch/ops/_build.py); no fast-math.

#include <cooperative_groups.h>
#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cudaTypedefs.h>   // PFN_cuTensorMapEncodeTiled
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------- gathers

constexpr int kMaxStages = 4;
constexpr int kGroupsX = 32;        // column groups of 4 outputs per block
constexpr int kRowsY = 8;           // rows per block per pass
constexpr int kGatherWave = 132 * 8;   // blocks of 256 threads resident at once
constexpr int kTile = 32;           // transpose tile
enum StageKind : int { kRows = 0, kCols = 1, kRoll = 2, kTrans = 3 };

struct Stage {
  const int* idx;  // rows/cols: index map with this stage's output shape
  int out_cols;    // columns of this stage's output (row stride of idx)
  int in_rows;     // rows of this stage's input (the modulus of a roll)
  int shift;       // roll
};

struct Plan {
  Stage stage[kMaxStages];
  int out_rows, out_cols;
  int src_cols;
  int vec;         // out_cols % 4 == 0 and the last stage's idx 16-byte aligned
};

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };

// Applies stages t, t - 1, ..., 0 of the chain Code to four walks (i, j).
template <int Code, int t>
__device__ __forceinline__ void walk(const Plan& plan, int (&i)[4], int (&j)[4]) {
  if constexpr (t >= 0) {
    constexpr int kind = (Code >> (2 * t)) & 3;
    const Stage& st = plan.stage[t];
    if constexpr (kind == kRows) {
      int v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = __ldg(st.idx + i[u] * st.out_cols + j[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) i[u] = v[u];
    } else if constexpr (kind == kCols) {
      int v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = __ldg(st.idx + i[u] * st.out_cols + j[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) j[u] = v[u];
    } else if constexpr (kind == kRoll) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        i[u] -= st.shift;  // 0 <= shift < in_rows (the wrapper reduces it)
        if (i[u] < 0) i[u] += st.in_rows;
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = i[u];
        i[u] = j[u];
        j[u] = k;
      }
    }
    walk<Code, t - 1>(plan, i, j);
  }
}

template <typename T, int N, int Code>
__global__ void __launch_bounds__(kGroupsX * kRowsY)
staged_gather_kernel(const T* __restrict__ src, T* __restrict__ out,
                     Plan plan) {
  const int j0 = 4 * (blockIdx.x * kGroupsX + threadIdx.x);
  if (j0 >= plan.out_cols) return;
  const int n_valid = min(4, plan.out_cols - j0);
  for (int r = blockIdx.y * kRowsY + threadIdx.y; r < plan.out_rows;
       r += gridDim.y * kRowsY) {
    int i[4], j[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      i[u] = r;
      j[u] = j0 + min(u, n_valid - 1);  // a ragged edge repeats its last column
    }
    constexpr int kLast = N > 0 ? (Code >> (2 * (N - 1))) & 3 : kRoll;
    if constexpr (N > 0 && (kLast == kRows || kLast == kCols)) {
      const int* row = plan.stage[N - 1].idx + r * plan.out_cols;
      int v[4];
      if (plan.vec) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(row + j0));
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = __ldg(row + j[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) (kLast == kRows ? i[u] : j[u]) = v[u];
      walk<Code, N - 2>(plan, i, j);
    } else {
      walk<Code, N - 1>(plan, i, j);
    }
    T v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = __ldg(src + i[u] * plan.src_cols + j[u]);
    T* o = out + r * plan.out_cols + j0;
    if (plan.vec) {
      *reinterpret_cast<typename Vec4<T>::type*>(o) = {v[0], v[1], v[2], v[3]};
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (u < n_valid) o[u] = v[u];
    }
  }
}

// out [cols, rows] = src [rows, cols] transposed, one 32 x 32 tile a block.
template <typename T>
__global__ void __launch_bounds__(kTile * kRowsY)
transpose_kernel(const T* __restrict__ src, T* __restrict__ out, int rows,
                 int cols) {
  __shared__ T tile[kTile][kTile + 1];
  const int c0 = blockIdx.x * kTile, r0 = blockIdx.y * kTile;
  for (int k = threadIdx.y; k < kTile; k += kRowsY) {
    const int r = r0 + k, c = c0 + threadIdx.x;
    if (r < rows && c < cols) tile[k][threadIdx.x] = __ldg(src + r * cols + c);
  }
  __syncthreads();
  for (int k = threadIdx.y; k < kTile; k += kRowsY) {
    const int r = c0 + k, c = r0 + threadIdx.x;   // out row = src column
    if (r < cols && c < rows) out[r * rows + c] = tile[threadIdx.x][k];
  }
}

template <typename T>
using GatherKernel = void (*)(const T*, T*, Plan);

// The instantiation for the chain of N stages whose kinds Code packs.
template <typename T, int N, int... C>
GatherKernel<T> pick_chain(int code, std::integer_sequence<int, C...>) {
  static const GatherKernel<T> table[] = {&staged_gather_kernel<T, N, C>...};
  return table[code];
}

template <typename T>
GatherKernel<T> chain_kernel(int n_stages, int code) {
  switch (n_stages) {
    case 0: return pick_chain<T, 0>(code, std::make_integer_sequence<int, 1>{});
    case 1: return pick_chain<T, 1>(code, std::make_integer_sequence<int, 4>{});
    case 2: return pick_chain<T, 2>(code, std::make_integer_sequence<int, 16>{});
    case 3: return pick_chain<T, 3>(code, std::make_integer_sequence<int, 64>{});
    default: return pick_chain<T, 4>(code, std::make_integer_sequence<int, 256>{});
  }
}

template <typename T>
void launch_chain(const Plan& plan, int n_stages, int code, const T* src,
                  T* out, int src_rows, cudaStream_t s) {
  const dim3 block(kGroupsX, kRowsY);
  if (n_stages == 1 && code == kTrans) {
    const dim3 grid((plan.out_rows + kTile - 1) / kTile,
                    (src_rows + kTile - 1) / kTile);
    transpose_kernel<T><<<grid, block, 0, s>>>(src, out, src_rows, plan.out_rows);
    return;
  }
  const int gx = ((plan.out_cols + 3) / 4 + kGroupsX - 1) / kGroupsX;
  const int rows_y = (plan.out_rows + kRowsY - 1) / kRowsY;
  const int gy = max(1, min(rows_y, kGatherWave / gx));
  chain_kernel<T>(n_stages, code)<<<dim3(gx, gy), block, 0, s>>>(src, out, plan);
}

// ---------------------------------------------------------------- scatter

constexpr int kScatterThreads = 256;
constexpr int kScatterLoads = 4;       // index loads in flight a thread
constexpr int kScatterMinRows = 8;     // rows a block owns, at least
constexpr int kScatterMaxRows = 6144;  // and at most: 48 KB of keys
constexpr int kScatterWave = 132;      // blocks of one wave: an H100 SXM's SMs

// Rows a block owns: one wave of blocks where the rows allow it.
int scatter_rows(int n_rows) {
  const int r = (n_rows + kScatterWave - 1) / kScatterWave;
  return r < kScatterMinRows ? kScatterMinRows
                             : (r > kScatterMaxRows ? kScatterMaxRows : r);
}

// Zeros into p[0, n): scalars up to a 16-byte boundary, float4s, scalars.
__device__ __forceinline__ void zero_fill(float* __restrict__ p, int n) {
  const int head = min((4 - (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3)) & 3, n);
  const int n4 = (n - head) >> 2;
  const int tail = (n - head) & 3;
  float4* q = reinterpret_cast<float4*>(p + head);
  if ((int)threadIdx.x < head) p[threadIdx.x] = 0.0f;
  for (int k = threadIdx.x; k < n4; k += kScatterThreads)
    q[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if ((int)threadIdx.x < tail) p[head + 4 * n4 + threadIdx.x] = 0.0f;
}

// The rows named by indices b + u * kScatterThreads + threadIdx.x (-1 past
// n_in).  Nothing is computed from them here: an instruction that used a
// loaded row would hold the zero fill's stores until the loads returned.
__device__ __forceinline__ void scatter_rows_named(const int* __restrict__ idx,
                                                   int n_in, int cols, unsigned b,
                                                   int (&row)[kScatterLoads]) {
#pragma unroll
  for (int u = 0; u < kScatterLoads; ++u) {
    const unsigned i = b + u * kScatterThreads + threadIdx.x;
    row[u] = i < (unsigned)n_in ? __ldg(idx + (long long)i * cols) : -1;
  }
}

// Block b owns rows [b R, b R + R) of out, R = rows_per_block; key[r] is
// (i + 1) << 32 | bits(val[i, 0]) for the largest i naming row r0 + r.
__global__ void __launch_bounds__(kScatterThreads)
column_scatter_kernel(const float* __restrict__ val,  // [n_in, cols]
                      const int* __restrict__ idx,    // [n_in, cols]
                      int n_in, int cols,
                      float* __restrict__ out,        // [n_rows, cols]
                      int n_rows, int rows_per_block) {
  extern __shared__ unsigned long long key[];
  const int r0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n_rows - r0);
  int row[kScatterLoads];
  scatter_rows_named(idx, n_in, cols, 0, row);   // ahead of all else
  for (int r = threadIdx.x; r < rows; r += kScatterThreads) key[r] = 0;
  zero_fill(out + (long long)r0 * cols, rows * cols);   // while the loads fly
  __syncthreads();
  for (unsigned b = 0;;) {   // unsigned: b passes n_in by < 2^10
    float v[kScatterLoads];
#pragma unroll
    for (int u = 0; u < kScatterLoads; ++u) {
      const unsigned i = b + u * kScatterThreads + threadIdx.x;
      v[u] = (unsigned)(row[u] - r0) < (unsigned)rows
                 ? __ldg(val + (long long)i * cols) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kScatterLoads; ++u) {
      const int off = row[u] - r0;
      if ((unsigned)off < (unsigned)rows) {
        const unsigned i = b + u * kScatterThreads + threadIdx.x;
        atomicMax(&key[off], (unsigned long long)(i + 1) << 32 | __float_as_uint(v[u]));
      }
    }
    b += kScatterLoads * kScatterThreads;
    if (b >= (unsigned)n_in) break;
    scatter_rows_named(idx, n_in, cols, b, row);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += kScatterThreads) {
    const unsigned long long k = key[r];
    out[(long long)(r0 + r) * cols] = k ? __uint_as_float((unsigned)k) : 0.0f;
  }
}

// ----------------------------------------------------------------- matmul

constexpr int kMmRows = 64;       // rows of C per block: wgmma m64
constexpr int kMmCols = 128;      // columns of C per block: wgmma n128
constexpr int kMmDepth = 32;      // depth of a stage: one 128-byte row of f32
constexpr int kMmStages = 2;      // TMA stages in flight
constexpr int kMmThreads = 256;   // two warpgroups, one per 64 columns
constexpr int kMmHalf = kMmCols / 2;   // columns of C per warpgroup: wgmma n64
constexpr int kMmAcc = kMmHalf / 2;    // f32 accumulators per thread
constexpr int kMmMaxSplit = 8;    // blocks of a cluster, all resident at once
constexpr int kMmSms = 132;       // SMs of an H100 SXM
constexpr int kMmPartStride = kMmCols + 8;   // floats per row of a partial
constexpr int kMmSpinLimit = 1 << 26;        // tries before a lost TMA traps

// A stage as TMA writes it: A's tile K-major with the 128-byte swizzle
// (row r, depth k at r * 32 + 4 * ((k / 4) ^ (r % 8)) + k % 4), B's tile
// as stored, [depth][cols].  Every tile starts on 1024 bytes, where the
// swizzle pattern repeats.
struct __align__(1024) MmStage {
  float a[kMmRows * kMmDepth];
  float b[kMmDepth * kMmCols];
};
// The wgmma operands: hi and lo of A in A's layout, of B transposed to
// K-major with the same swizzle (column n, depth k at
// n * 32 + 4 * ((k / 4) ^ (n % 8)) + k % 4).
struct __align__(1024) MmSplit {
  float a_hi[kMmRows * kMmDepth], a_lo[kMmRows * kMmDepth];
  float b_hi[kMmCols * kMmDepth], b_lo[kMmCols * kMmDepth];
};
struct MmShared {
  MmStage stage[kMmStages];   // after the main loop: the block's partial tile
  MmSplit split[2];           // tile t's products run while t + 1 is split
  unsigned long long full[kMmStages];   // mbarrier: the stage has arrived
};
static_assert(kMmRows * kMmPartStride * sizeof(float) <= sizeof(MmStage) * kMmStages,
              "the partial tile fits in the idle stages");
static_assert(kMmThreads % kMmCols == 0 && kMmThreads / kMmCols <= kMmDepth / 4,
              "whole columns of B per thread in the split");
constexpr int kMmSmem = sizeof(MmShared) + 1024;   // + slack to align the base

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits for the phase after `parity`; traps rather than hang the card if
// the bytes never arrive.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == kMmSpinLimit) __trap();
  }
}

// TMA: the box at (c0, c1) of `map` (innermost coordinate first) into
// shared memory at `dst`, its bytes counted on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// x = hi + lo + (x - hi - lo): hi and lo are TF32 (low 13 bits zero),
// rounded to nearest with ties away from zero; x - hi is exact.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  hi = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
  lo = make_float4(tf32_rna(x.x - hi.x), tf32_rna(x.y - hi.y),
                   tf32_rna(x.z - hi.z), tf32_rna(x.w - hi.w));
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 bytes, groups of 8 rows 1024 bytes apart (the
// stride offset); the leading offset is unused by this layout.  Adding
// 2 to it steps 8 of depth (32 bytes) along the rows.
__device__ __forceinline__ uint64_t sw128_desc(const float* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d = A B + (accumulate ? d : 0) for a 64 x 8 A and an 8 x 64 B in TF32,
// f32 accumulators in the wgmma layout: d[i] is row 16 * (warp % 4) +
// lane / 4 + 8 * (i / 2 % 2), column 8 * (i / 4) + 2 * (lane % 4) + i % 2.
__device__ __forceinline__ void wgmma_tf32(float (&d)[kMmAcc], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Keeps the compiler from moving accumulator accesses across a wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[kMmAcc]) {
#pragma unroll
  for (int i = 0; i < kMmAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// KS: the depth split, the blocks of one cluster (1: no cluster).
template <int KS>
__global__ void __launch_bounds__(kMmThreads)
matmul_f32_kernel(const __grid_constant__ CUtensorMap tm_a,  // A [M, K]
                  const __grid_constant__ CUtensorMap tm_b,  // B [K, N]
                  float* __restrict__ Cm,                    // C [M, N]
                  int M, int N, int K, int tiles_per_rank) {
  // The dynamic window need not start on 1024 bytes: step to the next
  // multiple by indexing (the compiler keeps the shared address space).
  extern __shared__ __align__(1024) unsigned char mm_smem[];
  MmShared& sh = *reinterpret_cast<MmShared*>(
      mm_smem + ((1024 - (smem_u32(mm_smem) & 1023)) & 1023));
  const int rank = KS > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kMmRows, col0 = blockIdx.x * kMmCols;
  const int t0 = rank * tiles_per_rank;   // this block's first depth tile
  const int n_k = max(0, min(tiles_per_rank, (K + kMmDepth - 1) / kMmDepth - t0));

  auto fetch = [&](int t) {   // thread 0: depth tile t into its stage
    MmStage& st = sh.stage[t % kMmStages];
    const uint32_t bar = smem_u32(&sh.full[t % kMmStages]);
    const int k0 = (t0 + t) * kMmDepth;
    mbar_expect_tx(bar, sizeof(MmStage));
    tma_load_2d(smem_u32(st.a), &tm_a, bar, k0, row0);
    tma_load_2d(smem_u32(st.b), &tm_b, bar, col0, k0);
  };
  if (tid == 0) {
    for (int s = 0; s < kMmStages; ++s) mbar_init(smem_u32(&sh.full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int t = 0; t < min(kMmStages, n_k); ++t) fetch(t);
  }
  __syncthreads();   // the barriers are initialised

  // The tensor cores' f32 accumulation truncates, so each depth tile's
  // twelve products go to fresh registers (tile0 for even tiles, tile1
  // for odd) that are then added, rounded to nearest, into `acc`.
  float acc[kMmAcc], tile0[kMmAcc], tile1[kMmAcc];
#pragma unroll
  for (int i = 0; i < kMmAcc; ++i) acc[i] = tile0[i] = tile1[i] = 0.f;
  const int wg = tid / 128;   // this warpgroup's columns: wg * 64 on
  // Depth tile t: split its stage into split[t % 2], start its products
  // into `cur` and, once tile t - 1's products are done, add `prev`.
  auto step = [&](int t, float (&cur)[kMmAcc], float (&prev)[kMmAcc]) {
    const MmStage& st = sh.stage[t % kMmStages];
    MmSplit& hl = sh.split[t % 2];
    mbar_wait(smem_u32(&sh.full[t % kMmStages]), (t / kMmStages) & 1);
    // A: same layout in and out, float4 by float4
#pragma unroll
    for (int j = 0; j < kMmRows * kMmDepth / 4 / kMmThreads; ++j) {
      const int c = tid + kMmThreads * j;
      float4 hi, lo;
      split4(reinterpret_cast<const float4*>(st.a)[c], hi, lo);
      reinterpret_cast<float4*>(hl.a_hi)[c] = hi;
      reinterpret_cast<float4*>(hl.a_lo)[c] = lo;
    }
    // B: column n, four of depth per 16-byte store
    constexpr int kGroups = kMmThreads / kMmCols, kChunks = kMmDepth / 4 / kGroups;
    const int n = tid % kMmCols;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int kc = tid / kMmCols * kChunks + j;
      const float* col = st.b + 4 * kc * kMmCols + n;
      float4 hi, lo;
      split4(make_float4(col[0], col[kMmCols], col[2 * kMmCols], col[3 * kMmCols]),
             hi, lo);
      const int c = n * (kMmDepth / 4) + (kc ^ (n & 7));
      reinterpret_cast<float4*>(hl.b_hi)[c] = hi;
      reinterpret_cast<float4*>(hl.b_lo)[c] = lo;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");   // for wgmma
    __syncthreads();   // the split is whole; the stage is read
    if (tid == 0 && t + kMmStages < n_k) fetch(t + kMmStages);
    const uint64_t a_hi = sw128_desc(hl.a_hi), a_lo = sw128_desc(hl.a_lo);
    const uint64_t b_hi = sw128_desc(hl.b_hi + wg * kMmHalf * kMmDepth);
    const uint64_t b_lo = sw128_desc(hl.b_lo + wg * kMmHalf * kMmDepth);
    fence_acc(cur);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kMmDepth / 8; ++kk) {
      wgmma_tf32(cur, a_lo + 2 * kk, b_hi + 2 * kk, kk > 0);
      wgmma_tf32(cur, a_hi + 2 * kk, b_lo + 2 * kk, 1);
      wgmma_tf32(cur, a_hi + 2 * kk, b_hi + 2 * kk, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_acc(prev);
#pragma unroll
    for (int i = 0; i < kMmAcc; ++i) acc[i] += prev[i];   // 0 before tile 1
    __syncthreads();   // tile t - 1's products are done with its split
  };
  for (int t = 0; t < n_k; t += 2) {
    step(t, tile0, tile1);
    if (t + 1 < n_k) step(t + 1, tile1, tile0);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(tile0);
  fence_acc(tile1);
  if (n_k > 0) {
    if (n_k % 2) {
#pragma unroll
      for (int i = 0; i < kMmAcc; ++i) acc[i] += tile0[i];
    } else {
#pragma unroll
      for (int i = 0; i < kMmAcc; ++i) acc[i] += tile1[i];
    }
  }

  const int warp = tid / 32 % 4, lane = tid % 32;
  const int r_acc = 16 * warp + lane / 4, c_acc = wg * kMmHalf + 2 * (lane % 4);
  if constexpr (KS == 1) {
#pragma unroll
    for (int i = 0; i < kMmAcc; i += 2) {
      const int m = row0 + r_acc + 8 * (i / 2 % 2), n = col0 + 8 * (i / 4) + c_acc;
      if (m < M && n < N)   // N is even, so n + 1 < N too
        *reinterpret_cast<float2*>(Cm + (long long)m * N + n) =
            make_float2(acc[i], acc[i + 1]);
    }
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    float* part = reinterpret_cast<float*>(sh.stage);   // every load was consumed
#pragma unroll
    for (int i = 0; i < kMmAcc; i += 2)
      *reinterpret_cast<float2*>(part + (r_acc + 8 * (i / 2 % 2)) * kMmPartStride +
                                 8 * (i / 4) + c_acc) = make_float2(acc[i], acc[i + 1]);
    cluster.sync();   // every block's partial tile is in its shared memory
    // block `rank` adds the rows it owns over the cluster, in rank order;
    // all KS loads of a thread are in flight at once
    constexpr int kOwn = kMmRows / KS;
    for (int e = tid; e < kOwn * (kMmCols / 4); e += kMmThreads) {
      const int off = (rank * kOwn + e / (kMmCols / 4)) * kMmPartStride + 4 * (e % (kMmCols / 4));
      float4 p[KS];
#pragma unroll
      for (int h = 0; h < KS; ++h)
        p[h] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, h) + off);
      float4 s = p[0];
#pragma unroll
      for (int h = 1; h < KS; ++h) {
        s.x += p[h].x;
        s.y += p[h].y;
        s.z += p[h].z;
        s.w += p[h].w;
      }
      const int m = row0 + rank * kOwn + e / (kMmCols / 4), n = col0 + 4 * (e % (kMmCols / 4));
      if (m < M && n < N)
        *reinterpret_cast<float4*>(Cm + (long long)m * N + n) = s;
    }
    cluster.sync();   // no block leaves while another reads its partial
  }
}

// cuTensorMapEncodeTiled from libcuda, reached through the runtime's
// entry-point query so that the library needs no -lcuda; null if absent.
PFN_cuTensorMapEncodeTiled tensor_map_encoder() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                              &found) != cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
}

// A row-major float32 [outer, inner] matrix in boxes of box_outer x
// box_inner; TMA fills the part of a box past the edge with zeros.
CUresult encode_2d(PFN_cuTensorMapEncodeTiled encode, CUtensorMap* map,
                   const float* base, int inner, int outer, int box_inner,
                   int box_outer, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
                dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

using MmKernel = void (*)(CUtensorMap, CUtensorMap, float*, int, int, int, int);

MmKernel matmul_kernel_for(int ks) {
  switch (ks) {
    case 1: return matmul_f32_kernel<1>;
    case 2: return matmul_f32_kernel<2>;
    case 4: return matmul_f32_kernel<4>;
    case 8: return matmul_f32_kernel<8>;
    default: return nullptr;
  }
}

}  // namespace

// C entry points, bound with ctypes.  Each launches on `stream` and returns
// cudaGetLastError() (0 = launched).

// kinds/idx/out_cols/in_rows/shifts: n_stages host entries, first stage
// first; is_int selects the int32 kernels over the float32 ones.  Every
// element count must be below 2^31 (the wrapper checks).
extern "C" int staged_gather_launch(const void* src, void* out, int is_int,
                                    int src_cols, int out_rows, int out_cols,
                                    int n_stages, const int* kinds,
                                    const void* const* idx, const int* stage_cols,
                                    const int* in_rows, const int* shifts,
                                    void* stream) {
  if (n_stages < 0 || n_stages > kMaxStages) return (int)cudaErrorInvalidValue;
  Plan plan = {};
  plan.out_rows = out_rows;
  plan.out_cols = out_cols;
  plan.src_cols = src_cols;
  int code = 0;
  for (int t = 0; t < n_stages; ++t) {
    if (kinds[t] < kRows || kinds[t] > kTrans) return (int)cudaErrorInvalidValue;
    code |= kinds[t] << (2 * t);
    plan.stage[t].idx = static_cast<const int*>(idx[t]);
    plan.stage[t].out_cols = stage_cols[t];
    plan.stage[t].in_rows = in_rows[t];
    plan.stage[t].shift = shifts[t];
  }
  const int* last = n_stages > 0 ? plan.stage[n_stages - 1].idx : nullptr;
  plan.vec = out_cols % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(last) % 16 == 0;
  const int src_rows = n_stages > 0 ? in_rows[0] : out_rows;
  if (out_rows > 0 && out_cols > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (is_int)
      launch_chain<int>(plan, n_stages, code, static_cast<const int*>(src),
                        static_cast<int*>(out), src_rows, s);
    else
      launch_chain<float>(plan, n_stages, code, static_cast<const float*>(src),
                          static_cast<float*>(out), src_rows, s);
  }
  return (int)cudaGetLastError();
}

// Rows of out that one block of column_scatter owns.
extern "C" int column_scatter_rows(int n_rows) { return scatter_rows(n_rows); }

// Every element count below 2^31 (the wrapper checks).
extern "C" int column_scatter_launch(const float* val, const int* idx, int n_in,
                                     int cols, float* out, int n_rows,
                                     void* stream) {
  if (n_rows > 0 && cols > 0) {
    const int rows = scatter_rows(n_rows);
    column_scatter_kernel<<<(n_rows + rows - 1) / rows, kScatterThreads,
                            rows * sizeof(unsigned long long), (cudaStream_t)stream>>>(
        val, idx, n_in, cols, out, n_rows, rows);
  }
  return (int)cudaGetLastError();
}

// The depth split of a C of M x N with depth K: the largest power of two
// up to 8, and up to the number of 32-deep tiles, for which the blocks
// (64 x 128 tiles of C times the split) fit on the 132 SMs at once.
extern "C" int matmul_f32_split(int M, int N, int K) {
  const long long tiles = (long long)((M + kMmRows - 1) / kMmRows) *
                          ((N + kMmCols - 1) / kMmCols);
  const int depth_tiles = (K + kMmDepth - 1) / kMmDepth;
  int ks = 1;
  while (2 * ks <= kMmMaxSplit && 2 * ks <= depth_tiles && tiles * 2 * ks <= kMmSms)
    ks *= 2;
  return ks;
}

// A, B, C row-major and 16-byte aligned; K and N multiples of 4 (TMA's
// address and stride rules).  Returns 0 when launched, a cudaError_t, or
// minus the CUresult of a tensor map that failed to encode.
extern "C" int matmul_f32_launch(const float* A, const float* B, float* C,
                                 int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (K == 0) {   // an empty sum: no tensor map has a zero extent
    cudaError_t e = cudaMemsetAsync(C, 0, (size_t)M * N * sizeof(float), s);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
  static const PFN_cuTensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  static const cudaError_t attr = [] {   // once per process
    cudaError_t e = cudaSuccess;
    for (int ks = 1; ks <= kMmMaxSplit && e == cudaSuccess; ks *= 2) {
      e = cudaFuncSetAttribute(matmul_kernel_for(ks),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMmSmem);
    }
    return e;
  }();
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tm_a, tm_b;
  CUresult r = encode_2d(encode, &tm_a, A, K, M, kMmDepth, kMmRows,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == CUDA_SUCCESS)
    r = encode_2d(encode, &tm_b, B, N, K, kMmCols, kMmDepth,
                  CU_TENSOR_MAP_SWIZZLE_NONE);
  if (r != CUDA_SUCCESS) return -(int)r;
  const int ks = matmul_f32_split(M, N, K);
  int tiles_per_rank = ((K + kMmDepth - 1) / kMmDepth + ks - 1) / ks;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 1;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = ks;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kMmCols - 1) / kMmCols, (M + kMmRows - 1) / kMmRows, ks);
  cfg.blockDim = dim3(kMmThreads, 1, 1);
  cfg.dynamicSmemBytes = kMmSmem;
  cfg.stream = s;
  cfg.attrs = attrs;
  cfg.numAttrs = ks > 1 ? 1 : 0;
  void* args[] = {&tm_a, &tm_b, &C, &M, &N, &K, &tiles_per_rank};
  cudaError_t e = cudaLaunchKernelExC(&cfg, (const void*)matmul_kernel_for(ks), args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
