// Every random number of one Gibbs iteration, for every chain of a rank,
// in one launch: Philox4x32-10 under per-chain counters.
//
// Replaces no Pallas kernel.  It is the counterpart of XLA's threefry
// behind jax.random.normal and jax.random.uniform under nngp_tpu's
// per-chain keys fold_in(fold_in(key(seed), iter_start), chain)
// (nngp_tpu/api.py:599-601): each number is a pure function of (seed, the
// cycle's first iteration, the global chain id, the iteration within the
// cycle, the field, the element), so a chain draws the same bits whatever
// the batch, the rank or the number of ranks.  The packing, the maps from
// words to numbers and the plain twin are in ops/draws.py; this file and
// the twin must stay bit for bit equal.
//
// Number e of field f for chain c at iteration it is word e % 4 of
//   philox4x32_10((e / 4, cycle_start, c, f << 20 | it),
//                 (seed mod 2^32, seed >> 32)).
// Uniforms are ((x >> 9) + 0.5) 2^-23 in float32 (exact, inside (0, 1));
// normals Box-Muller in IEEE float64 (log, cos, sin, sqrt; built without
// --use_fast_math), u1 and u2 from words (0, 1) and (2, 3), each result
// rounded once to float32.
//
// One thread a Philox call: it writes four numbers of one (field, chain)
// row.  The fields lie one after another in one buffer, field f a
// contiguous [C, count_f] block from base_f; the thread's field comes from
// a scan of the fields' first threads (at most kMaxFields).
//
// Bound.  At the main path's shapes (n = 64,274 sites, 10 sweeps) the
// sweep normals dominate: 1.93 M float32 (7.7 MB) at 3 chains, 61.7 M
// (247 MB) at 96, written once, 2.3 us and 74 us at 3.35 TB/s.  Each pair
// of normals costs a float64 log, sqrt, cos and sin (~70 operations on
// the FMA pipe, no SFU path for float64), ~2.3 G operations at 96 chains,
// 67 us at 34 TFLOP/s; the integer rounds run on other pipes.  A simple
// design: no shared memory, scalar stores of four consecutive floats.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxFields = 16;
constexpr int kThreads = 256;
constexpr unsigned int kItBits = 20;
// what a field holds: uniforms, normals, or the Philox words themselves
// (their bits in the float buffer; the tests hold them to the twin's)
constexpr int kUniform = 0, kNormal = 1, kWords = 2;

struct Fields {
  long long first[kMaxFields + 1];  // first thread of each field
  long long base[kMaxFields];       // first element of each field's block
  int count[kMaxFields];            // numbers a chain
  int calls[kMaxFields];            // Philox calls a chain: ceil(count / 4)
  unsigned int tag[kMaxFields];     // f << 20 | it
  int kind[kMaxFields];             // kUniform, kNormal or kWords
  int n_fields;
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned int hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned int lo0 = 0xD2511F53u * c.x;
    const unsigned int hi1 = __umulhi(0xCD9E8D57u, c.z);
    const unsigned int lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ float uniform01(unsigned int x) {
  return ((float)(x >> 9) + 0.5f) * 0x1p-23f;
}

// cos and sin separately, as the twin's torch.cos and torch.sin compute
// them; 2 pi as the twin rounds it to a double.
__device__ __forceinline__ void normal_pair(unsigned int a, unsigned int b,
                                            float* z0, float* z1) {
  const double u1 = ((double)a + 0.5) * 0x1p-32;
  const double u2 = ((double)b + 0.5) * 0x1p-32;
  const double r = sqrt(-2.0 * log(u1));
  const double t = 6.283185307179586 * u2;
  *z0 = (float)(r * cos(t));
  *z1 = (float)(r * sin(t));
}

__global__ void __launch_bounds__(kThreads)
chain_draws_kernel(float* __restrict__ out,
                   const long long* __restrict__ chains, int C,
                   unsigned long long seed, unsigned int cycle_start,
                   Fields fs) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= fs.first[fs.n_fields]) return;
  int f = 0;
  while (t >= fs.first[f + 1]) ++f;
  const long long local = t - fs.first[f];
  const int c = (int)(local / fs.calls[f]);
  const unsigned int blk = (unsigned int)(local % fs.calls[f]);
  const uint4 w = philox4x32_10(
      make_uint4(blk, cycle_start, (unsigned int)chains[c], fs.tag[f]),
      make_uint2((unsigned int)seed, (unsigned int)(seed >> 32)));
  float v[4];
  if (fs.kind[f] == kNormal) {
    normal_pair(w.x, w.y, &v[0], &v[1]);
    normal_pair(w.z, w.w, &v[2], &v[3]);
  } else if (fs.kind[f] == kWords) {
    v[0] = __uint_as_float(w.x);
    v[1] = __uint_as_float(w.y);
    v[2] = __uint_as_float(w.z);
    v[3] = __uint_as_float(w.w);
  } else {
    v[0] = uniform01(w.x);
    v[1] = uniform01(w.y);
    v[2] = uniform01(w.z);
    v[3] = uniform01(w.w);
  }
  const long long e0 = 4LL * blk;
  float* row = out + fs.base[f] + (long long)c * fs.count[f];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (e0 + j < fs.count[f]) row[e0 + j] = v[j];
}

}  // namespace

// C entry point, bound with ctypes.  The per-field arrays are host arrays
// of n_fields entries; `chains` (int64, C) and `out` are device pointers.
// Launches on `stream`; returns the CUDA error (0 = launched).
extern "C" int chain_draws_launch(float* out, const long long* chains, int C,
                                  int n_fields, const long long* base,
                                  const int* count, const int* field,
                                  const int* kind, unsigned long long seed,
                                  unsigned int cycle_start, unsigned int it,
                                  void* stream) {
  if (n_fields < 0 || n_fields > kMaxFields || C < 0)
    return (int)cudaErrorInvalidValue;
  Fields fs{};
  fs.n_fields = n_fields;
  for (int f = 0; f < n_fields; ++f) {
    if (count[f] < 0 || kind[f] < kUniform || kind[f] > kWords)
      return (int)cudaErrorInvalidValue;
    fs.base[f] = base[f];
    fs.count[f] = count[f];
    fs.calls[f] = (count[f] + 3) / 4;
    fs.tag[f] = ((unsigned int)field[f] << kItBits) | it;
    fs.kind[f] = kind[f];
    fs.first[f + 1] = fs.first[f] + (long long)C * fs.calls[f];
  }
  const long long total = fs.first[n_fields];
  if (total == 0) return (int)cudaGetLastError();
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  chain_draws_kernel<<<(unsigned int)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(out, chains, C, seed,
                                               cycle_start, fs);
  return (int)cudaGetLastError();
}
