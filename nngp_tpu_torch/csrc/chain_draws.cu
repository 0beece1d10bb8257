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
// normals Box-Muller in IEEE float64 (log, sqrt, and cos and sin of one
// angle from sincos; built without --use_fast_math), u1 and u2 from words
// (0, 1) and (2, 3), each result rounded once to float32.
//
// What bounds it.  At the main path's shapes (n = 64,274 sites, 10
// sweeps) the sweep normals dominate: 1.93 M float32 (7.7 MB) at 3
// chains, 61.7 M (247 MB) at 96, written once, 2.3 us and 74 us at 3.35
// TB/s.  The instructions bound it harder.  The float64 Box-Muller has no
// SFU path: CUDA's log, sqrt and sincos are polynomials and Newton steps
// on the FP64 pipe (64 lanes an SM a clock, half the float32 rate; a lone
// DADD or DMUL takes a whole slot), and each 64-bit constant of their
// polynomials costs two UMOVs.  One Philox call of normals is ~465 SASS
// instructions on the path its data takes, 144 of them on the FP64 pipe
// (experiments/draws_bench.py:sass_counts counts them in this kernel's
// tile), so at 96 chains and the highest SM clock its issue floor (four
// warp instructions a clock an SM) lies near 0.21 ms and its FP64 floor
// near 0.13 ms, both far above the byte time.
// What the design does about it:
// - a block owns one tile: kThreads * Calls consecutive Philox calls of
//   one (field, chain) row, found by a block-uniform scan of the fields
//   and one 32-bit division, so the field, its kind, the chain id (one
//   load a block) and the counter's words 1-3 are uniform: no warp
//   diverges on the kind and no thread divides;
// - each thread takes Calls calls kThreads apart (neighbouring threads on
//   neighbouring calls): four in a large launch, so a block's set-up and
//   the round keys are paid once for four calls; one in a small launch,
//   which then spreads over more blocks (kManyFrom);
// - each Philox round is one IMAD.WIDE.U32 a multiplier (hi and lo words);
// - sincos shares the range reduction of cos and sin: the card gives the
//   same two doubles for every one of the 2^32 angles the kernel takes
//   (sincos_check below; chip_smoke.py and tests/test_torch_cuda.py run
//   it);
// - 64-bit arithmetic only in the row's base pointer; element offsets in
//   a row are 32-bit (a row holds under 2^31 numbers);
// - where a row starts 16-byte aligned (ops/draws.py pads each field's
//   base to 4 floats, so every row of a field of 4k numbers a chain, the
//   sweep normals' 10 x 64,274 among them), a call's four numbers go out
//   as one float4: a warp writes 512 contiguous bytes an instruction.
//   Other rows, and a row's ragged last call, take scalar stores.
// The output is written once, in order, and nothing is read but the chain
// ids, so TMA, cp.async, shared-memory staging and tensor cores have no
// role here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxFields = 16;
constexpr int kThreads = 128;               // a block
// Philox calls a thread: four in a launch of at least kManyFrom calls (two
// full waves of an H100's 132 SMs x 2,048 threads at four calls a thread),
// where they amortise a block's set-up and round keys (96 chains, 15.4 M
// calls); else one, which spreads a small launch over more blocks (3
// chains, 482 k calls: 1.8 waves at one call a thread).
constexpr int kManyCalls = 4;
constexpr long long kManyFrom = 2LL * 132 * 2048 * kManyCalls;
constexpr unsigned int kItBits = 20;
// what a field holds: uniforms, normals, or the Philox words themselves
// (their bits in the float buffer; the tests hold them to the twin's)
constexpr int kUniform = 0, kNormal = 1, kWords = 2;

struct Fields {
  long long base[kMaxFields];       // first element of each field's block
  int first_tile[kMaxFields + 1];   // first block of each field
  int tiles[kMaxFields];            // blocks a (field, chain) row
  int count[kMaxFields];            // numbers a chain
  int calls[kMaxFields];            // Philox calls a chain: ceil(count / 4)
  unsigned int tag[kMaxFields];     // f << 20 | it
  int kind[kMaxFields];             // kUniform, kNormal or kWords
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned long long p0 = 0xD2511F53ull * c.x;
    const unsigned long long p1 = 0xCD9E8D57ull * c.z;
    c = make_uint4((unsigned int)(p1 >> 32) ^ c.y ^ k.x, (unsigned int)p1,
                   (unsigned int)(p0 >> 32) ^ c.w ^ k.y, (unsigned int)p0);
  }
  return c;
}

__device__ __forceinline__ float uniform01(unsigned int x) {
  return ((float)(x >> 9) + 0.5f) * 0x1p-23f;
}

// 2 pi u2 for the word b, 2 pi as the twin rounds it to a double.
__device__ __forceinline__ double angle(unsigned int b) {
  const double u2 = ((double)b + 0.5) * 0x1p-32;
  return 6.283185307179586 * u2;
}

// The twin's roundings: r = sqrt(-2 log u1), r cos t and r sin t, each
// rounded once to float32.
__device__ __forceinline__ float2 normal_pair(unsigned int a,
                                              unsigned int b) {
  const double u1 = ((double)a + 0.5) * 0x1p-32;
  const double r = sqrt(-2.0 * log(u1));
  double s, c;
  sincos(angle(b), &s, &c);
  return make_float2((float)(r * c), (float)(r * s));
}

template <int Kind>
__device__ __forceinline__ float4 numbers(uint4 w) {
  if constexpr (Kind == kNormal) {
    const float2 z01 = normal_pair(w.x, w.y), z23 = normal_pair(w.z, w.w);
    return make_float4(z01.x, z01.y, z23.x, z23.y);
  }
  if constexpr (Kind == kWords)
    return make_float4(__uint_as_float(w.x), __uint_as_float(w.y),
                       __uint_as_float(w.z), __uint_as_float(w.w));
  return make_float4(uniform01(w.x), uniform01(w.y), uniform01(w.z),
                     uniform01(w.w));
}

// Call `call`'s four numbers into the row (call < the row's calls).
__device__ __forceinline__ void store(float* __restrict__ row, bool vec,
                                      unsigned int call, unsigned int count,
                                      float4 v) {
  const unsigned int e0 = 4u * call;
  if (vec && e0 + 4u <= count) {
    *reinterpret_cast<float4*>(row + e0) = v;
    return;
  }
  row[e0] = v.x;
  if (e0 + 1u < count) row[e0 + 1u] = v.y;
  if (e0 + 2u < count) row[e0 + 2u] = v.z;
  if (e0 + 3u < count) row[e0 + 3u] = v.w;
}

// A thread's calls first, first + kThreads, ... (Calls of them) of one row.
template <int Kind, int Calls>
__device__ __forceinline__ void draw_strip(float* __restrict__ row, bool vec,
                                           unsigned int first,
                                           unsigned int calls,
                                           unsigned int count, uint4 ctr,
                                           uint2 key) {
  if (first + (Calls - 1) * kThreads < calls) {    // the whole strip
#pragma unroll
    for (int j = 0; j < Calls; ++j) {
      ctr.x = first + j * kThreads;
      store(row, vec, ctr.x, count, numbers<Kind>(philox4x32_10(ctr, key)));
    }
    return;
  }
#pragma unroll 1
  for (unsigned int call = first; call < calls; call += kThreads) {
    ctr.x = call;
    store(row, vec, call, count, numbers<Kind>(philox4x32_10(ctr, key)));
  }
}

template <int Calls>
__global__ void __launch_bounds__(kThreads)
chain_draws_kernel(float* __restrict__ out,
                   const long long* __restrict__ chains,
                   unsigned long long seed, unsigned int cycle_start,
                   Fields fs) {
  const int b = (int)blockIdx.x;
  int f = 0;
  while (b >= fs.first_tile[f + 1]) ++f;            // block-uniform
  const int local = b - fs.first_tile[f];
  const int c = local / fs.tiles[f];                 // one division a block
  const unsigned int tile = (unsigned int)(local - c * fs.tiles[f]);
  __shared__ unsigned int chain;
  if (threadIdx.x == 0) chain = (unsigned int)chains[c];
  __syncthreads();
  const unsigned int calls = (unsigned int)fs.calls[f];
  const unsigned int first = tile * (kThreads * Calls) + threadIdx.x;
  if (first - threadIdx.x % 32u >= calls) return;    // a warp past the row
  const unsigned int count = (unsigned int)fs.count[f];
  float* row = out + fs.base[f] + (long long)c * fs.count[f];
  const bool vec = (reinterpret_cast<uintptr_t>(row) & 15u) == 0;
  const uint4 ctr = make_uint4(0u, cycle_start, chain, fs.tag[f]);
  const uint2 key = make_uint2((unsigned int)seed,
                               (unsigned int)(seed >> 32));
  switch (fs.kind[f]) {
    case kNormal:
      draw_strip<kNormal, Calls>(row, vec, first, calls, count, ctr, key);
      break;
    case kWords:
      draw_strip<kWords, Calls>(row, vec, first, calls, count, ctr, key);
      break;
    default:
      draw_strip<kUniform, Calls>(row, vec, first, calls, count, ctr, key);
  }
}

// The launch of every field at Calls Philox calls a thread: a tile of
// kThreads * Calls calls of one row a block.
template <int Calls>
int launch_tiles(float* out, const long long* chains, int C, int n_fields,
                 const long long* base, const int* count, const int* field,
                 const int* kind, unsigned long long seed,
                 unsigned int cycle_start, unsigned int it,
                 cudaStream_t stream) {
  Fields fs{};
  long long tiles = 0;
  for (int f = 0; f < n_fields; ++f) {
    fs.base[f] = base[f];
    fs.count[f] = count[f];
    fs.calls[f] = (int)(((long long)count[f] + 3) / 4);
    fs.tiles[f] = (fs.calls[f] + kThreads * Calls - 1) / (kThreads * Calls);
    fs.tag[f] = ((unsigned int)field[f] << kItBits) | it;
    fs.kind[f] = kind[f];
    fs.first_tile[f] = (int)tiles;
    tiles += (long long)C * fs.tiles[f];
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  fs.first_tile[n_fields] = (int)tiles;
  if (tiles == 0) return (int)cudaGetLastError();
  chain_draws_kernel<Calls><<<(unsigned int)tiles, kThreads, 0, stream>>>(
      out, chains, seed, cycle_start, fs);
  return (int)cudaGetLastError();
}

// cos and sin alone, as the twin's torch.cos and torch.sin compute them:
// kept out of line, so that the compiler cannot share their reduction.
__device__ __noinline__ double cos_alone(double t) { return cos(t); }
__device__ __noinline__ double sin_alone(double t) { return sin(t); }

// Words b at which sincos(angle(b)) differs from (cos_alone, sin_alone)
// in a bit, over all 2^32 words, added into *differ.
__global__ void sincos_check_kernel(unsigned long long* differ) {
  unsigned long long n = 0;
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long w = (unsigned long long)blockIdx.x * blockDim.x
                              + threadIdx.x;
       w < (1ull << 32); w += stride) {
    const double t = angle((unsigned int)w);
    double s, c;
    sincos(t, &s, &c);
    n += (__double_as_longlong(s) != __double_as_longlong(sin_alone(t))) |
         (__double_as_longlong(c) != __double_as_longlong(cos_alone(t)));
  }
  if (n) atomicAdd(differ, n);
}

}  // namespace

// Philox calls a thread in a launch of `calls` calls in all.
extern "C" int chain_draws_tile_calls(long long calls) {
  return calls >= kManyFrom ? kManyCalls : 1;
}

// C entry point, bound with ctypes.  The per-field arrays are host arrays
// of n_fields entries (each base a multiple of 4 floats); `chains` (int64,
// C) and `out` are device pointers.  Launches on `stream`; returns the
// CUDA error (0 = launched).
extern "C" int chain_draws_launch(float* out, const long long* chains, int C,
                                  int n_fields, const long long* base,
                                  const int* count, const int* field,
                                  const int* kind, unsigned long long seed,
                                  unsigned int cycle_start, unsigned int it,
                                  void* stream) {
  if (n_fields < 0 || n_fields > kMaxFields || C < 0)
    return (int)cudaErrorInvalidValue;
  long long calls = 0;
  for (int f = 0; f < n_fields; ++f) {
    if (count[f] < 0 || base[f] < 0 || base[f] % 4 || kind[f] < kUniform ||
        kind[f] > kWords)
      return (int)cudaErrorInvalidValue;
    calls += C * (((long long)count[f] + 3) / 4);
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (chain_draws_tile_calls(calls) == kManyCalls)
    return launch_tiles<kManyCalls>(out, chains, C, n_fields, base, count,
                                    field, kind, seed, cycle_start, it, s);
  return launch_tiles<1>(out, chains, C, n_fields, base, count, field, kind,
                         seed, cycle_start, it, s);
}

// The check behind sincos: adds to *differ (device) the count of the 2^32
// words whose sincos differs from cos and sin.
extern "C" int chain_draws_sincos_check(unsigned long long* differ,
                                        void* stream) {
  sincos_check_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(differ);
  return (int)cudaGetLastError();
}
