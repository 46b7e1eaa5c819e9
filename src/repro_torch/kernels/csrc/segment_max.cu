// Per-segment max over edges whose segment ids come in any order:
//   out[s] = max{x[e] : seg[e] == s}, 0.0 where the segment is empty or its
//   max is not finite; edges with seg < 0 (padding) or seg >= n are ignored.
//
// Replaces src/repro/kernels/fused_gnn.py::segment_max_pallas (:348,
// `pallas_call` at :362), with the semantics of its jnp reference
// (repro/kernels/ref.py::segment_max_ref): -inf start, non-finite -> 0.0.
// The TPU kernel masks a one-hot [edge tile, n] matrix and reduces it on
// the VPU, carrying the running max across the sequential grid in its
// output block. On Hopper the blocks run in parallel and in no order.
//
// What bounds it on this card: bytes, in principle. It reads 4 bytes of id
// and 2-4 of value per edge and writes one value per segment, with no
// arithmetic to speak of (1.05 M edges, 150,000 segments: 9 MB, 0.0027 ms
// at 3.35 TB/s). In practice the integer atomics bound it: on an H100 a
// scatter of one atomicMax per edge spent 0.030 ms on the stand-in graph's
// shuffled ids against 0.013 ms on uniform ids of the same E and n, and
// 0.78 ms when one segment holds every edge: atomics on one address
// serialise in its L2 slice (0.74 ns each), so the power-law hubs (up to
// 6,447 in-edges) set the time (tools/time_segment_max.py).
//
// Design. Each float maps to an unsigned 32-bit key whose integer order is
// the float order (negative floats: all bits flipped; others: sign bit
// set), with every NaN mapped to the largest key; under this order -0.0
// lies below +0.0. A memset zeroes a [n] key buffer (0 lies below the key
// of -inf, so it marks an untouched segment). The scatter kernel then
// issues integer `atomicMax`es of the keys, but keeps them off the hot
// segments:
//  * each thread loads kMaxRounds groups of kMaxVec consecutive edges up
//    front (16-byte loads of ids and values, all in flight at once) and
//    folds equal ids inside a group (a sorted run);
//  * where all 32 lanes of a warp hold one id, one lane carries the warp's
//    max (`__reduce_max_sync`);
//  * each block keeps a direct-mapped cache in shared memory of (id, key)
//    pairs it has already sent to device memory; an edge whose id is in
//    the cache with a key at least its own sends nothing. A hub's edges in
//    a block so cost a few atomics, not one each, while an edge of a short
//    row costs one atomic as before (a read of the stored key from L2
//    before each atomic, tried first, cost more than it saved on uniform
//    ids: tools/time_segment_max.py).
// A second kernel decodes each key, gives 0.0 where the segment is empty
// or its max is NaN or +-inf, and casts to x's dtype.
//
// Why the result does not depend on the order of the edges: every key
// stored in a segment's slot is the key of one of its edges, and a slot
// only grows (atomicMax on integers). An edge's key is dropped only where
// a peer in its thread group or warp carries a key at least as large to
// the same slot, or where the block's cache holds that id with a key at
// least as large, which a thread of the block put there beside its own
// atomicMax of that key (entries race, but any entry is a key that goes
// out, so a lost or smaller entry only costs an atomic more). So
// the slot ends at the largest key of the segment's edges, whatever the
// order in which edges, warps and blocks run: the same bits on every run,
// for a row alone or in a batch. No float atomics are used (the project's
// rule).
#include "common.cuh"

namespace repro_torch {

constexpr int kMaxVec = 4;      // edges in a group: one 16-byte load of ids
constexpr int kMaxRounds = 4;   // groups a thread loads before it walks them
constexpr int kCacheBits = 12;  // log2 of the block cache's entries
constexpr unsigned long long kEmpty = ~0ull;  // id -1: no segment
constexpr int kLine = 32;  // keys in a 128-byte line

// The slot of segment s's key among kLine * rows words, rows = ceil(n /
// kLine): line q holds the keys of segments q, q + rows, q + 2 rows, ...,
// so neighbouring ids (a power-law graph's hubs are often a run of old,
// low ids) land in different lines and their atomics in different L2
// slices.
__device__ __forceinline__ int key_slot(int s, int rows) {
  const int q = s / rows;
  return (s - q * rows) * kLine + q;
}

__device__ __forceinline__ unsigned int order_key(float v) {
  const unsigned int u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;  // NaN, either sign
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The inverse of order_key; key 0 (untouched) decodes to a NaN.
__device__ __forceinline__ float from_key(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ float load_f(const float* __restrict__ p, long long e) { return p[e]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* __restrict__ p, long long e) {
  return __bfloat162float(p[e]);
}

__device__ __forceinline__ void store_f(float* __restrict__ p, int s, float v) { p[s] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* __restrict__ p, int s, float v) {
  p[s] = __float2bfloat16_rn(v);  // exact: v is one of the bf16 inputs, or 0
}

// One group of kMaxVec edges from e0: ids (-1 where out of range, padding
// or past E) and keys; a run of equal ids keeps its max in its last edge.
template <typename T, bool kVector>
__device__ __forceinline__ void load_group(const T* __restrict__ x, const int* __restrict__ seg,
                                           long long e0, int E, int n, int (&s)[kMaxVec],
                                           unsigned int (&k)[kMaxVec]) {
  float v[kMaxVec];
  if (kVector && e0 + kMaxVec <= E) {
    const int4 ids = *reinterpret_cast<const int4*>(seg + e0);
    s[0] = ids.x;
    s[1] = ids.y;
    s[2] = ids.z;
    s[3] = ids.w;
    load_vec<kMaxVec>(x + e0, v);
  } else {
#pragma unroll
    for (int j = 0; j < kMaxVec; ++j) {
      const bool in = e0 + j < E;
      s[j] = in ? seg[e0 + j] : -1;
      v[j] = in ? load_f(x, e0 + j) : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    if (s[j] < 0 || s[j] >= n) s[j] = -1;
    k[j] = order_key(v[j]);
  }
#pragma unroll
  for (int j = 1; j < kMaxVec; ++j) {
    if (s[j] == s[j - 1] && s[j] >= 0) {
      k[j] = max(k[j], k[j - 1]);
      s[j - 1] = -1;
    }
  }
}

// Sends `key` for segment `id` (>= 0) unless the block's cache shows a key
// at least as large already sent for it.
__device__ __forceinline__ void send_key(int id, unsigned int key, unsigned int* __restrict__ keys,
                                         int rows, volatile unsigned long long* cache) {
  const unsigned int slot = (static_cast<unsigned int>(id) * 2654435761u) >> (32 - kCacheBits);
  const unsigned long long entry = cache[slot];
  if (static_cast<int>(entry >> 32) == id && static_cast<unsigned int>(entry) >= key) return;
  atomicMax(keys + key_slot(id, rows), key);
  cache[slot] = (static_cast<unsigned long long>(static_cast<unsigned int>(id)) << 32) | key;
}

// The edges of round r, group j of thread t: [(r * T + t) * kMaxVec, +kMaxVec)
// for T threads in the grid, so each round's loads are coalesced.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads) segment_max_scatter_kernel(
    const T* __restrict__ x, const int* __restrict__ seg, int E, int n,
    unsigned int* __restrict__ keys) {
  __shared__ unsigned long long cache[1 << kCacheBits];
  for (int i = threadIdx.x; i < (1 << kCacheBits); i += blockDim.x) cache[i] = kEmpty;
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int rows = (n + kLine - 1) / kLine;
  int s[kMaxRounds][kMaxVec];
  unsigned int k[kMaxRounds][kMaxVec];
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r) {
    load_group<T, kVector>(x, seg, (r * threads + t) * kMaxVec, E, n, s[r], k[r]);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r) {
#pragma unroll
    for (int j = 0; j < kMaxVec; ++j) {
      int id = s[r][j];
      unsigned int key = k[r][j];
      // one id across the warp (a sorted run, a dominant segment): lane 0
      // carries the warp's max; every lane takes part, so the full mask holds
      if (__all_sync(0xffffffffu, id == __shfl_sync(0xffffffffu, id, 0))) {
        key = __reduce_max_sync(0xffffffffu, key);
        if ((threadIdx.x & 31) != 0) id = -1;
      }
      if (id >= 0) send_key(id, key, keys, rows, cache);
    }
  }
}

// A block decodes kLine whole lines (kLine x kLine keys) through shared
// memory: it reads them in slot order and writes, for each of the kLine
// segments a line holds, a run of kLine consecutive outputs, so both sides
// are coalesced.
template <typename T>
__global__ void __launch_bounds__(kThreads) segment_max_decode_kernel(
    const unsigned int* __restrict__ keys, int n, T* __restrict__ out) {
  __shared__ unsigned int tile[kLine][kLine + 1];
  const int rows = (n + kLine - 1) / kLine;
  const int q0 = blockIdx.x * kLine;
#pragma unroll
  for (int w = threadIdx.x; w < kLine * kLine; w += kThreads) {
    const int q = q0 + w / kLine;
    tile[w / kLine][w % kLine] =
        q < rows ? keys[static_cast<long long>(q) * kLine + w % kLine] : 0u;
  }
  __syncthreads();
#pragma unroll
  for (int w = threadIdx.x; w < kLine * kLine; w += kThreads) {
    const int i = w / kLine, q = q0 + w % kLine;
    const int s = i * rows + q;  // key_slot(s, rows) == q * kLine + i
    if (q < rows && s < n) {
      const float v = from_key(tile[w % kLine][i]);
      const bool finite = (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u;
      store_f(out, s, finite ? v : 0.f);
    }
  }
}

template <typename T>
static int launch_max(const void* x, const int* seg, int E, int n, unsigned int* keys,
                      void* out, cudaStream_t stream) {
  const size_t words = static_cast<size_t>((n + kLine - 1) / kLine) * kLine;
  cudaError_t err = cudaMemsetAsync(keys, 0, sizeof(unsigned int) * words, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (E > 0) {
    const long long per_thread = static_cast<long long>(kMaxVec) * kMaxRounds;
    const long long threads = (E + per_thread - 1) / per_thread;
    const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
    const bool vector = reinterpret_cast<uintptr_t>(x) % (sizeof(T) * kMaxVec) == 0 &&
                        reinterpret_cast<uintptr_t>(seg) % sizeof(int4) == 0;
    if (vector) {
      segment_max_scatter_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
          static_cast<const T*>(x), seg, E, n, keys);
    } else {
      segment_max_scatter_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
          static_cast<const T*>(x), seg, E, n, keys);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int rows = (n + kLine - 1) / kLine;
  segment_max_decode_kernel<T><<<(rows - 1) / kLine + 1, kThreads, 0, stream>>>(
      keys, n, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

using namespace repro_torch;

// The 32-bit words of the key scratch for n segments (n rounded up to a
// whole line).
extern "C" long long segment_max_key_words(int n) {
  return static_cast<long long>((n + kLine - 1) / kLine) * kLine;
}

// x [E] (dtype: 0 float32, 1 bfloat16), seg [E] int32 in any order, keys
// [segment_max_key_words(n)] 32-bit scratch, out [n] (dtype). Returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue for a dtype it does not take).
extern "C" int segment_max(const void* x, const void* seg, int E, int n, int dtype, void* keys,
                           void* out, void* stream) {
  if (n == 0) return 0;
  const int* sg = static_cast<const int*>(seg);
  unsigned int* k = static_cast<unsigned int*>(keys);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_max<float>(x, sg, E, n, k, out, s);
  if (dtype == kBF16) return launch_max<__nv_bfloat16>(x, sg, E, n, k, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
