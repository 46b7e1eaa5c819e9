// Shared device helpers for the GNN segment kernels.
//
// Every kernel here reads its edges through CSR row offsets built on the
// device by `segment_offsets` (segment_sum.cu): row r owns edge slots
// [row_ptr[r], row_ptr[r+1]) when the segment ids are non-decreasing with
// the padding at the tail. The dense call forms (ids in any order) sort
// the ids first (segment_sort.cu) and so always meet that contract. Only a
// caller of a sorted-input form that breaks it gets the O(n * E) fallback:
// `segment_offsets` raises a flag in device memory and `for_each_edge` scans
// every edge for those of row r. Both visit a row's edges in index order
// (the order a stable sort gives), so the two paths give the same bits.
// Rows are reduced by small thread groups with no float atomics, so a
// row's result does not depend on the rest of the batch.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace repro_torch {

// dtype codes shared with the Python wrappers (kernels/fused_gnn.py)
enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 256;

// The CSR sum's chunk length L (segment_sum.cu): a row of more than L edges
// is summed in chunks of L edge slots counted from its first slot, each
// chunk in edge order by a thread group of its own, and the chunks' partial
// sums are then added in chunk order. A row of at most L edges is one chunk,
// summed in edge order as a plain loop would. Mirrored by
// kernels/ref.py::SUM_CHUNK (a CPU test pins the two together). Chosen by
// tools/chunk_sweep.py on an H100: on the stand-in's 1.05 M edges the
// dense sums' kernel took 0.224 / 0.124 ms (float32 / bf16) at L = 64,
// 0.239 / 0.140 at 32 and 0.221 / 0.137 at 128. -DREPRO_SUM_CHUNK=<L>
// builds another length, for that sweep only.
#ifndef REPRO_SUM_CHUNK
#define REPRO_SUM_CHUNK 64
#endif
constexpr int kSumChunk = REPRO_SUM_CHUNK;

// Padding (seg < 0) and out-of-range ids sort after every real row, so a
// batch whose padding sits at the tail is "sorted" under this key.
__device__ __forceinline__ int seg_key(int s, int n) {
  return (s < 0 || s >= n) ? n : s;
}

// Calls f(e) for every edge e of `row`, in index order. The flag is the
// same for every thread of a launch, so the branch never diverges; the
// fallback costs O(E) per row and only runs for unsorted input.
template <typename F>
__device__ __forceinline__ void for_each_edge(int row, int n, const int* __restrict__ row_ptr,
                                              const int* __restrict__ seg, int E, bool unsorted,
                                              F&& f) {
  if (!unsorted) {
    const int end = row_ptr[row + 1];
#pragma unroll 4
    for (int j = row_ptr[row]; j < end; ++j) f(j);
  } else {
    for (int e = 0; e < E; ++e) {
      if (seg_key(seg[e], n) == row) f(e);
    }
  }
}

// Sum of `v` over the `tpr` lanes of this thread's group (tpr a power of two
// up to 32; groups are aligned within the warp, as every kernel here lays
// them out). Every lane of the group gets the total; the butterfly order is
// fixed, so the result is the same on every run.
__device__ __forceinline__ float group_sum(float v, int tpr) {
  const unsigned base = (threadIdx.x & 31u) & ~static_cast<unsigned>(tpr - 1);
  const unsigned mask = tpr == 32 ? 0xffffffffu : ((1u << tpr) - 1u) << base;
  for (int off = tpr / 2; off > 0; off /= 2) v += __shfl_xor_sync(mask, v, off, tpr);
  return v;
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// VEC consecutive elements as float: one 4..16-byte load per thread.
template <int VEC>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float (&x)[VEC]) {
  const Pack<float, VEC> k = *reinterpret_cast<const Pack<float, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) x[i] = k.v[i];
}

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ p, float (&x)[VEC]) {
  const Pack<uint16_t, VEC> k = *reinterpret_cast<const Pack<uint16_t, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) x[i] = __uint_as_float(static_cast<uint32_t>(k.v[i]) << 16);
}

// VEC consecutive elements as stored (float, or bf16 bits): one 4..16-byte
// load, converted only when added, so a batch of loads in flight costs
// 16 bytes of registers each.
template <typename T> struct Storage { using type = T; };
template <> struct Storage<__nv_bfloat16> { using type = uint16_t; };
template <typename T, int VEC>
using Raw = Pack<typename Storage<T>::type, VEC>;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> load_raw(const T* __restrict__ p) {
  return *reinterpret_cast<const Raw<T, VEC>*>(p);
}

template <typename P, int VEC>
__device__ __forceinline__ void add_raw(float (&acc)[VEC], const P& x) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] += to_float(x.v[i]);
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* __restrict__ p, const float (&x)[VEC]) {
  Pack<float, VEC> k;
#pragma unroll
  for (int i = 0; i < VEC; ++i) k.v[i] = x[i];
  *reinterpret_cast<Pack<float, VEC>*>(p) = k;
}

template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* __restrict__ p, const float (&x)[VEC]) {
  Pack<uint16_t, VEC> k;
#pragma unroll
  for (int i = 0; i < VEC; ++i) k.v[i] = __bfloat16_as_ushort(__float2bfloat16_rn(x[i]));
  *reinterpret_cast<Pack<uint16_t, VEC>*>(p) = k;
}

}  // namespace repro_torch
