// Shared device helpers for the GNN segment kernels.
//
// Every kernel here reads its edges through CSR row offsets built on the
// device by `segment_offsets` (segment_sum.cu): row r owns edge slots
// [row_ptr[r], row_ptr[r+1]) when the segment ids are non-decreasing with
// the padding at the tail. For any other input `segment_offsets` raises a
// flag in device memory and `for_each_edge` falls back to scanning every
// edge for those of row r. Both visit a row's edges in index order (the
// order a stable sort would give), so the two paths give the same bits.
// Rows are reduced by one small thread group each, with no atomics, so a
// row's result does not depend on the rest of the batch.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace repro_torch {

// dtype codes shared with the Python wrappers (kernels/fused_gnn.py)
enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 256;

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
