// Sorted-segment (CSR) sum: out[r] = sum of msg[e] over the edges of row r.
//
// Replaces src/repro/kernels/fused_gnn.py::segment_spmm_ragged_pallas, which
// turns the scatter into a one-hot matmul per edge tile for the TPU's MXU.
// On Hopper the sum does no arithmetic worth a tensor core (one add per
// element read), so it is bound by the bytes of `msg`. Each row is reduced
// by a group of `tpr` threads that walks the row's edge slots in order with
// 16-byte loads per thread and a float accumulator per column; the row is
// written once, cast to the message dtype at the end. No float atomics:
// the sum order of a row is fixed by the edge order, so a row's result is
// the same in any batch.
#include "common.cuh"

namespace repro_torch {

// Row offsets from a segment-id array: row_ptr[r] = first slot whose key is
// >= r, for r in [0, n]. Thread e writes the rows in (key[e-1], key[e]]; for
// a non-decreasing key every row is written exactly once. A decrease sets
// *unsorted (zeroed by the caller), and the reductions then take the
// fallback of `for_each_edge`.
__global__ void segment_offsets_kernel(const int* __restrict__ seg, int E, int n,
                                       int* __restrict__ row_ptr, int* __restrict__ unsorted) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e > E) return;
  const int lo = (e == 0) ? 0 : seg_key(seg[e - 1], n) + 1;
  const int hi = (e == E) ? n : seg_key(seg[e], n);
  for (int r = lo; r <= hi; ++r) row_ptr[r] = e;
  if (e > 0 && e < E && hi < lo - 1) *unsorted = 1;
}

template <typename T, int VEC>
__global__ void segment_sum_kernel(const T* __restrict__ msg, const int* __restrict__ seg, int E,
                                   const int* __restrict__ row_ptr,
                                   const int* __restrict__ unsorted, int n, int D, int tpr,
                                   T* __restrict__ out) {
  const int row = blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const int lane = threadIdx.x % tpr;
  if (row >= n) return;
  const bool scan = *unsorted != 0;
  for (int c = lane * VEC; c < D; c += tpr * VEC) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for_each_edge(row, n, row_ptr, seg, E, scan, [&](int e) {
      float x[VEC];
      load_vec<VEC>(msg + static_cast<size_t>(e) * D + c, x);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += x[i];
    });
    store_vec<VEC>(out + static_cast<size_t>(row) * D + c, acc);
  }
}

template <typename T, int VEC>
static cudaError_t launch_sum(const void* msg, const int* seg, int E, const int* row_ptr,
                              const int* unsorted, int n, int D, int tpr, void* out,
                              cudaStream_t stream) {
  const int rows_per_block = kThreads / tpr;
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  segment_sum_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(msg), seg, E, row_ptr, unsorted, n, D, tpr, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace repro_torch

using namespace repro_torch;

// seg [E] int32; index [n + 2] int32, zeroed: row_ptr in [0, n], the
// unsorted flag at [n + 1].
extern "C" int segment_offsets(const void* seg, int E, int n, void* index, void* stream) {
  int* idx = static_cast<int*>(index);
  const int blocks = E / kThreads + 1;  // E + 1 threads
  segment_offsets_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seg), E, n, idx, idx + n + 1);
  return static_cast<int>(cudaGetLastError());
}

// msg [E, D] (dtype), seg [E], index [n + 2] from segment_offsets, out
// [n, D] (dtype). `vec` elements per load and `tpr` threads per row are
// chosen by the wrapper.
extern "C" int segment_sum(const void* msg, const void* seg, int E, const void* index, int n,
                           int D, int dtype, int vec, int tpr, void* out, void* stream) {
  if (n == 0) return 0;
  const int* sg = static_cast<const int*>(seg);
  const int* rp = static_cast<const int*>(index);
  const int* un = rp + n + 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    switch (vec) {
      case 4: return launch_sum<float, 4>(msg, sg, E, rp, un, n, D, tpr, out, s);
      case 2: return launch_sum<float, 2>(msg, sg, E, rp, un, n, D, tpr, out, s);
      case 1: return launch_sum<float, 1>(msg, sg, E, rp, un, n, D, tpr, out, s);
    }
  } else if (dtype == kBF16) {
    switch (vec) {
      case 8: return launch_sum<__nv_bfloat16, 8>(msg, sg, E, rp, un, n, D, tpr, out, s);
      case 4: return launch_sum<__nv_bfloat16, 4>(msg, sg, E, rp, un, n, D, tpr, out, s);
      case 2: return launch_sum<__nv_bfloat16, 2>(msg, sg, E, rp, un, n, D, tpr, out, s);
      case 1: return launch_sum<__nv_bfloat16, 1>(msg, sg, E, rp, un, n, D, tpr, out, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
