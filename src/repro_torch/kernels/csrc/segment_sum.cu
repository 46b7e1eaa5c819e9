// Sorted-segment (CSR) sums, with or without a gather:
//   segment_sum:        out[r] = sum of msg[e] over the edges e of row r
//   gather_segment_sum: out[r] = sum of feats[idx[e]] over the edges e of row r
//
// segment_sum replaces src/repro/kernels/fused_gnn.py::segment_spmm_ragged_pallas,
// gather_segment_sum replaces fused_gnn.py::gather_spmm_ragged_pallas and,
// after the stable sort of segment_sort.cu (with idx = the permutation, or
// idx[perm]), the dense gather_spmm_pallas / segment_spmm_pallas call
// forms, whose ids come in any order. The TPU kernels turn the scatter into a one-hot matmul per
// edge tile for the MXU, with the gather done inside the tile so the [E, D]
// message array never exists. On Hopper the sum does no arithmetic worth a
// tensor core (one add per element read), so it is bound by the bytes of the
// rows it reads. Each row is reduced by a group of `tpr` threads that walks
// the row's edge slots in order with 16-byte loads per thread and a float
// accumulator per column; the gather form reads the row through `idx` in the
// load (idx < 0 drops the edge), so it too never writes an [E, D] array. The
// row is written once, cast to the dtype at the end. No float atomics: the
// sum order of a row is fixed by its edge order, so a row's result is the
// same in any batch and on every run. The training backward of the gather
// is the gather form itself over the edges sorted by idx, with idx and seg
// swapped (kernels/fused_gnn.py).
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

// GATHER false: row r sums src[e]; true: row r sums src[idx[e]], skipping
// idx[e] < 0.
template <typename T, int VEC, bool GATHER>
__global__ void segment_sum_kernel(const T* __restrict__ src, const int* __restrict__ idx,
                                   const int* __restrict__ seg, int E,
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
      int r = e;
      if constexpr (GATHER) {
        r = idx[e];
        if (r < 0) return;
      }
      float x[VEC];
      load_vec<VEC>(src + static_cast<size_t>(r) * D + c, x);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += x[i];
    });
    store_vec<VEC>(out + static_cast<size_t>(row) * D + c, acc);
  }
}

template <typename T, int VEC, bool GATHER>
static cudaError_t launch_sum(const void* src, const int* idx, const int* seg, int E,
                              const int* row_ptr, const int* unsorted, int n, int D, int tpr,
                              void* out, cudaStream_t stream) {
  const int rows_per_block = kThreads / tpr;
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  segment_sum_kernel<T, VEC, GATHER><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(src), idx, seg, E, row_ptr, unsorted, n, D, tpr,
      static_cast<T*>(out));
  return cudaGetLastError();
}

template <bool GATHER>
static int dispatch_sum(const void* src, const void* idx, const void* seg, int E,
                        const void* index, int n, int D, int dtype, int vec, int tpr, void* out,
                        void* stream) {
  if (n == 0) return 0;
  const int* ix = static_cast<const int*>(idx);
  const int* sg = static_cast<const int*>(seg);
  const int* rp = static_cast<const int*>(index);
  const int* un = rp + n + 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SUM(T, V) launch_sum<T, V, GATHER>(src, ix, sg, E, rp, un, n, D, tpr, out, s)
  if (dtype == kF32) {
    switch (vec) {
      case 4: return REPRO_SUM(float, 4);
      case 2: return REPRO_SUM(float, 2);
      case 1: return REPRO_SUM(float, 1);
    }
  } else if (dtype == kBF16) {
    switch (vec) {
      case 8: return REPRO_SUM(__nv_bfloat16, 8);
      case 4: return REPRO_SUM(__nv_bfloat16, 4);
      case 2: return REPRO_SUM(__nv_bfloat16, 2);
      case 1: return REPRO_SUM(__nv_bfloat16, 1);
    }
  }
#undef REPRO_SUM
  return static_cast<int>(cudaErrorInvalidValue);
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
  return dispatch_sum<false>(msg, nullptr, seg, E, index, n, D, dtype, vec, tpr, out, stream);
}

// feats [F, D] (dtype), idx [E] int32 rows of feats (-1 = padding), seg [E],
// index [n + 2] from segment_offsets over seg, out [n, D] (dtype).
extern "C" int gather_segment_sum(const void* feats, const void* idx, const void* seg, int E,
                                  const void* index, int n, int D, int dtype, int vec, int tpr,
                                  void* out, void* stream) {
  return dispatch_sum<true>(feats, idx, seg, E, index, n, D, dtype, vec, tpr, out, stream);
}
