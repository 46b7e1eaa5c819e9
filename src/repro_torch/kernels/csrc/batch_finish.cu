// Completing a training batch on the card (models/gnn/batching.py::
// complete_batch). A batch producer writes each layer's relabelled edge
// lists and the table's global vertex ids; the card builds the counts, the
// feature rows of a batch without them, and (with the radix sort of
// segment_sort.cu) the two edge orders, with these two kernels:
//   1. table_rows_kernel: out[r] = table[ids[r]], a zero row where ids[r] is
//      padding (< 0) or past the table. The table may lie in pinned host
//      memory, mapped into the card's address space: each row then crosses
//      the bus once, read in place by the threads that write it to the
//      padded table (one 16-byte load and store each at F % 4 == 0), and
//      the feature matrix stays in the host tier. A plain copy: the bits of
//      the host's gather.
//   2. sorted_counts_kernel: the edges of each row v in [0, n), read off
//      keys sorted ascending (the dst-sorted keys the radix sort writes,
//      padding keyed n): the distance between two binary searches, as
//      float. No atomics: each count is one thread's subtraction, so it has
//      the bits of np.bincount(...).astype(float32) (counts < 2**24).
// Both are bound by latency at a batch's size (36k rows of 512 bytes, 49k
// keys): the rows by the bus, the counts by a few dependent loads a row.
#include <algorithm>

#include "common.cuh"

namespace repro_torch {

constexpr int kFinishThreads = 256;

template <int VEC>
__global__ void __launch_bounds__(kFinishThreads)
    table_rows_kernel(const float* __restrict__ table, long long rows, int dim,
                      const long long* __restrict__ ids, int V, float* __restrict__ out) {
  const int per_row = dim / VEC;
  const long long total = static_cast<long long>(V) * per_row;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const long long r = t / per_row;
    const int c = static_cast<int>(t - r * per_row) * VEC;
    const long long id = ids[r];
    Pack<float, VEC> v;
#pragma unroll
    for (int i = 0; i < VEC; ++i) v.v[i] = 0.0f;
    if (id >= 0 && id < rows) v = *reinterpret_cast<const Pack<float, VEC>*>(table + id * dim + c);
    *reinterpret_cast<Pack<float, VEC>*>(out + r * dim + c) = v;
  }
}

// First slot of keys[0, E) (ascending) whose key is >= v.
__device__ __forceinline__ int first_at_least(const int* __restrict__ keys, int E, int v) {
  int lo = 0, hi = E;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (keys[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kFinishThreads)
    sorted_counts_kernel(const int* __restrict__ keys, int E, int n, float* __restrict__ out) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  out[v] = static_cast<float>(first_at_least(keys, E, v + 1) - first_at_least(keys, E, v));
}

}  // namespace repro_torch

using namespace repro_torch;

// table: float32 [rows, dim], in pinned (mapped) host memory or on the
// card; ids: int64 [V]; out: float32 [V, dim] on the card. vec (1, 2 or 4)
// divides dim and the base addresses in floats.
extern "C" int table_rows(const void* table, long long rows, int dim, const void* ids, int V,
                          int vec, void* out, void* stream) {
  if (V <= 0 || dim <= 0) return 0;
  if ((vec != 1 && vec != 2 && vec != 4) || dim % vec) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // where the card reads the table: a mapped host range's device address,
  // or the card's own memory; pageable host memory has none
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, table);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.devicePointer == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const float* src = static_cast<const float*>(attr.devicePointer);
  const long long* ix = static_cast<const long long*>(ids);
  float* dst = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(V) * (dim / vec);
  const int blocks =
      static_cast<int>(std::min<long long>((total + kFinishThreads - 1) / kFinishThreads, 1 << 16));
  if (vec == 4) {
    table_rows_kernel<4><<<blocks, kFinishThreads, 0, s>>>(src, rows, dim, ix, V, dst);
  } else if (vec == 2) {
    table_rows_kernel<2><<<blocks, kFinishThreads, 0, s>>>(src, rows, dim, ix, V, dst);
  } else {
    table_rows_kernel<1><<<blocks, kFinishThreads, 0, s>>>(src, rows, dim, ix, V, dst);
  }
  return static_cast<int>(cudaGetLastError());
}

// Page-locks [ptr, ptr + bytes) of host memory and maps it into the card's
// address space, so that table_rows reads it in place; host_unregister
// undoes it. The caller owns the memory and keeps it alive in between.
extern "C" int host_register(void* ptr, long long bytes) {
  return static_cast<int>(cudaHostRegister(ptr, static_cast<size_t>(bytes),
                                           cudaHostRegisterMapped | cudaHostRegisterPortable));
}

extern "C" int host_unregister(void* ptr) {
  return static_cast<int>(cudaHostUnregister(ptr));
}

// keys: int32 [E] ascending; out: float32 [n] on the card.
extern "C" int sorted_counts(const void* keys, int E, int n, void* out, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sorted_counts_kernel<<<(n + kFinishThreads - 1) / kFinishThreads, kFinishThreads, 0, s>>>(
      static_cast<const int*>(keys), E, n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
