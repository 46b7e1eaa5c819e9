// Per-row edge softmax + weighted sum, all heads in one launch:
//   out[r, h] = sum_e softmax_{e in row r}(logits[e, h]) * msg[e, h, :]
//
// Replaces src/repro/kernels/fused_gnn.py::gat_softmax_aggregate_pallas,
// which streams edge tiles through one-hot matmuls with an online max /
// denominator / accumulator carried across the sequential TPU grid. On
// Hopper a row's edges are contiguous in CSR order (common.cuh covers
// unsorted input), so one group of `tpr` threads owns each (row, head): it
// takes the row max over the logits (a few floats per row, read by every
// lane of the group as one broadcast),
// then one pass over the row's messages accumulates exp(l - max) and
// exp(l - max) * msg in float, and divides by max(z, 1e-9) once. An empty
// row keeps the -1e30 sentinel max and z = 0, so it yields 0, as the TPU
// kernel does. The work is bound by the bytes of `msg`; the exp per edge
// is recomputed by each lane of a group instead of being shared, which
// costs no memory traffic. No atomics, so a row's result is batch-order
// independent. For training, the kernel also writes each (row, head)'s max
// and denominator (m_out, z_out, when not null), the running max and
// denominator the TPU kernel outputs too; the backward
// (gat_softmax_backward.cu) recomputes each edge's weight from them.
#include "common.cuh"

namespace repro_torch {

constexpr float kNegInf = -1e30f;

template <typename T, int VEC>
__global__ void gat_softmax_aggregate_kernel(const float* __restrict__ logits,
                                             const T* __restrict__ msg,
                                             const int* __restrict__ seg, int E,
                                             const int* __restrict__ row_ptr,
                                             const int* __restrict__ unsorted, int n, int H,
                                             int dh, int tpr, T* __restrict__ out,
                                             float* __restrict__ m_out,
                                             float* __restrict__ z_out) {
  const long long g = static_cast<long long>(blockIdx.x) * (blockDim.x / tpr) + threadIdx.x / tpr;
  const int lane = threadIdx.x % tpr;
  if (g >= static_cast<long long>(n) * H) return;
  const int row = static_cast<int>(g / H);
  const int h = static_cast<int>(g % H);
  const bool scan = *unsorted != 0;
  float m = kNegInf;
  for_each_edge(row, n, row_ptr, seg, E, scan, [&](int e) {
    m = fmaxf(m, logits[static_cast<size_t>(e) * H + h]);
  });
  for (int c = lane * VEC; c < dh; c += tpr * VEC) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    float z = 0.f;
    for_each_edge(row, n, row_ptr, seg, E, scan, [&](int e) {
      const size_t eh = static_cast<size_t>(e) * H + h;
      const float p = expf(logits[eh] - m);
      float x[VEC];
      load_vec<VEC>(msg + eh * dh + c, x);
      z += p;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += p * x[i];
    });
    if (c == 0 && m_out != nullptr) {
      m_out[g] = m;
      z_out[g] = z;
    }
    const float zc = fmaxf(z, 1e-9f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = acc[i] / zc;
    store_vec<VEC>(out + (static_cast<size_t>(row) * H + h) * dh + c, acc);
  }
}

template <typename T, int VEC>
static cudaError_t launch_gat(const float* logits, const void* msg, const int* seg, int E,
                              const int* row_ptr, const int* unsorted, int n, int H, int dh,
                              int tpr, void* out, float* m_out, float* z_out,
                              cudaStream_t stream) {
  const int groups_per_block = kThreads / tpr;
  const long long groups = static_cast<long long>(n) * H;
  const long long blocks = (groups + groups_per_block - 1) / groups_per_block;
  gat_softmax_aggregate_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      logits, static_cast<const T*>(msg), seg, E, row_ptr, unsorted, n, H, dh, tpr,
      static_cast<T*>(out), m_out, z_out);
  return cudaGetLastError();
}

}  // namespace repro_torch

using namespace repro_torch;

// logits [E, H] float32, msg [E, H, dh] (dtype), seg [E], the CSR index
// from segment_offsets (segment_sum.cu; row_ptr in [0, n], the unsorted
// flag at [n + 1]), out [n, H, dh] (dtype); stats null, or float32
// [2, n, H] for the max and the denominator of each (row, head).
extern "C" int gat_softmax_aggregate(const void* logits, const void* msg, const void* seg, int E,
                                     const void* index, int n, int H, int dh, int dtype, int vec,
                                     int tpr, void* out, void* stats, void* stream) {
  if (n == 0 || H == 0) return 0;
  const float* lg = static_cast<const float*>(logits);
  const int* sg = static_cast<const int*>(seg);
  const int* rp = static_cast<const int*>(index);
  const int* un = rp + n + 1;
  float* m_out = static_cast<float*>(stats);
  float* z_out = m_out == nullptr ? nullptr : m_out + static_cast<size_t>(n) * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_GAT(T, V) \
  launch_gat<T, V>(lg, msg, sg, E, rp, un, n, H, dh, tpr, out, m_out, z_out, s)
  if (dtype == kF32) {
    switch (vec) {
      case 4: return REPRO_GAT(float, 4);
      case 2: return REPRO_GAT(float, 2);
      case 1: return REPRO_GAT(float, 1);
    }
  } else if (dtype == kBF16) {
    switch (vec) {
      case 8: return REPRO_GAT(__nv_bfloat16, 8);
      case 4: return REPRO_GAT(__nv_bfloat16, 4);
      case 2: return REPRO_GAT(__nv_bfloat16, 2);
      case 1: return REPRO_GAT(__nv_bfloat16, 1);
    }
  }
#undef REPRO_GAT
  return static_cast<int>(cudaErrorInvalidValue);
}
