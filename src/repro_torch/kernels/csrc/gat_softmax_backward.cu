// Backward of the per-row edge softmax + weighted sum
// (gat_softmax_aggregate.cu), all heads in one launch. For row s, head h,
// the upstream gradient g = dL/dout[s, h, :] and the edge weight
// alpha_e = exp(l_e - M_s) / max(Z_s, 1e-9), with M and Z kept by the
// forward kernel:
//   dmsg[e, h, :] = alpha_e * g
//   dlogit[e, h]  = alpha_e * (g . msg[e, h, :] - g . out[s, h, :])
//
// New work: the TPU kernel (src/repro/kernels/fused_gnn.py::
// gat_softmax_aggregate_pallas) has no backward, and the JAX trainer
// differentiates the plain jnp path instead. The gradient lands on edges,
// and every edge belongs to one row, so one group of `tpr` threads per
// (row, head) walks that row's CSR edges (common.cuh), takes g . out once,
// then writes each of its edges' gradients. No atomics: each gradient is
// written once, by one group, in a fixed order, so the result is the same
// on every run. The lanes split the dh columns (16-byte loads); the dot
// products are summed across the group with a fixed butterfly of shuffles.
// Bound by bytes: msg and dmsg are read and written once (the upstream
// gradient row is reread per edge from cache). Padding edges (seg < 0 or
// >= n) belong to no row; a grid-stride pass writes their zeros.
#include "common.cuh"

namespace repro_torch {

template <typename T, int VEC>
__global__ void gat_softmax_backward_kernel(
    const float* __restrict__ logits, const T* __restrict__ msg, const T* __restrict__ out,
    const T* __restrict__ grad, const float* __restrict__ m_in, const float* __restrict__ z_in,
    const int* __restrict__ seg, int E, const int* __restrict__ row_ptr,
    const int* __restrict__ unsorted, int n, int H, int dh, int tpr, T* __restrict__ dmsg,
    float* __restrict__ dlogit) {
  const long long g = static_cast<long long>(blockIdx.x) * (blockDim.x / tpr) + threadIdx.x / tpr;
  const int lane = threadIdx.x % tpr;
  // the whole group is either active or not, so its shuffles stay matched
  if (g < static_cast<long long>(n) * H) {
    const int row = static_cast<int>(g / H);
    const int h = static_cast<int>(g % H);
    const bool scan = *unsorted != 0;
    const size_t rh = (static_cast<size_t>(row) * H + h) * dh;
    float go = 0.f;
    for (int c = lane * VEC; c < dh; c += tpr * VEC) {
      float gv[VEC], ov[VEC];
      load_vec<VEC>(grad + rh + c, gv);
      load_vec<VEC>(out + rh + c, ov);
#pragma unroll
      for (int i = 0; i < VEC; ++i) go += gv[i] * ov[i];
    }
    go = group_sum(go, tpr);
    const float m = m_in[g];
    const float zc = fmaxf(z_in[g], 1e-9f);
    for_each_edge(row, n, row_ptr, seg, E, scan, [&](int e) {
      const size_t eh = static_cast<size_t>(e) * H + h;
      const float a = expf(logits[eh] - m) / zc;
      float gm = 0.f;
      for (int c = lane * VEC; c < dh; c += tpr * VEC) {
        float gv[VEC], xv[VEC], dv[VEC];
        load_vec<VEC>(grad + rh + c, gv);
        load_vec<VEC>(msg + eh * dh + c, xv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          gm += gv[i] * xv[i];
          dv[i] = a * gv[i];
        }
        store_vec<VEC>(dmsg + eh * dh + c, dv);
      }
      gm = group_sum(gm, tpr);
      if (lane == 0) dlogit[eh] = a * (gm - go);
    });
  }
  // zeros for the padding edges
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int row_len = H * dh;
  float zero[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) zero[i] = 0.f;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < E;
       e += stride) {
    if (seg_key(seg[e], n) != n) continue;
    for (int c = 0; c < row_len; c += VEC) store_vec<VEC>(dmsg + e * row_len + c, zero);
    for (int j = 0; j < H; ++j) dlogit[e * H + j] = 0.f;
  }
}

template <typename T, int VEC>
static cudaError_t launch_gat_backward(const float* logits, const void* msg, const void* out,
                                       const void* grad, const float* m_in, const float* z_in,
                                       const int* seg, int E, const int* row_ptr,
                                       const int* unsorted, int n, int H, int dh, int tpr,
                                       void* dmsg, float* dlogit, cudaStream_t stream) {
  const int groups_per_block = kThreads / tpr;
  const long long groups = static_cast<long long>(n) * H;
  const long long blocks = (groups + groups_per_block - 1) / groups_per_block;
  gat_softmax_backward_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      logits, static_cast<const T*>(msg), static_cast<const T*>(out),
      static_cast<const T*>(grad), m_in, z_in, seg, E, row_ptr, unsorted, n, H, dh, tpr,
      static_cast<T*>(dmsg), dlogit);
  return cudaGetLastError();
}

}  // namespace repro_torch

using namespace repro_torch;

// logits [E, H] float32, msg [E, H, dh], out and grad [n, H, dh] (dtype),
// stats float32 [2, n, H] from the forward (max, then denominator), seg [E],
// the CSR index from segment_offsets (segment_sum.cu; row_ptr in [0, n],
// the unsorted flag at [n + 1]); writes dmsg [E, H, dh] (dtype) and
// dlogit [E, H] float32. Needs n * H > 0.
extern "C" int gat_softmax_aggregate_backward(const void* logits, const void* msg,
                                              const void* out, const void* grad,
                                              const void* stats, const void* seg, int E,
                                              const void* index, int n, int H, int dh, int dtype,
                                              int vec, int tpr, void* dmsg, void* dlogit,
                                              void* stream) {
  if (n == 0 || H == 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* lg = static_cast<const float*>(logits);
  const float* m_in = static_cast<const float*>(stats);
  const float* z_in = m_in + static_cast<size_t>(n) * H;
  const int* sg = static_cast<const int*>(seg);
  const int* rp = static_cast<const int*>(index);
  const int* un = rp + n + 1;
  float* dl = static_cast<float*>(dlogit);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_GATB(T, V)                                                                  \
  launch_gat_backward<T, V>(lg, msg, out, grad, m_in, z_in, sg, E, rp, un, n, H, dh, tpr, \
                            dmsg, dl, s)
  if (dtype == kF32) {
    switch (vec) {
      case 4: return REPRO_GATB(float, 4);
      case 2: return REPRO_GATB(float, 2);
      case 1: return REPRO_GATB(float, 1);
    }
  } else if (dtype == kBF16) {
    switch (vec) {
      case 8: return REPRO_GATB(__nv_bfloat16, 8);
      case 4: return REPRO_GATB(__nv_bfloat16, 4);
      case 2: return REPRO_GATB(__nv_bfloat16, 2);
      case 1: return REPRO_GATB(__nv_bfloat16, 1);
    }
  }
#undef REPRO_GATB
  return static_cast<int>(cudaErrorInvalidValue);
}
