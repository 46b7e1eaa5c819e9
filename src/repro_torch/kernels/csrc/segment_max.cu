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
// What bounds it on this card: bytes. It reads 4 bytes of id and 2-4 of
// value per edge and writes one value per segment, with no arithmetic to
// speak of (1.05 M edges, 150,000 segments: 9 MB, 0.0027 ms at 3.35 TB/s).
//
// Design. Each float maps to an unsigned 32-bit key whose integer order is
// the float order (negative floats: all bits flipped; others: sign bit
// set), with every NaN mapped to the largest key. One thread per edge does
// an integer atomicMax of its key into a [n] buffer that a memset zeroed
// (0 lies below the key of -inf, so it marks an untouched segment); a
// second pass decodes each key, gives 0.0 where the segment is empty or its
// max is NaN or +-inf, and casts to x's dtype. An integer max gives the
// same bits in any order, so these atomics keep the project's rule of no
// float atomics (two runs, and a row alone or in a batch, give the same
// bits). Under this order -0.0 lies below +0.0. No host read between the
// passes; the ids need no sort (a sort + CSR pass would cost more than the
// whole bound).
#include "common.cuh"

namespace repro_torch {

__device__ __forceinline__ unsigned int order_key(float v) {
  const unsigned int u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;  // NaN, either sign
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The inverse of order_key; key 0 (untouched) decodes to a NaN.
__device__ __forceinline__ float from_key(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ float load_f(const float* __restrict__ p, int e) { return p[e]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* __restrict__ p, int e) {
  return __bfloat162float(p[e]);
}

__device__ __forceinline__ void store_f(float* __restrict__ p, int s, float v) { p[s] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* __restrict__ p, int s, float v) {
  p[s] = __float2bfloat16_rn(v);  // exact: v is one of the bf16 inputs, or 0
}

template <typename T>
__global__ void segment_max_scatter_kernel(const T* __restrict__ x, const int* __restrict__ seg,
                                           int E, int n, unsigned int* __restrict__ keys) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const int s = seg[e];
  if (s < 0 || s >= n) return;
  atomicMax(keys + s, order_key(load_f(x, e)));
}

template <typename T>
__global__ void segment_max_decode_kernel(const unsigned int* __restrict__ keys, int n,
                                          T* __restrict__ out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const float v = from_key(keys[s]);
  const bool finite = (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u;
  store_f(out, s, finite ? v : 0.f);
}

template <typename T>
static int launch_max(const void* x, const int* seg, int E, int n, unsigned int* keys,
                      void* out, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(keys, 0, sizeof(unsigned int) * static_cast<size_t>(n),
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (E > 0) {
    segment_max_scatter_kernel<T><<<(E - 1) / kThreads + 1, kThreads, 0, stream>>>(
        static_cast<const T*>(x), seg, E, n, keys);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  segment_max_decode_kernel<T><<<(n - 1) / kThreads + 1, kThreads, 0, stream>>>(
      keys, n, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

using namespace repro_torch;

// x [E] (dtype: 0 float32, 1 bfloat16), seg [E] int32 in any order, keys
// [n] 32-bit scratch, out [n] (dtype). Returns cudaGetLastError() after the
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
