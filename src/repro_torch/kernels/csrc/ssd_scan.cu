// Mamba-2 SSD scan for Hopper (sm_90a): y and the final state of
//
//   state_s = exp(a_s) * state_{s-1} + dt_s * x_s (x) B_s     [P, N] per head
//   y_s     = state_s . C_s
//
// from an optional initial state, for every (batch, head) in one launch.
//
// Replaces `repro/kernels/ssd_scan.py::ssd_scan_pallas` (:65, `pallas_call`
// at :87), and serves as the port's `ssd_chunked_jnp`
// (`repro/models/transformer/ssm.py:33`): the same function, which the
// Mamba-2 prefill runs with the cache's state as the initial state.
//
// What bounds it on this card: the time steps run in order, so a head is
// one chain of S dependent updates of its [P, N] state (64 x 128 at
// mamba2-130m). Its bytes (x, B, C, a, dt, y and the states once, about
// 62 MB at 4 x 2048 steps x 24 heads) would take 19 us at 3.35 TB/s; the
// chain of steps, each some hundred instructions per warp, takes far
// longer. Latency of the step chain, not bytes or flops, bounds this design.
//
// Design. The TPU grid walks chunks in order and carries the state in a
// revisited output block; here one block of 8 warps per (batch, head)
// walks the whole sequence and keeps the state in registers: warp w owns
// rows p in [w * P/8, (w+1) * P/8) and lane l the columns n = l + 32 k, so
// each thread holds P * N / 256 floats (32 at mamba2-130m) and no step
// needs shared memory for the state or a block-wide barrier. The inputs
// of 64 steps at a time are staged in shared memory as float32 by
// coalesced loads; each step then updates the state and sums y over n
// with a fixed butterfly of warp shuffles (no atomics: the same bits on
// every run). B and C are read in group form, head h reading group
// h / (H / G), without a repeat. The chunked form of the TPU kernel (L x L
// products per chunk) does about twice this recurrence's flops and pays
// only on the tensor cores; that, and more than B * H blocks (96 on 132
// SMs at the smoke's shape), is later work. A ragged tail needs no
// padding: the loop stops at S.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kSteps = 64;     // time steps staged at once

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// RPW state rows per warp (P = 8 RPW), NPL state columns per lane (N = 32 NPL)
template <typename T, int RPW, int NPL>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, long long x_sb, long long x_ss,
                    const float* __restrict__ a, const float* __restrict__ dt,
                    const T* __restrict__ bm, long long b_sb, long long b_ss,
                    const T* __restrict__ cm, long long c_sb, long long c_ss,
                    const float* __restrict__ init, T* __restrict__ y,
                    float* __restrict__ final_state, int S, int H, int G) {
  constexpr int P = 8 * RPW;
  constexpr int N = 32 * NPL;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;              // [kSteps][P]
  float* bs = xs + kSteps * P;   // [kSteps][N]
  float* cs = bs + kSteps * N;   // [kSteps][N]
  float* as = cs + kSteps * N;   // [kSteps]
  float* ds = as + kSteps;       // [kSteps]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int grp = h / (H / G);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p0 = warp * RPW;

  const long long st_off = (static_cast<long long>(b) * H + h) * P * N;
  float st[RPW][NPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int k = 0; k < NPL; ++k)
      st[r][k] = init ? init[st_off + (p0 + r) * N + lane + 32 * k] : 0.f;

  const T* xb = x + b * x_sb + static_cast<long long>(h) * P;
  const T* bb = bm + b * b_sb + static_cast<long long>(grp) * N;
  const T* cb = cm + b * c_sb + static_cast<long long>(grp) * N;
  const long long hs = static_cast<long long>(b) * S * H + h;  // (b, 0, h) of [B, S, H]
  T* yb = y + hs * P;

  for (int s0 = 0; s0 < S; s0 += kSteps) {
    const int cnt = min(kSteps, S - s0);
    __syncthreads();  // the previous steps' inputs are no longer read
    for (int i = threadIdx.x; i < cnt * P; i += kThreads) {
      const int s = i / P, p = i % P;
      xs[s * P + p] = to_f(xb[(s0 + s) * x_ss + p]);
    }
    for (int i = threadIdx.x; i < cnt * N; i += kThreads) {
      const int s = i / N, n = i % N;
      bs[s * N + n] = to_f(bb[(s0 + s) * b_ss + n]);
      cs[s * N + n] = to_f(cb[(s0 + s) * c_ss + n]);
    }
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
      as[i] = a[hs + static_cast<long long>(s0 + i) * H];
      ds[i] = dt[hs + static_cast<long long>(s0 + i) * H];
    }
    __syncthreads();

    for (int s = 0; s < cnt; ++s) {
      const float dec = expf(as[s]);
      const float dts = ds[s];
      float bn[NPL], cn[NPL];
#pragma unroll
      for (int k = 0; k < NPL; ++k) {
        bn[k] = bs[s * N + lane + 32 * k];
        cn[k] = cs[s * N + lane + 32 * k];
      }
      float yv[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float xv = dts * xs[s * P + p0 + r];
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < NPL; ++k) {
          st[r][k] = st[r][k] * dec + xv * bn[k];
          acc += st[r][k] * cn[k];
        }
        yv[r] = acc;
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int off = 16; off > 0; off /= 2) yv[r] += __shfl_xor_sync(0xffffffffu, yv[r], off);
      if (lane < RPW) {
        float mine = yv[0];
#pragma unroll
        for (int r = 1; r < RPW; ++r)
          if (lane == r) mine = yv[r];
        yb[static_cast<long long>(s0 + s) * H * P + p0 + lane] = from_f<T>(mine);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int k = 0; k < NPL; ++k) final_state[st_off + (p0 + r) * N + lane + 32 * k] = st[r][k];
}

struct Args {
  const void* x;
  long long x_sb, x_ss;
  const float* a;
  const float* dt;
  const void* bm;
  long long b_sb, b_ss;
  const void* cm;
  long long c_sb, c_ss;
  const float* init;
  void* y;
  float* final_state;
  int B, S, H, G;
};

template <typename T, int RPW, int NPL>
int launch(const Args& r, cudaStream_t stream) {
  constexpr int P = 8 * RPW;
  constexpr int N = 32 * NPL;
  const size_t smem = sizeof(float) * (static_cast<size_t>(kSteps) * (P + 2 * N) + 2 * kSteps);
  // once per device: a launch inside a CUDA-graph capture then only enqueues
  static unsigned attr_set = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32 || !(attr_set & (1u << dev))) {
    err = cudaFuncSetAttribute(ssd_scan_kernel<T, RPW, NPL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 32) attr_set |= 1u << dev;
  }
  ssd_scan_kernel<T, RPW, NPL><<<r.B * r.H, kThreads, smem, stream>>>(
      static_cast<const T*>(r.x), r.x_sb, r.x_ss, r.a, r.dt, static_cast<const T*>(r.bm), r.b_sb,
      r.b_ss, static_cast<const T*>(r.cm), r.c_sb, r.c_ss, r.init, static_cast<T*>(r.y),
      r.final_state, r.S, r.H, r.G);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int RPW>
int dispatch_n(int N, const Args& r, cudaStream_t s) {
  switch (N) {
    case 32: return launch<T, RPW, 1>(r, s);
    case 64: return launch<T, RPW, 2>(r, s);
    case 128: return launch<T, RPW, 4>(r, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_p(int P, int N, const Args& r, cudaStream_t s) {
  switch (P) {
    case 16: return dispatch_n<T, 2>(N, r, s);
    case 32: return dispatch_n<T, 4>(N, r, s);
    case 64: return dispatch_n<T, 8>(N, r, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x [B, S, H, P] with P contiguous, heads P apart, steps x_ss and batches
// x_sb elements apart; a = dt * A and dt [B, S, H] float32 contiguous;
// B and C [B, S, G, N] with N contiguous, groups N apart, steps b_ss / c_ss
// and batches b_sb / c_sb apart; init [B, H, P, N] float32 or null (zeros);
// y [B, S, H, P] contiguous in x's dtype (0 float32, 1 bfloat16);
// final_state [B, H, P, N] float32. P in {16, 32, 64}, N in {32, 64, 128},
// G divides H. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape or dtype it does not take).
extern "C" int ssd_scan(const void* x, long long x_sb, long long x_ss, const float* a,
                        const float* dt, const void* bm, long long b_sb, long long b_ss,
                        const void* cm, long long c_sb, long long c_ss, const float* init,
                        void* y, float* final_state, int B, int S, int H, int G, int P, int N,
                        int dtype, void* stream) {
  if (B == 0 || H == 0) return 0;
  const Args r{x, x_sb, x_ss, a, dt, bm, b_sb, b_ss, cm, c_sb, c_ss, init, y, final_state,
               B, S, H, G};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_p<float>(P, N, r, s);
  if (dtype == 1) return dispatch_p<__nv_bfloat16>(P, N, r, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
