// Flash attention backward for Hopper (sm_90a): dQ, dK and dV of the
// forward in flash_attention.cu (causal / sliding-window / kv_offset masks,
// grouped KV heads, every (DQK, DV) width of the forward), from q, k, v,
// the float32 output o, its gradient dO and the forward's per-row
// log-sum-exp.
//
// The TPU kernel it pairs with, `repro/kernels/flash_attention.py::
// flash_attention_pallas` (:91), has no backward: the JAX package trains
// through the plain jnp attention (`use_kernel=False`) and lets autodiff
// differentiate it. This kernel computes the gradients of the same
// function, the plain version's `ref.attention_ref`, whose autograd is its
// twin in the tests; `ref.attention_backward_bf16_ref` repeats the bf16
// route's roundings in plain PyTorch.
//
// With s_ij = q_i . k_j / sqrt(DQK) masked as the forward masks it,
// P_ij = exp(s_ij - lse_i) (0 where masked), D_i = dO_i . o_i:
//
//   dV_j = sum_i P_ij dO_i          dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - D_i)      dQ_i = sum_j dS_ij k_j / sqrt(DQK)
//   dK_j = sum_i dS_ij q_i / sqrt(DQK)
//
// summed over the query heads that share a KV head for dK and dV. o is
// float32 on both routes: the training forward writes its unrounded output
// for it (bf16: `acc / l` before rounding), since D from a rounded o is off
// by an error that dQ_i = sum_j dS_ij k_j carries coherently over a whole
// row (PERF.md). Four kernels in stream order, no atomics, every sum in a
// fixed order, so two runs give the same bits:
//
//   1. flash_bwd_kernel_delta: D_i in float32, one warp per (row, head).
//   2. dK and dV: one block per (KV tile, query head, batch) walks the
//      query tiles that its masks leave anything in, in order, recomputes
//      S and dP, and accumulates dV and dK of its keys in registers;
//      writes them, unscaled by the group sum, to float32 scratch
//      [B, H, Skv, D].
//   3. dQ: one block per (query tile, head, batch) walks its KV tiles in
//      order, recomputes S, dP and dS, and accumulates dQ in registers.
//   4. flash_bwd_kernel_group_sum: dK and dV of each KV head, the sum of
//      the scratch over the query heads of its group in head order,
//      rounded once to the input dtype.
//
// Kernel 2 holds one query head per block (not the whole group) so that
// MQA (8 or 10 query heads over one KV head) still gives B x H x Skv / 64
// blocks; kernel 4's fixed-order sum replaces the atomics a shared dK
// would need. Kernels 2 and 3 both recompute S and dP: the price of
// writing every gradient once, in a fixed order.
//
// Route: a static choice by dtype, as the forward's; not a fallback.
//
// * bfloat16, every (DQK, DV): tc::flash_bwd_kernel_mma_dkv and
//   tc::flash_bwd_kernel_mma_dq, every product on the tensor cores as
//   `mma.sync.m16n8k16` (bf16 in, float32 accumulators), operands read
//   from shared memory with `ldmatrix` (`.trans` for the MN-major B of the
//   accumulating products) from rows padded by 16 bytes, which keeps them
//   free of bank conflicts. Tiles of 64 queries x 64 keys, 8 warps:
//     - S = Q K^T and dP = dO V^T (kernel 2 forms S^T = K Q^T and dP^T, so
//       its rows are keys), both operands K-major; each warp 16 rows x 32
//       columns of the tile. P and dS are formed in the accumulators and
//       stored to shared memory as bf16 A operands.
//     - dV += P^T dO (P rounded to bf16), dK += dS^T Q and dQ += dS K (dS
//       as a bf16 high part plus the bf16 of the remainder, two products:
//       dS rounded once put dq and dk at 1.7-1.8x the plain version's
//       error from the float32 run in `ref.attention_backward_bf16_ref`,
//       against the gate of 2x; split, 1.0x). Each warp 16 rows x half of
//       the head width, so a thread holds at most 2 x 64 float32
//       accumulators at D 256 (the alternative, a warp's 16 keys across
//       the whole width, needs 256 and spills).
//     - Kernel 2 keeps K and V, kernel 3 Q and dO, for the whole block;
//       the other pair streams through two stages by 16-byte `cp.async`,
//       the next tile's loads in flight while this one computes. Rows past
//       Sq or Skv are zero in shared memory and masked.
//     - Blocks are ordered heaviest first under a causal mask (kernel 2:
//       the first keys, which the most queries see; kernel 3: the last
//       queries).
//   `mma.sync` and not `wgmma`: both accumulating products take a
//   transposed operand and a tile cut at the causal diagonal; the 16-row
//   warp tiles follow both with `ldmatrix(.trans)` and no swizzled layout.
//   The wgmma form is a later redesign's (PERF.md).
// * float32: the scalar kernels flash_bwd_kernel_dkv and _dq, float32
//   FMAs on the CUDA cores, operands in shared memory, each thread a 2 x 4
//   tile of S and dP and a 4-row (dK, dV) or 8-row (dQ) strip of
//   accumulators; tiles of 64 queries x 32 keys. No TF32: the float32
//   sweeps hold it at 1e-4.
//
// What bounds it on this card: operations. At the gemma-2b training step
// (B 2, S 2048, H 8 over one KV head, D 256) the causal backward is 2.5
// times the forward's 34.4 GFLOP at the least (`chip_smoke.py`'s bound),
// against 42 MB of q, k, v, o, dO and the three gradients: about 2,000
// flops a byte. The bf16 route runs 4.5 forward-equivalents of products
// (S and dP twice, dV once, dK and dQ split in two).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per tile
constexpr int kBK = 32;       // keys per tile
constexpr int kThreads = 256;
constexpr int kLdP = kBK + 4;  // P and dS rows [kBQ][kLdP] float32
constexpr int kLdT = kBQ + 4;  // dS transposed [kBK][kLdT] float32 (kernel 3)

template <typename T>
struct Pad {
  static constexpr int k = 16 / sizeof(T);  // keeps rows 16-byte aligned, spreads banks
};

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

// C consecutive elements of type T at p (aligned to C * sizeof(T) where
// that is 4, 8 or 16 bytes) as floats: vector loads where the width allows
template <typename T, int C>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[C]) {
  constexpr int kBytes = C * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[c];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i)
        out[c * (16 / sizeof(T)) + i] = to_f(e[i]);
    }
  } else if constexpr (kBytes % 8 == 0) {
#pragma unroll
    for (int c = 0; c < kBytes / 8; ++c) {
      const uint2 u = reinterpret_cast<const uint2*>(p)[c];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < 8 / static_cast<int>(sizeof(T)); ++i)
        out[c * (8 / sizeof(T)) + i] = to_f(e[i]);
    }
  } else if constexpr (kBytes % 4 == 0) {
#pragma unroll
    for (int c = 0; c < kBytes / 4; ++c) {
      const uint32_t u = reinterpret_cast<const uint32_t*>(p)[c];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < 4 / static_cast<int>(sizeof(T)); ++i)
        out[c * (4 / sizeof(T)) + i] = to_f(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i) out[i] = to_f(p[i]);
  }
}

// rows [0, valid) of a head's [rows, D] slice (consecutive rows `stride`
// elements apart) into a [rows_tile, ld] shared tile; rows past `valid`
// are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* __restrict__ dst, int ld, int rows_tile,
                                          const T* __restrict__ src, long stride, int valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  static_assert(D % kVec == 0, "head width");
  for (int i = threadIdx.x; i < rows_tile * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) v = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

// The geometry both main kernels share.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* o;  // float32 on both routes
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  float* dk_part;  // [B, H, Skv, DQK]
  float* dv_part;  // [B, H, Skv, DV]
  void* dk;
  void* dv;
  int B, Sq, Skv, H, Hkv, causal, window, kv_offset;
  float scale;
};

__device__ __forceinline__ bool keep(int i, int j, int qp, const Args& a) {
  bool ok = i < a.Sq && j < a.Skv;
  if (a.causal) ok = ok && j <= qp;
  if (a.window > 0) ok = ok && j > qp - a.window;
  return ok;
}

// This thread's 2 x 4 tile of S and dP for query rows q0 + ri, ri + 1 and
// keys k0 + cj + 8 c (c < 4), from Q, dO, K and V tiles in shared memory;
// P and dS written into ps and ds ([kBQ][kLdP], row-major by query) or,
// with `transposed`, dS into ds as [kBK][kLdT].
template <typename T, int DQK, int DV>
__device__ __forceinline__ void scores(const T* qs, const T* dos, const T* ks, const T* vs,
                                       const float* lse_s, const float* delta_s, float* ps,
                                       float* ds, bool transposed, int q0, int k0,
                                       const Args& a) {
  constexpr int kLdQ = DQK + Pad<T>::k;
  constexpr int kLdV = DV + Pad<T>::k;
  constexpr int kVec = 16 / sizeof(T);
  const int ri = (threadIdx.x / 8) * 2;
  const int cj = threadIdx.x % 8;
  float s[2][4] = {}, dp[2][4] = {};
#pragma unroll 2
  for (int d = 0; d < DQK; d += kVec) {
    float qv[2][kVec], kv[4][kVec];
    load_vec<T, kVec>(qs + ri * kLdQ + d, qv[0]);
    load_vec<T, kVec>(qs + (ri + 1) * kLdQ + d, qv[1]);
#pragma unroll
    for (int c = 0; c < 4; ++c) load_vec<T, kVec>(ks + (cj + 8 * c) * kLdQ + d, kv[c]);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < kVec; ++e) s[r][c] = fmaf(qv[r][e], kv[c][e], s[r][c]);
  }
#pragma unroll 2
  for (int d = 0; d < DV; d += kVec) {
    float ov[2][kVec], vv[4][kVec];
    load_vec<T, kVec>(dos + ri * kLdV + d, ov[0]);
    load_vec<T, kVec>(dos + (ri + 1) * kLdV + d, ov[1]);
#pragma unroll
    for (int c = 0; c < 4; ++c) load_vec<T, kVec>(vs + (cj + 8 * c) * kLdV + d, vv[c]);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < kVec; ++e) dp[r][c] = fmaf(ov[r][e], vv[c][e], dp[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + ri + r;
    const int qp = a.kv_offset + i;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int jj = cj + 8 * c;
      const float p =
          keep(i, k0 + jj, qp, a) ? expf(s[r][c] * a.scale - lse_s[ri + r]) : 0.f;
      const float g = p * (dp[r][c] - delta_s[ri + r]);
      if (transposed) {
        ds[jj * kLdT + ri + r] = g;
      } else {
        ps[(ri + r) * kLdP + jj] = p;
        ds[(ri + r) * kLdP + jj] = g;
      }
    }
  }
}

// 1. D_i = dO_i . o_i in float32 (o float32), one warp per (batch, row, head); written
// as delta [B, H, Sq]
template <typename T, int DV>
__global__ void __launch_bounds__(kThreads) flash_bwd_kernel_delta(Args a) {
  const long row = static_cast<long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long>(a.B) * a.Sq * a.H) return;
  const float* o = a.o + row * DV;
  const T* g = static_cast<const T*>(a.dout) + row * DV;
  float acc = 0.f;
  for (int e = lane; e < DV; e += 32) acc = fmaf(o[e], to_f(g[e]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % a.H);
    const long bi = row / a.H;  // b * Sq + i
    const int i = static_cast<int>(bi % a.Sq);
    const int b = static_cast<int>(bi / a.Sq);
    a.delta[(static_cast<long>(b) * a.H + h) * a.Sq + i] = acc;
  }
}

// shared memory of kernels 2 and 3: Q and dO [kBQ], K and V [kBK] in T,
// then lse and D [kBQ], then P and dS (kernel 2) or dS^T (kernel 3)
template <typename T, int DQK, int DV>
struct Smem {
  static constexpr int kLdQ = DQK + Pad<T>::k;
  static constexpr int kLdV = DV + Pad<T>::k;
  static constexpr size_t kQ = sizeof(T) * kBQ * kLdQ;
  static constexpr size_t kDO = sizeof(T) * kBQ * kLdV;
  static constexpr size_t kK = sizeof(T) * kBK * kLdQ;
  static constexpr size_t kV = sizeof(T) * kBK * kLdV;
  static constexpr size_t kRows = sizeof(float) * 2 * kBQ;
  static constexpr size_t kP = sizeof(float) * kBQ * kLdP;
  static constexpr size_t kBytes = kQ + kDO + kK + kV + kRows + 2 * kP;
  static_assert(kQ % 16 == 0 && kDO % 16 == 0 && kK % 16 == 0 && kV % 16 == 0, "alignment");
  static_assert(sizeof(float) * kBK * kLdT <= 2 * kP, "dS^T fits P and dS");
  static_assert(kBytes <= 232448, "shared memory");
};

// 2. dK and dV of one KV tile for one query head, into float32 scratch
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads) flash_bwd_kernel_dkv(Args a) {
  using M = Smem<T, DQK, DV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = reinterpret_cast<T*>(smem_raw + M::kQ);
  T* ks = reinterpret_cast<T*>(smem_raw + M::kQ + M::kDO);
  T* vs = reinterpret_cast<T*>(smem_raw + M::kQ + M::kDO + M::kK);
  float* lse_s = reinterpret_cast<float*>(smem_raw + M::kQ + M::kDO + M::kK + M::kV);
  float* delta_s = lse_s + kBQ;
  float* ps = lse_s + 2 * kBQ;
  float* ds = ps + kBQ * kLdP;

  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const long q_stride = static_cast<long>(a.H) * DQK;
  const long o_stride = static_cast<long>(a.H) * DV;
  const long k_stride = static_cast<long>(a.Hkv) * DQK;
  const long v_stride = static_cast<long>(a.Hkv) * DV;
  const T* qb = static_cast<const T*>(a.q) + static_cast<long>(b) * a.Sq * q_stride +
                static_cast<long>(h) * DQK;
  const T* dob = static_cast<const T*>(a.dout) + static_cast<long>(b) * a.Sq * o_stride +
                 static_cast<long>(h) * DV;
  const float* lse_b = a.lse + (static_cast<long>(b) * a.H + h) * a.Sq;
  const float* delta_b = a.delta + (static_cast<long>(b) * a.H + h) * a.Sq;
  const int k_valid = min(kBK, a.Skv - k0);
  load_tile<T, DQK>(ks, M::kLdQ, kBK,
                    static_cast<const T*>(a.k) + (static_cast<long>(b) * a.Skv + k0) * k_stride +
                        static_cast<long>(hk) * DQK,
                    k_stride, k_valid);
  load_tile<T, DV>(vs, M::kLdV, kBK,
                   static_cast<const T*>(a.v) + (static_cast<long>(b) * a.Skv + k0) * v_stride +
                       static_cast<long>(hk) * DV,
                   v_stride, k_valid);

  // the query rows whose masks keep any key of this tile
  const int i_lo = a.causal ? max(0, k0 - a.kv_offset) : 0;
  const int i_hi = a.window > 0 ? min(a.Sq, k0 + kBK - 1 + a.window - a.kv_offset) : a.Sq;

  // this thread's accumulators: keys 4 w .. 4 w + 3 (w its warp), columns
  // lane * C .. of dV (C = DV / 32) and of dK (DQK / 32)
  constexpr int CV = DV / 32;
  constexpr int CK = DQK / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc_v[4][CV] = {}, acc_k[4][CK] = {};
  for (int q0 = (max(i_lo, 0) / kBQ) * kBQ; q0 < i_hi; q0 += kBQ) {
    __syncthreads();  // the last tile's Q, dO, P and dS are no longer read
    const int q_valid = min(kBQ, a.Sq - q0);
    load_tile<T, DQK>(qs, M::kLdQ, kBQ, qb + q0 * q_stride, q_stride, q_valid);
    load_tile<T, DV>(dos, M::kLdV, kBQ, dob + q0 * o_stride, o_stride, q_valid);
    if (threadIdx.x < kBQ) {
      const bool in = threadIdx.x < q_valid;
      lse_s[threadIdx.x] = in ? lse_b[q0 + threadIdx.x] : 0.f;
      delta_s[threadIdx.x] = in ? delta_b[q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    scores<T, DQK, DV>(qs, dos, ks, vs, lse_s, delta_s, ps, ds, false, q0, k0, a);
    __syncthreads();
    for (int i = 0; i < q_valid; ++i) {
      const float4 p4 = *reinterpret_cast<const float4*>(ps + i * kLdP + 4 * warp);
      const float4 d4 = *reinterpret_cast<const float4*>(ds + i * kLdP + 4 * warp);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
      const float dr[4] = {d4.x, d4.y, d4.z, d4.w};
      float ov[CV], qv[CK];
      load_vec<T, CV>(dos + i * M::kLdV + lane * CV, ov);
      load_vec<T, CK>(qs + i * M::kLdQ + lane * CK, qv);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < CV; ++c) acc_v[r][c] = fmaf(pr[r], ov[c], acc_v[r][c]);
#pragma unroll
        for (int c = 0; c < CK; ++c) acc_k[r][c] = fmaf(dr[r], qv[c], acc_k[r][c]);
      }
    }
  }
  // rows past Skv are not written; a tile no query sees writes zeros
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + 4 * warp + r;
    if (j >= a.Skv) continue;
    const long row = (static_cast<long>(b) * a.H + h) * a.Skv + j;
    float* dkp = a.dk_part + row * DQK + lane * CK;
    float* dvp = a.dv_part + row * DV + lane * CV;
#pragma unroll
    for (int c = 0; c < CK; ++c) dkp[c] = acc_k[r][c] * a.scale;
#pragma unroll
    for (int c = 0; c < CV; ++c) dvp[c] = acc_v[r][c];
  }
}

// 3. dQ of one query tile
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads) flash_bwd_kernel_dq(Args a) {
  using M = Smem<T, DQK, DV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = reinterpret_cast<T*>(smem_raw + M::kQ);
  T* ks = reinterpret_cast<T*>(smem_raw + M::kQ + M::kDO);
  T* vs = reinterpret_cast<T*>(smem_raw + M::kQ + M::kDO + M::kK);
  float* lse_s = reinterpret_cast<float*>(smem_raw + M::kQ + M::kDO + M::kK + M::kV);
  float* delta_s = lse_s + kBQ;
  float* dst = lse_s + 2 * kBQ;  // dS^T [kBK][kLdT]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const long q_stride = static_cast<long>(a.H) * DQK;
  const long o_stride = static_cast<long>(a.H) * DV;
  const long k_stride = static_cast<long>(a.Hkv) * DQK;
  const long v_stride = static_cast<long>(a.Hkv) * DV;
  const int q_valid = min(kBQ, a.Sq - q0);
  load_tile<T, DQK>(qs, M::kLdQ, kBQ,
                    static_cast<const T*>(a.q) + (static_cast<long>(b) * a.Sq + q0) * q_stride +
                        static_cast<long>(h) * DQK,
                    q_stride, q_valid);
  load_tile<T, DV>(dos, M::kLdV, kBQ,
                   static_cast<const T*>(a.dout) + (static_cast<long>(b) * a.Sq + q0) * o_stride +
                       static_cast<long>(h) * DV,
                   o_stride, q_valid);
  if (threadIdx.x < kBQ) {
    const bool in = threadIdx.x < q_valid;
    const long at = (static_cast<long>(b) * a.H + h) * a.Sq + q0 + threadIdx.x;
    lse_s[threadIdx.x] = in ? a.lse[at] : 0.f;
    delta_s[threadIdx.x] = in ? a.delta[at] : 0.f;
  }
  const T* kb = static_cast<const T*>(a.k) + static_cast<long>(b) * a.Skv * k_stride +
                static_cast<long>(hk) * DQK;
  const T* vb = static_cast<const T*>(a.v) + static_cast<long>(b) * a.Skv * v_stride +
                static_cast<long>(hk) * DV;

  // the keys any query of this tile may see, as the forward visits them
  const int qp_first = a.kv_offset + q0;
  const int qp_last = qp_first + q_valid - 1;
  const int k_lo = a.window > 0 ? max(0, qp_first - a.window + 1) : 0;
  const int k_hi = a.causal ? min(a.Skv, qp_last + 1) : a.Skv;

  // this thread's accumulators: rows 8 w .. 8 w + 7, columns lane * CK ..
  constexpr int CK = DQK / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[8][CK] = {};
  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the last tile's K, V and dS are no longer read
    const int k_valid = min(kBK, a.Skv - k0);
    load_tile<T, DQK>(ks, M::kLdQ, kBK, kb + k0 * k_stride, k_stride, k_valid);
    load_tile<T, DV>(vs, M::kLdV, kBK, vb + k0 * v_stride, v_stride, k_valid);
    __syncthreads();
    scores<T, DQK, DV>(qs, dos, ks, vs, lse_s, delta_s, nullptr, dst, true, q0, k0, a);
    __syncthreads();
    for (int j = 0; j < k_valid; ++j) {
      const float4 d0 = *reinterpret_cast<const float4*>(dst + j * kLdT + 8 * warp);
      const float4 d1 = *reinterpret_cast<const float4*>(dst + j * kLdT + 8 * warp + 4);
      const float dr[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      float kv[CK];
      load_vec<T, CK>(ks + j * M::kLdQ + lane * CK, kv);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < CK; ++c) acc[r][c] = fmaf(dr[r], kv[c], acc[r][c]);
    }
  }
  T* dqb = static_cast<T*>(a.dq) + (static_cast<long>(b) * a.Sq + q0) * q_stride +
           static_cast<long>(h) * DQK;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = 8 * warp + r;
    if (i >= q_valid) continue;
    T* row = dqb + i * q_stride + lane * CK;
#pragma unroll
    for (int c = 0; c < CK; ++c) row[c] = from_f<T>(acc[r][c] * a.scale);
  }
}

// 4. dK and dV [B, Skv, Hkv, D] in T: the scratch summed over each KV
// head's query heads in head order
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kernel_group_sum(const float* __restrict__ part, T* __restrict__ out, int B,
                               int Skv, int H, int Hkv) {
  const long n = static_cast<long>(B) * Skv * Hkv * D;
  const int group = H / Hkv;
  for (long idx = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x; idx < n;
       idx += static_cast<long>(gridDim.x) * kThreads) {
    const int d = static_cast<int>(idx % D);
    const long rest = idx / D;
    const int hk = static_cast<int>(rest % Hkv);
    const long bj = rest / Hkv;  // b * Skv + j
    const int j = static_cast<int>(bj % Skv);
    const int b = static_cast<int>(bj / Skv);
    float acc = 0.f;
    for (int g = 0; g < group; ++g)
      acc += part[((static_cast<long>(b) * H + hk * group + g) * Skv + j) * D + d];
    out[idx] = from_f<T>(acc);
  }
}

// ---------------------------------------------------------------------------
// The bf16 route: kernels 2 and 3 on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kB = 64;           // query rows and keys per tile
constexpr int kThreads = 256;    // 8 warps
constexpr int kPad = 8;          // bf16 after each shared-memory row: 16 bytes
constexpr int kLdS = kB + kPad;  // the P and dS tiles, [kB][kLdS]
constexpr int kStages = 2;       // tiles of the streamed pair in shared memory
// dS enters its products as a bf16 high part plus the bf16 of the
// remainder; P is rounded once (ref.FLASH_BWD_SPLIT_DS / _P mirror these)
constexpr bool kSplitDS = true;

using namespace repro_torch::mma;

// rows [0, valid) of a [kB, W] slice (rows `stride` elements apart) into a
// [kB][W + kPad] shared tile by 16-byte cp.async (the caller commits and
// waits); rows past valid are zero
template <int W>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long stride, int valid) {
  constexpr int kRow = W / 8;
  static_assert(W % 16 == 0, "head width");
  for (int i = threadIdx.x; i < kB * kRow; i += kThreads) {
    const int r = i / kRow, c = (i % kRow) * 8;
    bf16* d = dst + r * (W + kPad) + c;
    if (r < valid)
      cp_async16(d, src + r * stride + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// acc[n][e] = this warp's 16 x 32 part of A B^T: row r0 + g + 8 (e / 2),
// column c0 + 8 n + 2 t + e % 2; A and B [kB][W + kPad] tiles, K-major
template <int W>
__device__ __forceinline__ void scores(float (&acc)[4][4], const bf16* a, const bf16* b, int r0,
                                       int c0, int lane) {
  constexpr int ld = W + kPad;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const bf16* pa = a + (r0 + (lane & 15)) * ld + 8 * (lane >> 4);
  const bf16* pb = b + (c0 + (lane & 7) + 8 * (lane >> 4)) * ld + 8 * ((lane >> 3) & 1);
#pragma unroll 4
  for (int k0 = 0; k0 < W; k0 += 16) {
    uint32_t af[4], b0[4], b1[4];
    ldsm_x4(af, pa + k0);
    ldsm_x4(b0, pb + k0);
    ldsm_x4(b1, pb + 16 * ld + k0);
    mma_bf16(acc[0], af, b0[0], b0[1]);
    mma_bf16(acc[1], af, b0[2], b0[3]);
    mma_bf16(acc[2], af, b1[0], b1[1]);
    mma_bf16(acc[3], af, b1[2], b1[3]);
  }
}

// acc[n][e] += this warp's 16 x NC part of A B: row r0 + g + 8 (e / 2),
// column c0 + 8 n + 2 t + e % 2. A is a [kB][kLdS] tile over its 64
// columns (with kTwo, hi + lo: two products, hi first), B a [kB][W + kPad]
// tile stored K x N, read transposed.
template <int NC, int W, bool kTwo>
__device__ __forceinline__ void accumulate(float (&acc)[NC / 8][4], const bf16* hi,
                                           const bf16* lo, const bf16* b, int r0, int c0,
                                           int lane) {
  constexpr int ld = W + kPad;
  static_assert(NC % 16 == 0, "half a head width must be whole 16-column blocks");
  const int ao = (r0 + (lane & 15)) * kLdS + 8 * (lane >> 4);
  const bf16* pb = b + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + c0 + 8 * (lane >> 4);
#pragma unroll
  for (int k0 = 0; k0 < kB; k0 += 16) {
    uint32_t ah[4], al[4];
    ldsm_x4(ah, hi + ao + k0);
    if constexpr (kTwo) ldsm_x4(al, lo + ao + k0);
#pragma unroll
    for (int n = 0; n < NC / 16; ++n) {
      uint32_t bq[4];
      ldsm_x4_t(bq, pb + k0 * ld + 16 * n);
      mma_bf16(acc[2 * n], ah, bq[0], bq[1]);
      mma_bf16(acc[2 * n + 1], ah, bq[2], bq[3]);
      if constexpr (kTwo) {
        mma_bf16(acc[2 * n], al, bq[0], bq[1]);
        mma_bf16(acc[2 * n + 1], al, bq[2], bq[3]);
      }
    }
  }
}

// dS (and P) of this warp's 16 x 32 part into the shared tiles, rows
// r0 + g (+ 8), columns c0 + 8 n + 2 t (+ 1): P rounded, dS split
__device__ __forceinline__ void put_tiles(const float (&p)[4][4], const float (&ds)[4][4],
                                          bf16* ps, bf16* dsh, bf16* dsl, int r0, int c0,
                                          int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int at = (r0 + g + 8 * rr) * kLdS + c0 + 8 * n + 2 * t;
      if (ps != nullptr)
        *reinterpret_cast<uint32_t*>(ps + at) = pack_bf16(p[n][2 * rr], p[n][2 * rr + 1]);
      if constexpr (kSplitDS) {
        uint32_t hi, lo;
        split_bf16(ds[n][2 * rr], ds[n][2 * rr + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(dsh + at) = hi;
        *reinterpret_cast<uint32_t*>(dsl + at) = lo;
      } else {
        *reinterpret_cast<uint32_t*>(dsh + at) = pack_bf16(ds[n][2 * rr], ds[n][2 * rr + 1]);
      }
    }
  }
}

// the shared memory of kernels 2 and 3, in bytes
template <int DQK, int DV>
struct Smem {
  static constexpr int kLdQ = DQK + kPad;
  static constexpr int kLdV = DV + kPad;
  static constexpr size_t kQ = sizeof(bf16) * kB * kLdQ;  // a Q or K tile
  static constexpr size_t kV = sizeof(bf16) * kB * kLdV;  // a dO or V tile
  static constexpr size_t kS = sizeof(bf16) * kB * kLdS;  // a P or dS tile
  static constexpr size_t kRows = sizeof(float) * 2 * kB;  // lse and D of a tile's rows
  static constexpr size_t kStage2 = kQ + kV + kRows;  // kernel 2: Q, dO, lse, D
  // kernel 2: K, V; kStages x (Q, dO, lse, D); P, dS high, dS low
  static constexpr size_t kDkv = kQ + kV + kStages * kStage2 + 3 * kS;
  // kernel 3: Q, dO, lse, D; kStages x (K, V); dS high, dS low
  static constexpr size_t kDq = kQ + kV + kRows + kStages * (kQ + kV) + 2 * kS;
  static_assert(kQ % 16 == 0 && kV % 16 == 0 && kS % 16 == 0, "alignment");
  static_assert(kDkv <= 232448 && kDq <= 232448, "shared memory");
};

// 2. dK and dV of one KV tile for one query head, into float32 scratch.
// Block x: rank * (H B) + b H + h; rank r takes KV tile r (the first keys
// are the most seen under a causal mask: heaviest first).
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_kernel_mma_dkv(Args a) {
  using M = Smem<DQK, DV>;
  constexpr int NK = DQK / 2, NV = DV / 2;  // the columns of a warp's dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = reinterpret_cast<bf16*>(smem_raw + M::kQ);
  unsigned char* const stages = smem_raw + M::kQ + M::kV;
  bf16* ps = reinterpret_cast<bf16*>(stages + kStages * M::kStage2);
  bf16* dsh = ps + kB * kLdS;
  bf16* dsl = dsh + kB * kLdS;

  const int hb = blockIdx.x % (a.H * a.B);
  const int k0 = (blockIdx.x / (a.H * a.B)) * kB;
  const int h = hb % a.H, b = hb / a.H;
  const int hk = h / (a.H / a.Hkv);
  const long q_stride = static_cast<long>(a.H) * DQK;
  const long o_stride = static_cast<long>(a.H) * DV;
  const long k_stride = static_cast<long>(a.Hkv) * DQK;
  const long v_stride = static_cast<long>(a.Hkv) * DV;
  const bf16* qb = static_cast<const bf16*>(a.q) + static_cast<long>(b) * a.Sq * q_stride +
                   static_cast<long>(h) * DQK;
  const bf16* dob = static_cast<const bf16*>(a.dout) + static_cast<long>(b) * a.Sq * o_stride +
                    static_cast<long>(h) * DV;
  const float* lse_b = a.lse + (static_cast<long>(b) * a.H + h) * a.Sq;
  const float* delta_b = a.delta + (static_cast<long>(b) * a.H + h) * a.Sq;
  const int k_valid = min(kB, a.Skv - k0);
  stage_rows<DQK>(ks,
                  static_cast<const bf16*>(a.k) + (static_cast<long>(b) * a.Skv + k0) * k_stride +
                      static_cast<long>(hk) * DQK,
                  k_stride, k_valid);
  stage_rows<DV>(vs,
                 static_cast<const bf16*>(a.v) + (static_cast<long>(b) * a.Skv + k0) * v_stride +
                     static_cast<long>(hk) * DV,
                 v_stride, k_valid);

  // the query tiles whose masks keep any key of this tile
  const int i_lo = a.causal ? max(0, k0 - a.kv_offset) : 0;
  const int i_hi = a.window > 0 ? min(a.Sq, k0 + kB - 1 + a.window - a.kv_offset) : a.Sq;
  const int t_lo = i_lo / kB;
  const int t_hi = i_hi > 0 ? (i_hi + kB - 1) / kB : 0;
  const auto fetch = [&](int qt) {
    unsigned char* st = stages + ((qt - t_lo) % kStages) * M::kStage2;
    const int q0 = qt * kB;
    const int qv = min(kB, a.Sq - q0);
    stage_rows<DQK>(reinterpret_cast<bf16*>(st), qb + q0 * q_stride, q_stride, qv);
    stage_rows<DV>(reinterpret_cast<bf16*>(st + M::kQ), dob + q0 * o_stride, o_stride, qv);
    float* rows = reinterpret_cast<float*>(st + M::kQ + M::kV);
    if (threadIdx.x < kB) {
      const bool in = threadIdx.x < qv;
      rows[threadIdx.x] = in ? lse_b[q0 + threadIdx.x] : 0.f;
      rows[kB + threadIdx.x] = in ? delta_b[q0 + threadIdx.x] : 0.f;
    }
  };
  if (t_lo < t_hi) fetch(t_lo);
  cp_async_commit();  // K, V and the first query tile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * (warp % 4);  // this warp's keys: tile rows r0 .. r0 + 15
  const int c0 = 32 * (warp / 4);  // its query columns of S^T and dP^T
  const int half = warp / 4;       // its half of dK's and dV's columns
  float acc_k[NK / 8][4], acc_v[NV / 8][4];
#pragma unroll
  for (int n = 0; n < NK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < NV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_v[n][e] = 0.f;

  for (int qt = t_lo; qt < t_hi; ++qt) {
    if (qt + 1 < t_hi) fetch(qt + 1);  // into the stage the last tile freed
    cp_async_commit();
    cp_async_wait<1>();  // everything but the newest group: this tile has landed
    __syncthreads();
    const unsigned char* st = stages + ((qt - t_lo) % kStages) * M::kStage2;
    const bf16* qs = reinterpret_cast<const bf16*>(st);
    const bf16* dos = reinterpret_cast<const bf16*>(st + M::kQ);
    const float* rows = reinterpret_cast<const float*>(st + M::kQ + M::kV);
    const int q0 = qt * kB;
    float s[4][4], dp[4][4];
    scores<DQK>(s, ks, qs, r0, c0, lane);  // S^T: rows keys, columns queries
    scores<DV>(dp, vs, dos, r0, c0, lane);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = c0 + 8 * n + 2 * t + (e & 1);
        const int i = q0 + ii, j = k0 + r0 + g + 8 * (e >> 1);
        const float p = keep(i, j, a.kv_offset + i, a) ? __expf(s[n][e] * a.scale - rows[ii]) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - rows[kB + ii]);
      }
    }
    put_tiles(s, dp, ps, dsh, dsl, r0, c0, lane);
    __syncthreads();
    accumulate<NV, DV, false>(acc_v, ps, nullptr, dos, r0, half * NV, lane);
    accumulate<NK, DQK, kSplitDS>(acc_k, dsh, dsl, qs, r0, half * NK, lane);
    __syncthreads();  // this stage and the P and dS tiles are free again
  }
  cp_async_wait<0>();  // a block with no query tile still has K and V in flight

  // rows past Skv are not written; a tile no query sees writes zeros
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int j = k0 + r0 + g + 8 * rr;
    if (j >= a.Skv) continue;
    const long row = (static_cast<long>(b) * a.H + h) * a.Skv + j;
    float* dkp = a.dk_part + row * DQK + half * NK + 2 * t;
    float* dvp = a.dv_part + row * DV + half * NV + 2 * t;
#pragma unroll
    for (int n = 0; n < NK / 8; ++n)
      *reinterpret_cast<float2*>(dkp + 8 * n) =
          make_float2(acc_k[n][2 * rr] * a.scale, acc_k[n][2 * rr + 1] * a.scale);
#pragma unroll
    for (int n = 0; n < NV / 8; ++n)
      *reinterpret_cast<float2*>(dvp + 8 * n) = make_float2(acc_v[n][2 * rr], acc_v[n][2 * rr + 1]);
  }
}

// 3. dQ of one query tile. Block x: rank * (H B) + b H + h; under a causal
// mask rank r takes the r-th query tile from the end (heaviest first).
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_kernel_mma_dq(Args a) {
  using M = Smem<DQK, DV>;
  constexpr int NK = DQK / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = reinterpret_cast<bf16*>(smem_raw + M::kQ);
  float* rows = reinterpret_cast<float*>(smem_raw + M::kQ + M::kV);  // lse, then D
  unsigned char* const stages = smem_raw + M::kQ + M::kV + M::kRows;  // K, V per stage
  bf16* dsh = reinterpret_cast<bf16*>(stages + kStages * (M::kQ + M::kV));
  bf16* dsl = dsh + kB * kLdS;

  const int hb = blockIdx.x % (a.H * a.B);
  const int rank = blockIdx.x / (a.H * a.B);
  const int n_qt = (a.Sq + kB - 1) / kB;
  const int q0 = (a.causal ? n_qt - 1 - rank : rank) * kB;
  const int h = hb % a.H, b = hb / a.H;
  const int hk = h / (a.H / a.Hkv);
  const long q_stride = static_cast<long>(a.H) * DQK;
  const long o_stride = static_cast<long>(a.H) * DV;
  const long k_stride = static_cast<long>(a.Hkv) * DQK;
  const long v_stride = static_cast<long>(a.Hkv) * DV;
  const int q_valid = min(kB, a.Sq - q0);
  stage_rows<DQK>(qs,
                  static_cast<const bf16*>(a.q) + (static_cast<long>(b) * a.Sq + q0) * q_stride +
                      static_cast<long>(h) * DQK,
                  q_stride, q_valid);
  stage_rows<DV>(dos,
                 static_cast<const bf16*>(a.dout) + (static_cast<long>(b) * a.Sq + q0) * o_stride +
                     static_cast<long>(h) * DV,
                 o_stride, q_valid);
  if (threadIdx.x < kB) {
    const bool in = threadIdx.x < q_valid;
    const long at = (static_cast<long>(b) * a.H + h) * a.Sq + q0 + threadIdx.x;
    rows[threadIdx.x] = in ? a.lse[at] : 0.f;
    rows[kB + threadIdx.x] = in ? a.delta[at] : 0.f;
  }
  const bf16* kb = static_cast<const bf16*>(a.k) + static_cast<long>(b) * a.Skv * k_stride +
                   static_cast<long>(hk) * DQK;
  const bf16* vb = static_cast<const bf16*>(a.v) + static_cast<long>(b) * a.Skv * v_stride +
                   static_cast<long>(hk) * DV;

  // the KV tiles any query of this tile may see, as the forward visits them
  const int qp_first = a.kv_offset + q0;
  const int qp_last = qp_first + q_valid - 1;
  const int k_lo = a.window > 0 ? max(0, qp_first - a.window + 1) : 0;
  const int k_hi = a.causal ? min(a.Skv, qp_last + 1) : a.Skv;
  const int t_lo = k_lo / kB;
  const int t_hi = k_hi > 0 ? (k_hi + kB - 1) / kB : 0;
  const auto fetch = [&](int kt) {
    unsigned char* st = stages + ((kt - t_lo) % kStages) * (M::kQ + M::kV);
    const int kk = kt * kB;
    const int kv = min(kB, a.Skv - kk);
    stage_rows<DQK>(reinterpret_cast<bf16*>(st), kb + kk * k_stride, k_stride, kv);
    stage_rows<DV>(reinterpret_cast<bf16*>(st + M::kQ), vb + kk * v_stride, v_stride, kv);
  };
  if (t_lo < t_hi) fetch(t_lo);
  cp_async_commit();  // Q, dO and the first KV tile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * (warp % 4);  // this warp's query rows
  const int c0 = 32 * (warp / 4);  // its key columns of S and dP
  const int half = warp / 4;       // its half of dQ's columns
  float acc[NK / 8][4];
#pragma unroll
  for (int n = 0; n < NK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = t_lo; kt < t_hi; ++kt) {
    if (kt + 1 < t_hi) fetch(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* st = stages + ((kt - t_lo) % kStages) * (M::kQ + M::kV);
    const bf16* ks = reinterpret_cast<const bf16*>(st);
    const bf16* vs = reinterpret_cast<const bf16*>(st + M::kQ);
    const int k0 = kt * kB;
    float s[4][4], dp[4][4];
    scores<DQK>(s, qs, ks, r0, c0, lane);  // S: rows queries, columns keys
    scores<DV>(dp, dos, vs, r0, c0, lane);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = r0 + g + 8 * (e >> 1);
        const int i = q0 + ii, j = k0 + c0 + 8 * n + 2 * t + (e & 1);
        const float p = keep(i, j, a.kv_offset + i, a) ? __expf(s[n][e] * a.scale - rows[ii]) : 0.f;
        dp[n][e] = p * (dp[n][e] - rows[kB + ii]);
      }
    }
    put_tiles(s, dp, nullptr, dsh, dsl, r0, c0, lane);
    __syncthreads();
    accumulate<NK, DQK, kSplitDS>(acc, dsh, dsl, ks, r0, half * NK, lane);
    __syncthreads();  // this stage and the dS tiles are free again
  }
  cp_async_wait<0>();

  bf16* dqb = static_cast<bf16*>(a.dq) + (static_cast<long>(b) * a.Sq + q0) * q_stride +
              static_cast<long>(h) * DQK + half * NK + 2 * t;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = r0 + g + 8 * rr;
    if (i >= q_valid) continue;
#pragma unroll
    for (int n = 0; n < NK / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dqb + i * q_stride + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * rr] * a.scale, acc[n][2 * rr + 1] * a.scale);
  }
}

// kernels 2 and 3 of the bf16 route on `stream`
template <int DQK, int DV>
int launch_main(const Args& a, cudaStream_t stream) {
  using M = Smem<DQK, DV>;
  static unsigned attr_set = 0;  // once per device, as in ::launch
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32 || !(attr_set & (1u << dev))) {
    err = cudaFuncSetAttribute(flash_bwd_kernel_mma_dkv<DQK, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(M::kDkv));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_kernel_mma_dq<DQK, DV>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(M::kDq));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 32) attr_set |= 1u << dev;
  }
  const long hb = static_cast<long>(a.H) * a.B;
  const long kv_blocks = (a.Skv + kB - 1) / kB * hb;
  const long q_blocks = (a.Sq + kB - 1) / kB * hb;
  if (kv_blocks >= (1l << 31) || q_blocks >= (1l << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_blocks > 0) {
    flash_bwd_kernel_mma_dkv<DQK, DV>
        <<<static_cast<unsigned>(kv_blocks), kThreads, M::kDkv, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_bwd_kernel_mma_dq<DQK, DV><<<static_cast<unsigned>(q_blocks), kThreads, M::kDq, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// Kernels 1-4 on `stream`: kernels 2 and 3 by dtype (bf16 tc::, float32
// the scalar ones)
template <typename T, int DQK, int DV>
int launch(const Args& a, cudaStream_t stream) {
  const long rows = static_cast<long>(a.B) * a.Sq * a.H;
  const long delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (delta_blocks >= (1l << 31)) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_kernel_delta<T, DV><<<static_cast<unsigned>(delta_blocks), kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    err = static_cast<cudaError_t>(tc::launch_main<DQK, DV>(a, stream));
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    using M = Smem<T, DQK, DV>;
    // once per device: a launch inside a CUDA-graph capture then only enqueues
    static unsigned attr_set = 0;
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 32 || !(attr_set & (1u << dev))) {
      err = cudaFuncSetAttribute(flash_bwd_kernel_dkv<T, DQK, DV>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(M::kBytes));
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(flash_bwd_kernel_dq<T, DQK, DV>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(M::kBytes));
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < 32) attr_set |= 1u << dev;
    }
    if (a.Skv > 0) {
      const dim3 grid_kv((a.Skv + kBK - 1) / kBK, a.H, a.B);
      flash_bwd_kernel_dkv<T, DQK, DV><<<grid_kv, kThreads, M::kBytes, stream>>>(a);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid_q((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
    flash_bwd_kernel_dq<T, DQK, DV><<<grid_q, kThreads, M::kBytes, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.Skv > 0) {
    const int blocks = 132 * 8;
    flash_bwd_kernel_group_sum<T, DQK><<<blocks, kThreads, 0, stream>>>(
        a.dk_part, static_cast<T*>(a.dk), a.B, a.Skv, a.H, a.Hkv);
    flash_bwd_kernel_group_sum<T, DV><<<blocks, kThreads, 0, stream>>>(
        a.dv_part, static_cast<T*>(a.dv), a.B, a.Skv, a.H, a.Hkv);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, int Dv, const Args& a, cudaStream_t stream) {
  if (D == 64 && Dv == 64) return launch<T, 64, 64>(a, stream);
  if (D == 128 && Dv == 128) return launch<T, 128, 128>(a, stream);
  if (D == 256 && Dv == 256) return launch<T, 256, 256>(a, stream);
  if (D == 192 && Dv == 128) return launch<T, 192, 128>(a, stream);
  if (D == 96 && Dv == 64) return launch<T, 96, 64>(a, stream);
  if (D == 32 && Dv == 32) return launch<T, 32, 32>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B, Sq, H, D], k [B, Skv, Hkv, D], v [B, Skv, Hkv, Dv] and dout
// [B, Sq, H, Dv], all contiguous, 16-byte aligned, of one dtype (0
// float32, 1 bfloat16), with the forward's masks; o [B, Sq, H, Dv]
// float32 (the bf16 forward's output before its rounding); lse [B, H, Sq] float32
// from the forward (flash_attention.cu); outputs dq, dk, dv shaped as q,
// k, v in that dtype; scratch: delta [B, H, Sq], dk_part [B, H, Skv, D] and
// dv_part [B, H, Skv, Dv], float32. (D, Dv) as the forward takes them; Hkv
// divides H. Runs the four kernels on `stream`; returns cudaGetLastError()
// after the launches (cudaErrorInvalidValue for widths or a dtype it does
// not take).
extern "C" int flash_attention_backward(const void* q, const void* k, const void* v,
                                        const float* o, const void* dout, const float* lse,
                                        void* dq, void* dk, void* dv, float* delta,
                                        float* dk_part, float* dv_part, int B, int Sq, int Skv,
                                        int H, int Hkv, int D, int Dv, int dtype, int causal,
                                        int window, int kv_offset, void* stream) {
  if (B == 0 || H == 0 || (Sq == 0 && Skv == 0)) return 0;
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq == 0) {  // no query sees the keys: their gradients are zero
    const size_t es = dtype == 0 ? 4 : 2;
    cudaError_t e = cudaMemsetAsync(dk, 0, static_cast<size_t>(B) * Skv * Hkv * D * es, s);
    if (e == cudaSuccess)
      e = cudaMemsetAsync(dv, 0, static_cast<size_t>(B) * Skv * Hkv * Dv * es, s);
    return static_cast<int>(e);
  }
  const Args a{q, k, v, o, dout, lse, delta, dq, dk_part, dv_part, dk, dv,
               B, Sq, Skv, H, Hkv, causal, window, kv_offset,
               1.0f / sqrtf(static_cast<float>(D))};
  if (dtype == 0) return dispatch<float>(D, Dv, a, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(D, Dv, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
