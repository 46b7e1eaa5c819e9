// Flash attention backward for Hopper (sm_90a): dQ, dK and dV of the
// forward in flash_attention.cu (causal / sliding-window / kv_offset masks,
// grouped KV heads, every (DQK, DV) width of the forward), from q, k, v,
// the output o, its gradient dO and the forward's per-row log-sum-exp.
//
// The TPU kernel it pairs with, `repro/kernels/flash_attention.py::
// flash_attention_pallas` (:91), has no backward: the JAX package trains
// through the plain jnp attention (`use_kernel=False`) and lets autodiff
// differentiate it. This kernel computes the gradients of the same
// function, the plain version's `ref.attention_ref`, whose autograd is its
// twin in the tests.
//
// With s_ij = q_i . k_j / sqrt(DQK) masked as the forward masks it,
// P_ij = exp(s_ij - lse_i) (0 where masked), D_i = dO_i . o_i:
//
//   dV_j = sum_i P_ij dO_i          dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - D_i)      dQ_i = sum_j dS_ij k_j / sqrt(DQK)
//   dK_j = sum_i dS_ij q_i / sqrt(DQK)
//
// summed over the query heads that share a KV head for dK and dV. Four
// kernels in stream order, no atomics, every sum in a fixed order, so two
// runs give the same bits:
//
//   1. flash_bwd_kernel_delta: D_i in float32, one warp per (row, head).
//   2. flash_bwd_kernel_dkv: one block per (KV tile of 32 keys, query
//      head, batch) walks the query tiles of 64 rows that its masks leave
//      anything in, in order; recomputes S and dP for the tile, keeps P
//      and dS in shared memory and accumulates dV and dK of its 32 keys in
//      registers; writes them, unscaled by the group sum, to float32
//      scratch [B, H, Skv, D].
//   3. flash_bwd_kernel_dq: one block per (query tile of 64 rows, head,
//      batch) walks its KV tiles in order, recomputes S, dP and dS, and
//      accumulates dQ in registers.
//   4. flash_bwd_kernel_group_sum: dK and dV of each KV head, the sum of
//      the scratch over the query heads of its group in head order,
//      rounded once to the input dtype.
//
// Kernel 2 holds one query head per block (not the whole group) so that
// MQA (8 or 10 query heads over one KV head) still gives B x H x Skv / 32
// blocks; kernel 4's fixed-order sum replaces the atomics a shared dK
// would need. Kernels 2 and 3 both recompute S and dP: the price of
// writing every gradient once, in a fixed order.
//
// Units: float32 FMAs on the CUDA cores (SIMT), operands in shared memory
// in the input dtype (bf16 or float32), every product and sum in float32;
// each thread owns a 2 x 4 tile of S and dP and a 4-row (dK, dV) or 8-row
// (dQ) strip of accumulators, read with 16-byte loads where the width
// allows. A simple kernel first: the tensor cores are a later PR's.
//
// What bounds it on this card: operations. At the gemma-2b training step
// (B 2, S 2048, H 8 over one KV head, D 256) the causal backward is 2.5
// times the forward's 34.4 GFLOP, against 42 MB of q, k, v, o, dO and
// the three gradients: about 2,000 flops a byte. In float32 SIMT it runs
// far from the bf16 tensor-core bound that `chip_smoke.py` reports.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  const void* o;
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

// 1. D_i = dO_i . o_i in float32, one warp per (batch, row, head); written
// as delta [B, H, Sq]
template <typename T, int DV>
__global__ void __launch_bounds__(kThreads) flash_bwd_kernel_delta(Args a) {
  const long row = static_cast<long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long>(a.B) * a.Sq * a.H) return;
  const T* o = static_cast<const T*>(a.o) + row * DV;
  const T* g = static_cast<const T*>(a.dout) + row * DV;
  float acc = 0.f;
  for (int e = lane; e < DV; e += 32) acc = fmaf(to_f(o[e]), to_f(g[e]), acc);
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

template <typename T, int DQK, int DV>
int launch(const Args& a, cudaStream_t stream) {
  using M = Smem<T, DQK, DV>;
  // once per device: a launch inside a CUDA-graph capture then only enqueues
  static unsigned attr_set = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
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
  const long rows = static_cast<long>(a.B) * a.Sq * a.H;
  const long delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (delta_blocks >= (1l << 31)) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_kernel_delta<T, DV><<<static_cast<unsigned>(delta_blocks), kThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
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

// q [B, Sq, H, D], k [B, Skv, Hkv, D], v [B, Skv, Hkv, Dv], o and dout
// [B, Sq, H, Dv], all contiguous, 16-byte aligned, of one dtype (0
// float32, 1 bfloat16), with the forward's masks; lse [B, H, Sq] float32
// from the forward (flash_attention.cu); outputs dq, dk, dv shaped as q,
// k, v in that dtype; scratch: delta [B, H, Sq], dk_part [B, H, Skv, D] and
// dv_part [B, H, Skv, Dv], float32. (D, Dv) as the forward takes them; Hkv
// divides H. Runs the four kernels on `stream`; returns cudaGetLastError()
// after the launches (cudaErrorInvalidValue for widths or a dtype it does
// not take).
extern "C" int flash_attention_backward(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const float* lse,
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
