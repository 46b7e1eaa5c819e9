// Flash attention forward for Hopper (sm_90a): causal / sliding-window /
// kv_offset masks, grouped KV heads, one launch for every (batch, head).
//
// Replaces `repro/kernels/flash_attention.py::flash_attention_pallas`
// (:91, `pallas_call` at :118) and the `vmap` over (batch, head) with the
// `jnp.repeat` of the KV heads around it (`repro/kernels/ops.py:157-182`).
//
// What bounds it on this card: operations. At the gemma-2b prefill (B 4,
// S 2048, H 8 over one KV head, D 256) the causal products are 68.7 GFLOP
// against 75.5 MB of q, k, v and out, about 900 flops per byte, three
// times the H100's 295: the tensor cores, not the memory, are the limit.
// The same holds at deepseek-v2-lite's MLA prefill (B 4, S 2048, H 16,
// q and k of width 192, v of width 128): 85.9 GFLOP against 168 MB, about
// 510 flops per byte.
//
// Head widths: q and k share DQK, v and the output have DV. The
// instantiations are (DQK, DV) = (64, 64), (128, 128), (256, 256), MLA's
// (192, 128) (a 128-wide head plus a 64-wide RoPE tail for q and k), and
// for the reduced configs (96, 64) (deepseek's 64 + 32) and (32, 32)
// (mixtral's). The scores are scaled by 1/sqrt(DQK).
//
// Design. One block of 4 warps per (tile of 64 queries, head, batch); each
// warp owns 16 query rows. Query head h reads KV head h / (H / Hkv) in
// place: no repeat is materialised. The block walks the KV tiles of 64
// keys that its masks leave anything in (the TPU kernel visits every tile
// and masks them; the result is the same), staging Q once and each K and
// V tile in dynamic shared memory (D = 256 needs more than the 48 KB of
// static shared memory). Scores and the running max, denominator and
// output accumulator live in float32 registers, in the accumulator layout
// of `mma.sync.m16n8k16`, so the online softmax rescales rows in place.
// bf16 inputs multiply on the tensor cores (`mma.sync`, float32
// accumulation; P is rounded to bf16 for the P.V product, the denominator
// sums the unrounded P). float32 inputs take the same layout with scalar
// FMAs, so float32 stays float32. The output is acc / max(l, 1e-30) in
// q's dtype; query rows past Sq are not written. The query tiles run in
// reverse so the longest causal rows start first. No atomics: every
// output element is written once, in a fixed order.
//
// Later work (not here): wgmma and TMA, a producer warp and a ring of KV
// tiles, and several query tiles per block.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // queries per block
constexpr int kBK = 64;       // keys per tile
constexpr int kWarps = 4;     // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
struct Tile {
  static constexpr int kPad = 16 / sizeof(T);  // keeps rows 16-byte aligned, spreads banks
};

// rows [0, valid) of a head's [rows, D] slice (consecutive rows `stride`
// elements apart) into a [64, ld] shared tile; rows past `valid` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* __restrict__ dst, int ld, const T* __restrict__ src,
                                          long stride, int valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < 64 * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) v = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Accumulator layout of m16n8k16 (g = lane / 4, t = lane % 4): element e of
// an 8-column tile is row g + 8 * (e / 2), column 2 * t + e % 2.

// s[nt] += Q[warp rows] . K[nt * 8 .. nt * 8 + 7]^T over D
template <typename T, int D>
struct Products;

template <int D>
struct Products<__nv_bfloat16, D> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ void qk(float (&s)[kBK / 8][4], const T* q, int ldq,
                                            const T* k, int ldk, int g, int t) {
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      const T* q0 = q + g * ldq + kk + 2 * t;
      const uint32_t a[4] = {ld32(q0), ld32(q0 + 8 * ldq), ld32(q0 + 8), ld32(q0 + 8 * ldq + 8)};
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        const T* k0 = k + (nt * 8 + g) * ldk + kk + 2 * t;
        mma_bf16(s[nt], a, ld32(k0), ld32(k0 + 8));
      }
    }
  }
  // o[nd] += P[warp rows] . V[:, nd * 8 .. nd * 8 + 7] over the tile's keys
  static __device__ __forceinline__ void pv(float (&o)[D / 8][4], const T* p, int ldp,
                                            const T* v, int ldv, int g, int t) {
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      const T* p0 = p + g * ldp + kk + 2 * t;
      const uint32_t a[4] = {ld32(p0), ld32(p0 + 8 * ldp), ld32(p0 + 8), ld32(p0 + 8 * ldp + 8)};
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const T* v0 = v + (kk + 2 * t) * ldv + nd * 8 + g;
        mma_bf16(o[nd], a, pack(v0[0], v0[ldv]), pack(v0[8 * ldv], v0[9 * ldv]));
      }
    }
  }
};

template <int D>
struct Products<float, D> {
  using T = float;
  static __device__ __forceinline__ void qk(float (&s)[kBK / 8][4], const T* q, int ldq,
                                            const T* k, int ldk, int g, int t) {
    const T* q0 = q + g * ldq;
    const T* q1 = q0 + 8 * ldq;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      const T* k0 = k + (nt * 8 + 2 * t) * ldk;
      const T* k1 = k0 + ldk;
      float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        c0 += q0[d] * k0[d];
        c1 += q0[d] * k1[d];
        c2 += q1[d] * k0[d];
        c3 += q1[d] * k1[d];
      }
      s[nt][0] += c0;
      s[nt][1] += c1;
      s[nt][2] += c2;
      s[nt][3] += c3;
    }
  }
  static __device__ __forceinline__ void pv(float (&o)[D / 8][4], const T* p, int ldp,
                                            const T* v, int ldv, int g, int t) {
    const T* p0 = p + g * ldp;
    const T* p1 = p0 + 8 * ldp;
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float a0 = p0[j], a1 = p1[j];
      const T* vj = v + j * ldv + 2 * t;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const float v0 = vj[nd * 8], v1 = vj[nd * 8 + 1];
        o[nd][0] += a0 * v0;
        o[nd][1] += a0 * v1;
        o[nd][2] += a1 * v0;
        o[nd][3] += a1 * v1;
      }
    }
  }
};

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv, int H,
                           int Hkv, int causal, int window, int kv_offset, float scale) {
  constexpr int kLd = DQK + Tile<T>::kPad;   // Q and K rows
  constexpr int kLdv = DV + Tile<T>::kPad;   // V rows
  constexpr int kLdp = kBK + Tile<T>::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kBQ * kLd;
  T* vs = ks + kBK * kLd;
  T* ps = vs + kBK * kLdv;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;

  const long q_stride = static_cast<long>(H) * DQK;
  const long k_stride = static_cast<long>(Hkv) * DQK;
  const long v_stride = static_cast<long>(Hkv) * DV;
  const long o_stride = static_cast<long>(H) * DV;
  const T* qb = q + (static_cast<long>(b) * Sq + q0) * q_stride + static_cast<long>(h) * DQK;
  const T* kb = k + static_cast<long>(b) * Skv * k_stride + static_cast<long>(hk) * DQK;
  const T* vb = v + static_cast<long>(b) * Skv * v_stride + static_cast<long>(hk) * DV;

  const int q_valid = min(kBQ, Sq - q0);
  load_tile<T, DQK>(qs, kLd, qb, q_stride, q_valid);

  // keys any query of this tile may see
  const int qp_first = kv_offset + q0;
  const int qp_last = kv_offset + q0 + q_valid - 1;
  const int k_lo = window > 0 ? max(0, qp_first - window + 1) : 0;
  const int k_hi = causal ? min(Skv, qp_last + 1) : Skv;

  float o[DV / 8][4];
#pragma unroll
  for (int nd = 0; nd < DV / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  const int qpos[2] = {kv_offset + q0 + wr + g, kv_offset + q0 + wr + g + 8};

  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    const int k_valid = min(kBK, Skv - k0);
    load_tile<T, DQK>(ks, kLd, kb + k0 * k_stride, k_stride, k_valid);
    load_tile<T, DV>(vs, kLdv, vb + k0 * v_stride, v_stride, k_valid);
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    Products<T, DQK>::qk(s, qs + wr * kLd, kLd, ks, kLd, g, t);

    float row_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + nt * 8 + 2 * t + (e & 1);
        const int qp = qpos[e >> 1];
        bool ok = j < Skv;
        if (causal) ok = ok && j <= qp;
        if (window > 0) ok = ok && j > qp - window;
        const float val = ok ? s[nt][e] * scale : kNegInf;
        s[nt][e] = val;
        row_max[e >> 1] = fmaxf(row_max[e >> 1], val);
      }
    }
    float alpha[2], row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 1));
      row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 2));
      const float m_new = fmaxf(m[r], row_max[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    T* pw = ps + wr * kLdp;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        row_sum[e >> 1] += p;
        pw[(g + 8 * (e >> 1)) * kLdp + nt * 8 + 2 * t + (e & 1)] = from_f<T>(p);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
      row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
      l[r] = l[r] * alpha[r] + row_sum[r];
    }
#pragma unroll
    for (int nd = 0; nd < DV / 8; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }
    __syncwarp();  // the warp's P rows are written
    Products<T, DV>::pv(o, pw, kLdp, vs, kLdv, g, t);
  }

  T* ob = out + (static_cast<long>(b) * Sq + q0) * o_stride + static_cast<long>(h) * DV;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr + g + 8 * r;
    if (row >= q_valid) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = ob + row * o_stride + 2 * t;
#pragma unroll
    for (int nd = 0; nd < DV / 8; ++nd) {
      orow[nd * 8] = from_f<T>(o[nd][2 * r] * inv);
      orow[nd * 8 + 1] = from_f<T>(o[nd][2 * r + 1] * inv);
    }
  }
}

template <typename T, int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv, int H,
           int Hkv, int causal, int window, int kv_offset, cudaStream_t stream) {
  constexpr int kLd = DQK + Tile<T>::kPad;
  constexpr int kLdv = DV + Tile<T>::kPad;
  constexpr int kLdp = kBK + Tile<T>::kPad;
  const size_t smem = sizeof(T) * (static_cast<size_t>(kBQ + kBK) * kLd +
                                   static_cast<size_t>(kBK) * kLdv + kBQ * kLdp);
  // once per device: a launch inside a CUDA-graph capture then only enqueues
  static unsigned attr_set = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32 || !(attr_set & (1u << dev))) {
    err = cudaFuncSetAttribute(flash_attention_kernel<T, DQK, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 32) attr_set |= 1u << dev;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, DQK, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Skv, H, Hkv, causal, window, kv_offset,
      1.0f / sqrtf(static_cast<float>(DQK)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, int Dv, const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Skv, int H, int Hkv, int causal, int window, int kv_offset,
               cudaStream_t stream) {
#define REPRO_FLASH(DQK, DV) \
  launch<T, DQK, DV>(q, k, v, out, B, Sq, Skv, H, Hkv, causal, window, kv_offset, stream)
  if (D == 64 && Dv == 64) return REPRO_FLASH(64, 64);
  if (D == 128 && Dv == 128) return REPRO_FLASH(128, 128);
  if (D == 256 && Dv == 256) return REPRO_FLASH(256, 256);
  if (D == 192 && Dv == 128) return REPRO_FLASH(192, 128);
  if (D == 96 && Dv == 64) return REPRO_FLASH(96, 64);
  if (D == 32 && Dv == 32) return REPRO_FLASH(32, 32);
#undef REPRO_FLASH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B, Sq, H, D], k [B, Skv, Hkv, D], v [B, Skv, Hkv, Dv], out [B, Sq, H,
// Dv], all contiguous, 16-byte aligned, of one dtype (0 float32, 1
// bfloat16); (D, Dv) in {(64, 64), (128, 128), (256, 256), (192, 128),
// (96, 64), (32, 32)};
// Hkv divides H. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for widths or a dtype it does not take).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                               int Sq, int Skv, int H, int Hkv, int D, int Dv, int dtype,
                               int causal, int window, int kv_offset, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, Dv, q, k, v, out, B, Sq, Skv, H, Hkv, causal, window,
                             kv_offset, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, Dv, q, k, v, out, B, Sq, Skv, H, Hkv, causal, window,
                                     kv_offset, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
