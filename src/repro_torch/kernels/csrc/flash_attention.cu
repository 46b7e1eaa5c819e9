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
// (mixtral's). The scores are scaled by 1/sqrt(DQK). Query head h reads KV
// head h / (H / Hkv) in place: no repeat is materialised. Both routes
// visit only the KV tiles of 64 keys that their masks leave anything in
// (the TPU kernel visits every tile and masks them; the result is the
// same), and neither uses atomics: every output element is written once,
// in a fixed order, so two runs give the same bits.
//
// Training: given an `lse` pointer, both routes also write each query
// row's log-sum-exp of its scaled, masked scores (float32 [B, H, Sq],
// natural log), from which flash_attention_backward.cu recomputes P; a
// serving call passes null and writes nothing more.
//
// Route: a static choice by dtype, not a fallback; a failed build or
// launch raises in the wrapper.
//
// * bfloat16, every width: the warp-specialised Hopper kernel
//   `ws::flash_attention_kernel_wgmma`, a persistent grid (one block per
//   SM) that walks the output tiles of 64 x kConsumers queries of one
//   (head, batch), heaviest causal tiles first. A block is one producer
//   warpgroup and kConsumers consumer warpgroups of 64 query rows each:
//   two at DV 256 (128 queries a tile), three below (192, so each K and V
//   tile fetched from L2 serves more queries).
//   - The producer lowers its registers with `setmaxnreg` (40, or 24 with
//     three consumers) and one of its threads starts TMA loads: a tile's Q
//     once, then its K and V tiles of 64 keys into a ring of 2-4 stages in
//     shared memory. Each stage has a "full" mbarrier (one arrival with
//     `expect_tx` of the stage's bytes) and an "empty" one (one arrival per
//     consumer warp); Q has the same pair, so the next tile's Q and first
//     K and V tiles load while the consumers finish this one.
//   - The consumers raise theirs (232, or 160 with three) and run
//     S = Q.K^T as `wgmma.mma_async` m64n64k16 with both operands in
//     shared memory (K-major); then the online softmax in float32
//     registers (`ex2.approx.ftz`, log2(e) folded into the scale; masks
//     only on the tiles that a causal diagonal, a window edge or Skv cuts);
//     then O += P.V as `wgmma.mma_async` m64nDVk16 with P taken from
//     registers (the S accumulator re-packed to bf16 A fragments, never
//     stored) and V read from shared memory as an MN-major B operand (the
//     transpose bit). O is rescaled only after the previous P.V has been
//     waited on.
//   - Tensor maps: 4-D, (D, heads, rows, batch), so that a box running
//     past Sq or Skv is filled with zeros by TMA and never reads the next
//     batch's rows; the 128-byte swizzle with 64-column boxes, or the
//     64-byte swizzle with 32-column boxes where a width is not a multiple
//     of 64 (96, 32), and the wgmma descriptors use the same swizzle. They
//     are encoded on the host per launch with `cuTensorMapEncodeTiled`,
//     looked up with `cudaGetDriverEntryPoint` (so the library links no
//     libcuda), and passed as `__grid_constant__` parameters.
//   - Numerics as the plain version's: scores masked with -1e30, P rounded
//     to bf16 for P.V while the denominator sums the unrounded P, output
//     acc / max(l, 1e-30) in bf16, query rows past Sq not written. A tile's
//     arithmetic is the same whichever block runs it.
// * float32, every width: `f32::flash_attention_kernel`, one block of 4
//   warps per (64 queries, head, batch), each warp 16 query rows; Q and
//   each K and V tile staged in shared memory by all threads; scalar FMAs
//   in the accumulator layout of `mma.sync.m16n8k16`, so float32 stays
//   float32 (no TF32). Query tiles run in reverse, longest causal rows
//   first.
#include <cuda.h>  // CUtensorMap and its enums (types only; libcuda is not linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32
// ---------------------------------------------------------------------------

namespace f32 {
constexpr int kBQ = 64;       // queries per block
constexpr int kBK = 64;       // keys per tile
constexpr int kWarps = 4;     // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

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

// Accumulator layout of m16n8k16 (g = lane / 4, t = lane % 4): element e of
// an 8-column tile is row g + 8 * (e / 2), column 2 * t + e % 2.

// s[nt] += Q[warp rows] . K[nt * 8 .. nt * 8 + 7]^T over D
template <typename T, int D>
struct Products;

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
                           const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                           int Sq, int Skv, int H, int Hkv, int causal, int window, int kv_offset,
                           float scale) {
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
    if (lse != nullptr && t == 0)
      lse[(static_cast<long>(b) * H + h) * Sq + q0 + row] = m[r] + logf(l[r]);
    T* orow = ob + row * o_stride + 2 * t;
#pragma unroll
    for (int nd = 0; nd < DV / 8; ++nd) {
      orow[nd * 8] = from_f<T>(o[nd][2 * r] * inv);
      orow[nd * 8 + 1] = from_f<T>(o[nd][2 * r + 1] * inv);
    }
  }
}

template <typename T, int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
           int Skv, int H, int Hkv, int causal, int window, int kv_offset, cudaStream_t stream) {
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
      static_cast<T*>(out), lse, Sq, Skv, H, Hkv, causal, window, kv_offset,
      1.0f / sqrtf(static_cast<float>(DQK)));
  return static_cast<int>(cudaGetLastError());
}


}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: warp-specialised, TMA + wgmma
// ---------------------------------------------------------------------------

namespace ws {

namespace hp = repro_torch::hopper;

// 2^x without exp2f's handling of the denormal range (ex2.approx.ftz): a
// P below 2^-126 becomes 0, three instructions fewer per score
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr int kBN = 64;             // keys per tile
constexpr int kSmemLimit = 232448;  // bytes a block may use on the H100
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// how a head width is cut into TMA boxes: 64 columns under the 128-byte
// swizzle, or 32 under the 64-byte one
template <int D>
struct Cols {
  static constexpr int kSwizzle = D % 64 == 0 ? 128 : 64;  // bytes of one smem row
  static constexpr int kChunk = kSwizzle / 2;              // bf16 columns of one box
  static constexpr int kChunks = D / kChunk;
  static_assert(D % kChunk == 0 && D % 16 == 0, "head width");
};

// A block: one producer warpgroup and kConsumers consumer warpgroups of 64
// query rows each. Two at DV 256, whose O accumulator takes 128 registers
// a thread; three below, so that each K and V tile fetched from L2 serves
// 192 queries instead of 128 (O takes 64 registers there, and a consumer
// gets 160). Registers: the launch gives every thread 65,536 / kThreads
// (168 or 128); setmaxnreg moves them from the producer to the consumers.
// Shared memory: Q [kChunks][kBM rows][kSwizzle bytes], then kStages
// stages of K [kChunks][kBN rows][kSwizzle] and V [kChunks][kBN rows]
// [kSwizzle]; every part starts on a 1024-byte boundary.
template <int DQK, int DV>
struct Layout {
  static constexpr int kConsumers = DV > 128 ? 2 : 3;
  static constexpr int kBM = 64 * kConsumers;  // queries per tile
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kProducerRegs = kConsumers == 2 ? 40 : 24;
  static constexpr int kConsumerRegs = kConsumers == 2 ? 232 : 160;
  static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= 65536, "registers");
  static constexpr int kQBytes = kBM * DQK * 2;
  static constexpr int kKBytes = kBN * DQK * 2;
  static constexpr int kVBytes = kBN * DV * 2;
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kFit = (kSmemLimit - 2048 - kQBytes) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSmem = 1024 + kQBytes + kStages * kStageBytes;  // + alignment slack
  static_assert(kStages >= 2, "the ring needs two stages");
  static_assert(kQBytes % 1024 == 0 && kKBytes % 1024 == 0 && kVBytes % 1024 == 0, "alignment");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S = Q . K^T over DQK, 16 columns a step; started and committed, not
// waited on. `q_addr` and `k_addr` are the warpgroup's Q rows (in chunks
// of BM rows) and the stage's K tile in shared memory.
template <int DQK, int BM>
__device__ __forceinline__ void qk_async(float (&s)[kBN / 2], uint32_t q_addr, uint32_t k_addr) {
  using C = Cols<DQK>;
  const uint64_t da = hp::make_desc(q_addr, 16, 8 * C::kSwizzle, C::kSwizzle);
  const uint64_t db = hp::make_desc(k_addr, 16, 8 * C::kSwizzle, C::kSwizzle);
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk) {
    const int chunk = kk * 16 / C::kChunk;
    const int off = (kk * 16 % C::kChunk) * 2;  // bytes into the swizzled row
    // the descriptors' address field counts 16-byte units
    hp::Wgmma<kBN>::ss(s, da + ((chunk * BM * C::kSwizzle + off) >> 4),
                       db + ((chunk * kBN * C::kSwizzle + off) >> 4), kk > 0);
  }
  hp::wgmma_commit();
}

// O += P . V over the tile's keys, 16 a step; started and committed, not
// waited on. P's registers must stay untouched until the wait.
template <int DV>
__device__ __forceinline__ void pv_async(float (&o)[DV / 2], const uint32_t (&p)[kBN / 4],
                                         uint32_t v_addr) {
  using C = Cols<DV>;
  const uint64_t db = hp::make_desc(v_addr, kBN * C::kSwizzle, 8 * C::kSwizzle, C::kSwizzle);
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    hp::Wgmma<DV>::rs(o, a, db + ((kk * 16 * C::kSwizzle) >> 4), 1);
  }
  hp::wgmma_commit();
}

// The online softmax of one tile of raw scores s (keys k0 ..), in place,
// in log2 units (scale_log2 = log2(e) / sqrt(DQK)): masks where `cut` (a
// diagonal, a window edge or Skv cuts the tile; the branch is uniform over
// the warpgroup), moves the row maxima m, rescales this thread's part of
// the row sums l by alpha, and leaves the tile's unrounded P in s and
// its sums added to l. Element i of s is row g + 8 ((i / 2) % 2), key
// 8 (i / 4) + 2t + i % 2 of the tile.
__device__ __forceinline__ void softmax_tile(float (&s)[kBN / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool cut, int k0,
                                             const int (&qpos)[2], int t, int Skv, int causal,
                                             int window, float scale_log2) {
  float mx[2] = {kNegInf, kNegInf};
  if (cut) {
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      const int qp = qpos[(i / 2) & 1];
      bool ok = key < Skv;
      if (causal) ok = ok && key <= qp;
      if (window > 0) ok = ok && key > qp - window;
      s[i] = ok ? s[i] * scale_log2 : kNegInf;
      mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], s[i]);
    }
  } else {
    // interior tile: the maxima of the raw scores, scaled once (the
    // rounding of a product by a positive scale keeps the order)
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], s[i]);
    mx[0] *= scale_log2;
    mx[1] *= scale_log2;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = exp2_ftz(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
  if (cut) {
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      s[i] = exp2_ftz(s[i] - m[(i / 2) & 1]);
      l[(i / 2) & 1] += s[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      s[i] = exp2_ftz(fmaf(s[i], scale_log2, -m[(i / 2) & 1]));
      l[(i / 2) & 1] += s[i];
    }
  }
}

// P in bf16 as the A fragments of P.V: p[2j + r] holds row g + 8r, keys
// 8j + 2t and 8j + 2t + 1 (the m16n8k16 A layout of each warp's 16 rows).
__device__ __forceinline__ void pack_p(const float (&s)[kBN / 2], uint32_t (&p)[kBN / 4]) {
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    p[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
    p[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

// One output tile: 128 or 192 queries of one (head, batch), and the KV
// tiles [n_lo, n_hi) that its masks leave anything in (the TPU kernel
// visits every tile and masks them; the result is the same).
struct Work {
  int h, b, hk, q0, q_valid, n_lo, n_hi;
};

// Tile t of the list: query tiles from the last (the longest causal rows)
// down, every (head, batch) of one query tile together.
template <int BM>
__device__ __forceinline__ Work work_at(int t, int q_tiles, int B, int Sq, int Skv, int H,
                                        int Hkv, int causal, int window, int kv_offset) {
  Work w;
  const int hb = t % (H * B);
  w.h = hb % H;
  w.b = hb / H;
  w.hk = w.h / (H / Hkv);
  w.q0 = (q_tiles - 1 - t / (H * B)) * BM;
  w.q_valid = min(BM, Sq - w.q0);
  // the keys any query of the tile may see
  const int qp_first = kv_offset + w.q0;
  const int qp_last = qp_first + w.q_valid - 1;
  const int k_lo = window > 0 ? max(0, qp_first - window + 1) : 0;
  const int k_hi = causal ? min(Skv, qp_last + 1) : Skv;
  w.n_lo = k_lo / kBN;
  w.n_hi = (k_hi + kBN - 1) / kBN;
  return w;
}

// The tile a block runs in its round r: rounds alternate direction over
// the blocks (0, 1, .., G-1, then G-1, .., 0), which balances the causal
// tiles' unequal work about as well as a greedy assignment would.
__device__ __forceinline__ int tile_of_round(int r) {
  return r * gridDim.x + ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// A persistent grid: one block per SM walks the output tiles (each tile's
// arithmetic is the same whichever block runs it).
template <int DQK, int DV>
__global__ void __launch_bounds__(Layout<DQK, DV>::kThreads, 1)
    flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                                 const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int B,
                                 int Sq, int Skv, int H, int Hkv, int causal, int window,
                                 int kv_offset, float scale_log2) {
  using L = Layout<DQK, DV>;
  using CQ = Cols<DQK>;
  using CV = Cols<DV>;
  constexpr int kBM = L::kBM;
  __shared__ uint64_t full[L::kStages];
  __shared__ uint64_t empty[L::kStages];
  __shared__ uint64_t q_full;
  __shared__ uint64_t q_empty;
  extern __shared__ __align__(1024) unsigned char ws_smem[];
  // the swizzle atoms must start on 1024-byte boundaries of the shared space
  unsigned char* const qs = ws_smem + ((1024u - (hp::smem_addr(ws_smem) & 1023u)) & 1023u);
  unsigned char* const ring = qs + L::kQBytes;
  const int q_tiles = (Sq + kBM - 1) / kBM;
  const int tiles = q_tiles * H * B;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < L::kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 4 * L::kConsumers);  // one arrival per consumer warp
    }
    hp::mbar_init(&q_full, 1);
    hp::mbar_init(&q_empty, 4 * L::kConsumers);
    hp::mbar_init_fence();
  }
  __syncthreads();  // the last block-wide barrier

  // One if/else whose branches never meet again: ptxas then compiles each
  // role at its own register count (with an early return instead, it kept
  // the consumers at the launch's 168 and spilled at DV 256).
  if (threadIdx.x >= 128) {
    // ---- consumers ----
    hp::setmaxnreg_inc<L::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: tile rows 64 cw ..
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = cw * 64 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
    const uint32_t q_addr = hp::smem_addr(qs) + cw * 64 * CQ::kSwizzle;
    auto stage_addr = [&](int st) { return hp::smem_addr(ring + st * L::kStageBytes); };
    int stage = 0;
    uint32_t phase = 0;
    for (int r = 0;; ++r) {
      const int tile = tile_of_round(r);
      if (tile >= tiles) break;
      const Work w =
          work_at<kBM>(tile, q_tiles, B, Sq, Skv, H, Hkv, causal, window, kv_offset);
      const int qpos[2] = {kv_offset + w.q0 + row0, kv_offset + w.q0 + row0 + 8};
      const int wg_first = kv_offset + w.q0 + cw * 64;  // positions of the warpgroup's rows
      const int wg_last = wg_first + 63;
      float o[DV / 2];
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
      float m[2] = {kNegInf, kNegInf};
      float l[2] = {0.f, 0.f};  // this thread's part of the row sums
      float s[kBN / 2];
      uint32_t p[kBN / 4];
      float alpha[2];

      hp::mbar_wait(&q_full, r & 1);
      __syncwarp();  // the warp is converged again before its first wgmma
      if (w.n_lo >= w.n_hi && lane == 0) hp::mbar_arrive(&q_empty);
      for (int n = w.n_lo; n < w.n_hi; ++n) {
        const int k0 = n * kBN;
        hp::mbar_wait(&full[stage], phase);
        __syncwarp();
        const uint32_t k_addr = stage_addr(stage);
        qk_async<DQK, kBM>(s, q_addr, k_addr);
        hp::wgmma_wait<0>();
        hp::fence_regs(s);
        if (n == w.n_hi - 1) {
          __syncwarp();
          if (lane == 0) hp::mbar_arrive(&q_empty);  // Q is read for the last time
        }
        const bool cut = k0 + kBN > Skv || (causal && k0 + kBN - 1 > wg_first) ||
                         (window > 0 && k0 <= wg_last - window);
        softmax_tile(s, m, l, alpha, cut, k0, qpos, t, Skv, causal, window, scale_log2);
        pack_p(s, p);
        // the previous P.V has been waited on: O can be rescaled
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i / 2) & 1];
        pv_async<DV>(o, p, k_addr + L::kKBytes);
        hp::wgmma_wait<0>();
        hp::fence_regs(o);
        hp::fence_regs(p);
        __syncwarp();
        if (lane == 0) hp::mbar_arrive(&empty[stage]);  // this warp is done with K and V
        if (++stage == L::kStages) {
          stage = 0;
          phase ^= 1u;
        }
      }

#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
        const int row = row0 + 8 * rr;
        if (row >= w.q_valid) continue;
        const float inv = 1.f / fmaxf(l[rr], 1e-30f);
        // the row's log-sum-exp in natural units (m is in log2 units)
        if (lse != nullptr && t == 0)
          lse[(static_cast<long>(w.b) * H + w.h) * Sq + w.q0 + row] = (m[rr] + log2f(l[rr])) * kLn2;
        __nv_bfloat16* orow = out + ((static_cast<long>(w.b) * Sq + w.q0 + row) * H + w.h) *
                                        static_cast<long>(DV) +
                              2 * t;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(o[4 * j + 2 * rr] * inv, o[4 * j + 2 * rr + 1] * inv);
        }
      }
    }
  } else {
    // ---- producer ----
    hp::setmaxnreg_dec<L::kProducerRegs>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int r = 0;; ++r) {
        const int tile = tile_of_round(r);
        if (tile >= tiles) break;
        const Work w =
            work_at<kBM>(tile, q_tiles, B, Sq, Skv, H, Hkv, causal, window, kv_offset);
        hp::mbar_wait(&q_empty, (r & 1) ^ 1u);  // the last tile's Q is no longer read
        hp::mbar_arrive_expect_tx(&q_full, L::kQBytes);
#pragma unroll
        for (int c = 0; c < CQ::kChunks; ++c)
          hp::tma_load_4d(qs + c * kBM * CQ::kSwizzle, &tm_q, &q_full, c * CQ::kChunk, w.h, w.q0,
                          w.b);
        for (int n = w.n_lo; n < w.n_hi; ++n) {
          hp::mbar_wait(&empty[stage], phase ^ 1u);  // passes at once in the first round
          unsigned char* const ks = ring + stage * L::kStageBytes;
          unsigned char* const vs = ks + L::kKBytes;
          hp::mbar_arrive_expect_tx(&full[stage], L::kStageBytes);
#pragma unroll
          for (int c = 0; c < CQ::kChunks; ++c)
            hp::tma_load_4d(ks + c * kBN * CQ::kSwizzle, &tm_k, &full[stage], c * CQ::kChunk,
                            w.hk, n * kBN, w.b);
#pragma unroll
          for (int c = 0; c < CV::kChunks; ++c)
            hp::tma_load_4d(vs + c * kBN * CV::kSwizzle, &tm_v, &full[stage], c * CV::kChunk,
                            w.hk, n * kBN, w.b);
          if (++stage == L::kStages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up once with cudaGetDriverEntryPoint
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A failed encoding returns this plus its CUresult.
constexpr int kEncodeFailed = 10000;

// the 4-D map (D, heads, rows, batch) of a contiguous bf16 [batch, rows,
// heads, D] tensor, read in boxes of (swizzle / 2 columns, 1, box_rows, 1)
int encode(CUtensorMap* map, const void* ptr, int D, int heads, int rows, int batch, int box_rows,
           int swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {row_bytes, row_bytes * heads, row_bytes * heads * rows};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(swizzle / 2), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
           int Skv, int H, int Hkv, int causal, int window, int kv_offset, cudaStream_t stream) {
  using L = Layout<DQK, DV>;
  if (Skv == 0) {  // no keys: every row is 0 / max(0, 1e-30), as the float32 kernel gives
    if (lse != nullptr) {
      const cudaError_t e =
          cudaMemsetAsync(lse, 0, static_cast<size_t>(B) * H * Sq * sizeof(float), stream);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(B) * Sq * H * DV * sizeof(__nv_bfloat16), stream));
  }
  const int q_tiles = (Sq + L::kBM - 1) / L::kBM;
  if (static_cast<long>(q_tiles) * H * B >= (1l << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  // Host work only (no stream operation), so a launch can be captured in
  // a CUDA graph; the graph keeps the maps, which name this call's tensors.
  CUtensorMap tq, tk, tv;
  int code = encode(&tq, q, DQK, H, Sq, B, L::kBM, Cols<DQK>::kSwizzle);
  if (code == 0) code = encode(&tk, k, DQK, Hkv, Skv, B, kBN, Cols<DQK>::kSwizzle);
  if (code == 0) code = encode(&tv, v, DV, Hkv, Skv, B, kBN, Cols<DV>::kSwizzle);
  if (code != 0) return code;
  // once per device: a launch inside a CUDA-graph capture then only enqueues
  static unsigned attr_set = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32 || !(attr_set & (1u << dev))) {
    err = cudaFuncSetAttribute(flash_attention_kernel_wgmma<DQK, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 32) attr_set |= 1u << dev;
  }
  static int sms[32] = {0};  // SMs of each device, read once
  int sm_count = dev < 32 ? sms[dev] : 0;
  if (sm_count == 0) {
    err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 32) sms[dev] = sm_count;
  }
  const long tiles = static_cast<long>(q_tiles) * H * B;
  const int grid = static_cast<int>(tiles < sm_count ? tiles : sm_count);
  flash_attention_kernel_wgmma<DQK, DV><<<grid, L::kThreads, L::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, B, Sq, Skv, H, Hkv, causal, window,
      kv_offset, kLog2e / sqrtf(static_cast<float>(DQK)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ws

// dtype 0 float32, 1 bfloat16: the route is a static choice by dtype
int dispatch(int dtype, int D, int Dv, const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int Sq, int Skv, int H, int Hkv, int causal, int window,
             int kv_offset, cudaStream_t stream) {
#define REPRO_FLASH(DQK, DV)                                                                 \
  (dtype == 1 ? ws::launch<DQK, DV>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, causal, window,  \
                                    kv_offset, stream)                                       \
              : f32::launch<float, DQK, DV>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, causal,   \
                                            window, kv_offset, stream))
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
// (96, 64), (32, 32)}; Hkv divides H. lse [B, H, Sq] float32 or null: each
// row's log-sum-exp of its scaled, masked scores (natural log), which the
// backward (flash_attention_backward.cu) recomputes P from; written only
// when given. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for widths or a dtype it does not take; 10000 +
// the CUresult where a bf16 tensor map cannot be encoded).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               float* lse, int B, int Sq, int Skv, int H, int Hkv, int D, int Dv,
                               int dtype, int causal, int window, int kv_offset, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, D, Dv, q, k, v, out, lse, B, Sq, Skv, H, Hkv, causal, window, kv_offset,
                  static_cast<cudaStream_t>(stream));
}
