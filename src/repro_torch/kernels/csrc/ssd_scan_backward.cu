// Mamba-2 SSD scan backward for Hopper (sm_90a): the gradients of
//
//   state_s = exp(a_s) * state_{s-1} + dt_s * x_s (x) B_s     [P, N] per head
//   y_s     = state_s . C_s
//
// (ssd_scan.cu's function, from an optional initial state, B and C in group
// form) with respect to x, a, dt, B, C and the initial state, given dy
// and the final state's gradient (or none).
//
// The TPU kernel it pairs with, `repro/kernels/ssd_scan.py::
// ssd_scan_pallas` (:65), has no backward: the JAX package trains through
// `ssd_chunked_jnp` and lets autodiff differentiate it. This kernel
// computes the gradients of the same function; autograd of the plain
// version `ref.ssd_chunked_ref` (`ref.ssd_backward_ref`) is its twin in the
// tests, and `ref.ssd_chunk_grads_ref` writes its algorithm out in plain
// PyTorch.
//
// Design: the chunked form again, chunks of L = 64 steps (its own length,
// whatever the forward's; see below), csum the running sum of a within a
// chunk, H_c the state entering chunk c and D_c the gradient arriving at
// its end (from the later chunks and the final state). Four kernels (bf16:
// three) in stream order, no atomics, every sum in a fixed order, so two
// runs give the same bits:
//
//   1. chunk states, one block per (chunk, head, batch):
//      the chunk's own forward state S_c = sum_j exp(csum_L - csum_j) dt_j
//      x_j (x) B_j, its reverse state R_c = sum_i exp(csum_i) dy_i (x) C_i,
//      and its decay exp(csum_L), into float32 scratch.
//   2. ssd_bwd_kernel_state_pass, two threads per (state element, head,
//      batch): one H_c = decay_c H_{c-1} + S_c in chunk order from the
//      initial state, the other D_{c-1} = decay_c D_c + R_c in reverse
//      order from the final state's gradient, each written over its
//      chunk's slot, eight chunks' loads issued together; the initial
//      state's gradient is D_{-1}.
//   3. chunk gradients, one block per (chunk, head, batch) (bf16: per
//      (chunk, group, batch), below): with
//      G_ij = C_i . B_j, X_ij = dy_i . x_j and E_ij = exp(csum_i - csum_j)
//      for j <= i (the quadratic form of the forward's chunk),
//        dx_j = sum_i G_ij E_ij dt_j dy_i + dt_j e_j D_c B_j
//        dB_j = sum_i X_ij E_ij dt_j C_i + dt_j e_j D_c^T x_j
//        dC_i = sum_j X_ij E_ij dt_j B_j + exp(csum_i) H_c^T dy_i
//        ddt_j = sum_i G_ij X_ij E_ij + e_j x_j^T D_c B_j
//      with e_j = exp(csum_L - csum_j); and da from the gradient of each
//      csum_i, summed from the chunk's end (da_j = sum_{i >= j} dcsum_i):
//        dcsum_i = sum_{j<=i} Q_ij - sum_{k>=i} Q_ki + exp(csum_i) dy_i^T
//                  H_c C_i - T_i [+ sum_j T_j + exp(csum_L) <D_c, H_c> at
//                  the chunk's last step]
//      where Q_ij = G_ij X_ij E_ij dt_j and T_j = dt_j e_j x_j^T D_c B_j.
//      float32: dB and dC are written per head into float32 scratch, and
//   4. ssd_bwd_kernel_group_sum sums each group's heads in head order,
//      rounded once to the input dtype. bf16: one block per (chunk, group,
//      batch) walks the group's heads in order, computes G = C B^T once
//      for them, sums dB and dC over them in registers and writes them
//      once: no per-head scratch and no kernel 4.
//
// The exponents are always differences csum_i - csum_j with i >= j (or
// csum_L - csum_j), so <= 0: nothing overflows. A ragged tail is padded
// inside the kernels with zeros (a = dt = 0 there), which leaves every
// sum as it was; its rows are not written.
//
// Route: a static choice by dtype, as the forward's; not a fallback.
//
// * bfloat16: kernels 1 and 3 are tc::ssd_bwd_kernel_mma_chunk_state and
//   tc::ssd_bwd_kernel_mma_chunk_grad, every product on the tensor cores
//   as `mma.sync.m16n8k16` (bf16 in, float32 accumulators), operands read
//   with `ldmatrix` (`.trans` where a tile is stored the other way round)
//   from shared-memory rows padded by 16 bytes; a warp takes 16 x 16
//   output blocks (kernel 3: one column block and its row blocks, so a B
//   fragment serves them all). x, dy, B and C are bf16 inputs and enter
//   exactly. Every float32 operand enters as a sum of bf16 parts, one
//   product each, each part the bf16 of what the parts before it leave
//   (the forward splits its own in two, ssd_scan.cu):
//     - three parts, float32's 24 bits, for the operands that reach da:
//       x w and dy e (kernel 1), H_c and D_c (kernel 3). With two, da at
//       mamba2-130m's training call missed its 1e-3 by 5.6x on the card
//       (PERF.md): <D_c, H_c> and the states' sums are large, and da is a
//       difference of them;
//     - two parts, about 16 bits, for m1 = G E dt and m2 = X E dt, which
//       reach only dx, dB and dC (rtol 1e-2).
//   G and X, the carried states and every accumulator stay float32; the
//   causal blocks above the diagonal are skipped. The scalar parts (the
//   row and column sums that make dcsum and ddt, da's reverse running sum)
//   are the float32 kernel's.
//   Chunks of L = 64, not the forward's 128: kernel 3 holds x, dy, B, C,
//   H_c and D_c (three parts each) and m1 and m2 (two each) in shared
//   memory, 199 KB at P 64, N 128 and L 64; at L 128 the tiles alone would
//   be 342 KB of the 227 KB a block may have.
// * float32: the scalar kernels ssd_bwd_kernel_chunk_state and _chunk_grad,
//   float32 FMAs on the CUDA cores, every operand staged in shared memory,
//   each thread a 4-row tile of each product. No TF32.
//
// What bounds it on this card: bytes. At the mamba2-130m training step (B 4,
// S 2048, H 24, P 64, G 1, N 128, bf16) the function reads x, dy, B, C, a,
// dt once and writes dx, dB, dC, da, ddt once: about 87 MB, 26 us at 3.35
// TB/s. The float32 chunk states (S_c and R_c, then H_c and D_c: [B, H,
// S / L, P, N], 100 MB each at L 64) are written, read and rewritten by the
// pass and read again by kernel 3, 0.24 ms of traffic (float32 also
// writes dB and dC per head, 2 x 100 MB, and reads them back in kernel 4).
// The bf16 products with their parts are about 60 GFLOP.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kL = 64;  // steps per chunk
constexpr int kThreads = 256;
constexpr int kLdL = kL + 1;  // [kL][kLdL] float32 matrices: odd rows spread banks

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

struct Args {
  const void* x;     // [B, S, H, P]
  const float* dt;   // [B, S, H]
  const float* a;    // [B, S, H]
  const void* bm;    // [B, S, G, N]
  const void* cm;    // [B, S, G, N]
  const float* init;  // [B, H, P, N] or null
  const void* dy;    // [B, S, H, P]
  const float* dfinal;  // [B, H, P, N] or null
  void* dx;
  float* ddt;
  float* da;
  void* db;  // [B, S, G, N]
  void* dc;
  float* dinit;    // [B, H, P, N] or null
  float* fstates;  // [B, H, nc, P, N]: S_c, then H_c
  float* rstates;  // [B, H, nc, P, N]: R_c, then D_c
  float* decay;    // [B, H, nc]
  float* db_h;     // [B, S, H, N]
  float* dc_h;     // [B, S, H, N]
  int B, S, H, G, nc;
};

// A ROWS x COLS product tile of one thread: rows 4 rg .. 4 rg + 3 and
// columns cg + CGN c (c < TC); the block's 256 threads cover the whole
// product, CGN consecutive lanes sharing their rows.
template <int ROWS, int COLS>
struct Tile {
  static constexpr int TR = 4;
  static constexpr int RG = ROWS / TR;
  static constexpr int CGN = kThreads / RG < COLS ? kThreads / RG : COLS;
  static constexpr int TC = COLS / CGN;
  static_assert(ROWS % TR == 0 && COLS % CGN == 0 && RG * CGN <= kThreads, "tile shape");
  int rg, cg;
  bool active;
  float v[TR][TC];
  __device__ Tile() : rg(threadIdx.x / CGN), cg(threadIdx.x % CGN), active(rg < RG) {
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < TC; ++c) v[r][c] = 0.f;
  }
  __device__ int row(int r) const { return rg * TR + r; }
  __device__ int col(int c) const { return cg + CGN * c; }
  // v[r][c] += sum_k fa(row(r), k) * fb(k, col(c))
  template <int K, class FA, class FB>
  __device__ void mm(FA fa, FB fb) {
    if (!active) return;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float av[TR], bv[TC];
#pragma unroll
      for (int r = 0; r < TR; ++r) av[r] = fa(row(r), k);
#pragma unroll
      for (int c = 0; c < TC; ++c) bv[c] = fb(k, col(c));
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < TC; ++c) v[r][c] = fmaf(av[r], bv[c], v[r][c]);
    }
  }
};

// rows [0, valid) of a [kL, W] slice into a float32 [kL][W] shared tile
// (zeros past valid); step s of the slice at src + s * stride
template <typename T, int W>
__device__ __forceinline__ void stage(float* dst, const T* src, long stride, int valid) {
  for (int i = threadIdx.x; i < kL * W; i += kThreads) {
    const int s = i / W, w = i % W;
    dst[i] = s < valid ? to_f(src[s * stride + w]) : 0.f;
  }
}

// dt and the running sum of a over the chunk's steps (zeros past valid),
// one thread, in step order
__device__ __forceinline__ void stage_steps(float* dt_s, float* csum, const Args& p, int b, int h,
                                            int s0, int valid) {
  if (threadIdx.x < kL) {
    const long at = (static_cast<long>(b) * p.S + s0 + threadIdx.x) * p.H + h;
    dt_s[threadIdx.x] = threadIdx.x < valid ? p.dt[at] : 0.f;
    csum[threadIdx.x] = threadIdx.x < valid ? p.a[at] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int i = 0; i < kL; ++i) {
      run += csum[i];
      csum[i] = run;
    }
  }
  __syncthreads();
}

// 1. S_c, R_c and the decay of one chunk
template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_bwd_kernel_chunk_state(Args p) {
  extern __shared__ __align__(16) float sm1[];
  float* xs = sm1;            // [kL][P]
  float* dys = xs + kL * P;   // [kL][P]
  float* bs = dys + kL * P;   // [kL][N]
  float* cs = bs + kL * N;    // [kL][N]
  float* dt_s = cs + kL * N;  // [kL]
  float* csum = dt_s + kL;    // [kL]
  float* w = csum + kL;       // [kL]: exp(csum_L - csum_j) dt_j
  float* e = w + kL;          // [kL]: exp(csum_i)
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int s0 = c * kL;
  const int valid = min(kL, p.S - s0);
  const int g = h / (p.H / p.G);
  const long xrow = static_cast<long>(p.H) * P, grow = static_cast<long>(p.G) * N;
  const long xoff = (static_cast<long>(b) * p.S + s0) * xrow + static_cast<long>(h) * P;
  const long goff = (static_cast<long>(b) * p.S + s0) * grow + static_cast<long>(g) * N;
  stage<T, P>(xs, static_cast<const T*>(p.x) + xoff, xrow, valid);
  stage<T, P>(dys, static_cast<const T*>(p.dy) + xoff, xrow, valid);
  stage<T, N>(bs, static_cast<const T*>(p.bm) + goff, grow, valid);
  stage<T, N>(cs, static_cast<const T*>(p.cm) + goff, grow, valid);
  stage_steps(dt_s, csum, p, b, h, s0, valid);
  if (threadIdx.x < kL) {
    w[threadIdx.x] = expf(csum[kL - 1] - csum[threadIdx.x]) * dt_s[threadIdx.x];
    e[threadIdx.x] = expf(csum[threadIdx.x]);
  }
  __syncthreads();
  Tile<P, N> fs, rs;
  fs.template mm<kL>([&](int pp, int j) { return xs[j * P + pp] * w[j]; },
                     [&](int j, int n) { return bs[j * N + n]; });
  rs.template mm<kL>([&](int pp, int i) { return dys[i * P + pp] * e[i]; },
                     [&](int i, int n) { return cs[i * N + n]; });
  const long slot = ((static_cast<long>(b) * p.H + h) * p.nc + c) * P * N;
  if (fs.active) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < Tile<P, N>::TC; ++cc) {
        const long at = slot + static_cast<long>(fs.row(r)) * N + fs.col(cc);
        p.fstates[at] = fs.v[r][cc];
        p.rstates[at] = rs.v[r][cc];
      }
  }
  if (threadIdx.x == 0) p.decay[(static_cast<long>(b) * p.H + h) * p.nc + c] = expf(csum[kL - 1]);
}

// 2. the states entering each chunk (the first half of the grid's x
// blocks) and the gradients arriving at each chunk's end (the second
// half), in place of S_c and R_c. A thread walks its element's chunks in
// order, kPassBatch chunks' loads issued together ahead of their stores.
constexpr int kPassBatch = 8;

__global__ void __launch_bounds__(kThreads) ssd_bwd_kernel_state_pass(Args p, int PN) {
  const int half = (PN + kThreads - 1) / kThreads;
  const bool reverse = static_cast<int>(blockIdx.x) >= half;
  const int el = (reverse ? blockIdx.x - half : blockIdx.x) * kThreads + threadIdx.x;
  if (el >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long bh = static_cast<long>(b) * p.H + h;
  const float* dec = p.decay + bh * p.nc;
  const int nc = p.nc;
  if (!reverse) {
    float* fs = p.fstates + bh * nc * PN + el;
    float st = p.init != nullptr ? p.init[bh * PN + el] : 0.f;
    for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
      float own[kPassBatch];
#pragma unroll
      for (int i = 0; i < kPassBatch; ++i)
        own[i] = c0 + i < nc ? fs[static_cast<long>(c0 + i) * PN] : 0.f;
#pragma unroll
      for (int i = 0; i < kPassBatch; ++i) {
        if (c0 + i >= nc) break;
        fs[static_cast<long>(c0 + i) * PN] = st;
        st = dec[c0 + i] * st + own[i];
      }
    }
    return;
  }
  float* rs = p.rstates + bh * nc * PN + el;
  float g = p.dfinal != nullptr ? p.dfinal[bh * PN + el] : 0.f;
  for (int c0 = nc - 1; c0 >= 0; c0 -= kPassBatch) {
    float own[kPassBatch];
#pragma unroll
    for (int i = 0; i < kPassBatch; ++i)
      own[i] = c0 - i >= 0 ? rs[static_cast<long>(c0 - i) * PN] : 0.f;
#pragma unroll
    for (int i = 0; i < kPassBatch; ++i) {
      if (c0 - i < 0) break;
      rs[static_cast<long>(c0 - i) * PN] = g;
      g = dec[c0 - i] * g + own[i];
    }
  }
  if (p.dinit != nullptr) p.dinit[bh * PN + el] = g;
}

// the shared memory of kernel 3, in floats
template <int P, int N>
struct GradSmem {
  static constexpr int kX = kL * P;   // x, dy
  static constexpr int kB = kL * N;   // B, C
  static constexpr int kS = P * N;    // H_c, D_c
  static constexpr int kM = kL * kLdL;  // G E dt, X E dt, G X E
  static constexpr int kVec = 8 * kL + 32;
  static constexpr int kFloats = 2 * kX + 2 * kB + 2 * kS + 3 * kM + kVec;
  static_assert(kFloats * 4 <= 232448, "shared memory");
};

// lanes of a CGN-lane group (consecutive, within a warp) summed in a fixed
// butterfly order; every lane gets the sum
template <int CGN>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = CGN / 2; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 3. the gradients of one chunk
template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_bwd_kernel_chunk_grad(Args p) {
  using M = GradSmem<P, N>;
  extern __shared__ __align__(16) float sm3[];
  float* xs = sm3;
  float* dys = xs + M::kX;
  float* bs = dys + M::kX;
  float* cs = bs + M::kB;
  float* hs = cs + M::kB;    // H_c [P][N]
  float* gs = hs + M::kS;    // D_c [P][N]
  float* m1 = gs + M::kS;    // G_ij E_ij dt_j, j <= i
  float* m2 = m1 + M::kM;    // X_ij E_ij dt_j, j <= i
  float* wq = m2 + M::kM;    // G_ij X_ij E_ij, j <= i
  float* dt_s = wq + M::kM;  // vectors [kL] each
  float* csum = dt_s + kL;
  float* ej = csum + kL;     // exp(csum_L - csum_j)
  float* ei = ej + kL;       // exp(csum_i)
  float* dcs = ei + kL;      // dcsum
  float* ddq = dcs + kL;     // sum_i G X E over i >= j
  float* xdb = ddq + kL;     // x_j^T D_c B_j
  float* rr = xdb + kL;      // exp(csum_i) dy_i^T H_c C_i
  float* red = rr + kL;      // [32]: the block sum of <D_c, H_c>

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int s0 = c * kL;
  const int valid = min(kL, p.S - s0);
  const int g = h / (p.H / p.G);
  const long xrow = static_cast<long>(p.H) * P, grow = static_cast<long>(p.G) * N;
  const long xoff = (static_cast<long>(b) * p.S + s0) * xrow + static_cast<long>(h) * P;
  const long goff = (static_cast<long>(b) * p.S + s0) * grow + static_cast<long>(g) * N;
  stage<T, P>(xs, static_cast<const T*>(p.x) + xoff, xrow, valid);
  stage<T, P>(dys, static_cast<const T*>(p.dy) + xoff, xrow, valid);
  stage<T, N>(bs, static_cast<const T*>(p.bm) + goff, grow, valid);
  stage<T, N>(cs, static_cast<const T*>(p.cm) + goff, grow, valid);
  const long slot = ((static_cast<long>(b) * p.H + h) * p.nc + c) * P * N;
  for (int i = threadIdx.x; i < P * N; i += kThreads) {
    hs[i] = p.fstates[slot + i];
    gs[i] = p.rstates[slot + i];
  }
  stage_steps(dt_s, csum, p, b, h, s0, valid);  // ends with __syncthreads()
  if (threadIdx.x < kL) {
    ej[threadIdx.x] = expf(csum[kL - 1] - csum[threadIdx.x]);
    ei[threadIdx.x] = expf(csum[threadIdx.x]);
  }

  // G = C B^T and X = dy x^T, then the masked, decayed forms
  {
    Tile<kL, kL> tg, tx;
    tg.template mm<N>([&](int i, int n) { return cs[i * N + n]; },
                      [&](int n, int j) { return bs[j * N + n]; });
    tx.template mm<P>([&](int i, int q) { return dys[i * P + q]; },
                      [&](int q, int j) { return xs[j * P + q]; });
    __syncthreads();  // ej, ei
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < Tile<kL, kL>::TC; ++cc) {
        const int i = tg.row(r), j = tg.col(cc);
        const float e = j <= i ? expf(csum[i] - csum[j]) : 0.f;
        m1[i * kLdL + j] = tg.v[r][cc] * e * dt_s[j];
        m2[i * kLdL + j] = tx.v[r][cc] * e * dt_s[j];
        wq[i * kLdL + j] = tg.v[r][cc] * tx.v[r][cc] * e;
      }
  }
  __syncthreads();
  // row and column sums of Q = G X E dt, and ddt's intra-chunk part
  if (threadIdx.x < kL) {
    const int i = threadIdx.x;
    float row = 0.f;
    for (int j = 0; j <= i; ++j) row = fmaf(wq[i * kLdL + j], dt_s[j], row);
    dcs[i] = row;
  } else if (threadIdx.x < 2 * kL) {
    const int j = threadIdx.x - kL;
    float col = 0.f, dd = 0.f;
    for (int i = j; i < kL; ++i) {
      col = fmaf(wq[i * kLdL + j], dt_s[j], col);
      dd += wq[i * kLdL + j];
    }
    ddq[j] = dd;
    xdb[j] = col;  // parked here until the row sums are in
  }
  __syncthreads();
  if (threadIdx.x < kL) dcs[threadIdx.x] -= xdb[threadIdx.x];
  __syncthreads();

  const long xbase = xoff;  // x, dy, dx rows
  const long hbase = (static_cast<long>(b) * p.S + s0) * p.H + h;  // [B, S, H] rows
  // dx_j = sum_i m1_ij dy_i + dt_j e_j D_c B_j; x_j^T D_c B_j on the way
  {
    Tile<kL, P> t1, t2;
    t1.template mm<kL>([&](int j, int i) { return m1[i * kLdL + j]; },
                       [&](int i, int q) { return dys[i * P + q]; });
    t2.template mm<N>([&](int j, int n) { return bs[j * N + n]; },
                      [&](int n, int q) { return gs[q * N + n]; });
    T* dx = static_cast<T*>(p.dx) + xbase;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = t1.row(r);
      float part = 0.f;
#pragma unroll
      for (int cc = 0; cc < Tile<kL, P>::TC; ++cc) {
        const int q = t1.col(cc);
        part = fmaf(xs[j * P + q], t2.v[r][cc], part);
        if (j < valid)
          dx[j * xrow + q] = from_f<T>(t1.v[r][cc] + dt_s[j] * ej[j] * t2.v[r][cc]);
      }
      part = group_sum<Tile<kL, P>::CGN>(part);
      if (t1.cg == 0) xdb[j] = part;
    }
  }
  // dB_j = sum_i m2_ij C_i + dt_j e_j D_c^T x_j (this head's part)
  {
    Tile<kL, N> t1, t2;
    t1.template mm<kL>([&](int j, int i) { return m2[i * kLdL + j]; },
                       [&](int i, int n) { return cs[i * N + n]; });
    t2.template mm<P>([&](int j, int q) { return xs[j * P + q]; },
                      [&](int q, int n) { return gs[q * N + n]; });
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = t1.row(r);
      if (j >= valid) continue;
      float* out = p.db_h + (hbase + static_cast<long>(j) * p.H) * N;
#pragma unroll
      for (int cc = 0; cc < Tile<kL, N>::TC; ++cc)
        out[t1.col(cc)] = t1.v[r][cc] + dt_s[j] * ej[j] * t2.v[r][cc];
    }
  }
  // dC_i = sum_j m2_ij B_j + exp(csum_i) H_c^T dy_i; exp(csum_i) dy_i^T H_c C_i
  {
    Tile<kL, N> t1, t2;
    t1.template mm<kL>([&](int i, int j) { return m2[i * kLdL + j]; },
                       [&](int j, int n) { return bs[j * N + n]; });
    t2.template mm<P>([&](int i, int q) { return dys[i * P + q]; },
                      [&](int q, int n) { return hs[q * N + n]; });
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = t1.row(r);
      float part = 0.f;
      float* out = p.dc_h + (hbase + static_cast<long>(i) * p.H) * N;
#pragma unroll
      for (int cc = 0; cc < Tile<kL, N>::TC; ++cc) {
        const int n = t1.col(cc);
        part = fmaf(cs[i * N + n], t2.v[r][cc], part);
        if (i < valid) out[n] = t1.v[r][cc] + ei[i] * t2.v[r][cc];
      }
      part = group_sum<Tile<kL, N>::CGN>(part);
      if (t1.cg == 0) rr[i] = ei[i] * part;
    }
  }
  // <D_c, H_c>, summed in a fixed order: each thread's strided part, the
  // warp's butterfly, then the warps in order
  {
    float part = 0.f;
    for (int i = threadIdx.x; i < P * N; i += kThreads) part = fmaf(gs[i], hs[i], part);
    part = group_sum<32>(part);
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = part;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float dot = 0.f;
    for (int wv = 0; wv < kThreads / 32; ++wv) dot += red[wv];
    float tsum = 0.f;
    for (int j = 0; j < kL; ++j) {
      const float tj = dt_s[j] * ej[j] * xdb[j];
      tsum += tj;
      dcs[j] += rr[j] - tj;
    }
    dcs[kL - 1] += tsum + ei[kL - 1] * dot;
    // da_j = sum_{i >= j} dcsum_i, from the chunk's end
    float run = 0.f;
    for (int j = kL - 1; j >= 0; --j) {
      run += dcs[j];
      dcs[j] = run;
    }
  }
  __syncthreads();
  if (threadIdx.x < valid) {
    const int j = threadIdx.x;
    p.da[hbase + static_cast<long>(j) * p.H] = dcs[j];
    p.ddt[hbase + static_cast<long>(j) * p.H] = ddq[j] + ej[j] * xdb[j];
  }
}

// 4. dB and dC [B, S, G, N] in T: each group's heads summed in head order
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_kernel_group_sum(const float* __restrict__ part, T* __restrict__ out, long rows,
                             int H, int G, int N) {
  const long n_out = rows * G * N;  // rows = B * S
  const int reps = H / G;
  for (long idx = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x; idx < n_out;
       idx += static_cast<long>(gridDim.x) * kThreads) {
    const int n = static_cast<int>(idx % N);
    const long rest = idx / N;
    const int g = static_cast<int>(rest % G);
    const long row = rest / G;
    float acc = 0.f;
    for (int r = 0; r < reps; ++r) acc += part[(row * H + g * reps + r) * N + n];
    out[idx] = from_f<T>(acc);
  }
}

// ---------------------------------------------------------------------------
// The bf16 route: kernels 1 and 3 on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

using namespace repro_torch::mma;
using bf16 = __nv_bfloat16;
constexpr int kPad = 8;         // bf16 after each shared-memory row: 16 bytes
constexpr int kLdM = kL + kPad;  // the [kL][kLdM] tiles of m1 and m2
// bf16 parts of a float32 operand: three (float32's 24 bits) for the
// chunk states' operands and for H_c and D_c, which reach da; two (about
// 16 bits) for m1 and m2, which reach only dx, dB and dC
constexpr int kStateParts = 3;
constexpr int kMParts = 2;

// rows [0, valid) of a [kL, W] slice (step s at src + s * stride) into a
// [kL][W + kPad] tile by 16-byte cp.async (the caller commits and waits);
// rows past valid are zero
template <int W>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long stride, int valid) {
  constexpr int kRow = W / 8;
  for (int i = threadIdx.x; i < kL * kRow; i += kThreads) {
    const int r = i / kRow, c = (i % kRow) * 8;
    bf16* d = dst + r * (W + kPad) + c;
    if (r < valid)
      cp_async16(d, src + r * stride + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The A (16 x 16 at row m0) or B (16 x 16 at column n0) fragments of a
// bf16 tile at k0, from its storage: A stored [m][k] (kT false) or [k][m]
// (kT true); B stored [n][k] (kT false) or [k][n] (kT true). A B fragment
// holds two n8 tiles: regs 0-1 columns n0..n0+7, regs 2-3 n0+8..n0+15.
template <bool kT>
__device__ __forceinline__ void frag_a(uint32_t (&r)[4], const bf16* a, int ld, int m0, int k0,
                                       int lane) {
  if constexpr (kT)
    ldsm_x4_t(r, a + (k0 + (lane & 7) + 8 * (lane >> 4)) * ld + m0 + 8 * ((lane >> 3) & 1));
  else
    ldsm_x4(r, a + (m0 + (lane & 15)) * ld + k0 + 8 * (lane >> 4));
}

template <bool kT>
__device__ __forceinline__ void frag_b(uint32_t (&r)[4], const bf16* b, int ld, int n0, int k0,
                                       int lane) {
  if constexpr (kT)
    ldsm_x4_t(r, b + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + n0 + 8 * (lane >> 4));
  else
    ldsm_x4(r, b + (n0 + (lane & 7) + 8 * (lane >> 4)) * ld + k0 + 8 * ((lane >> 3) & 1));
}

// acc (a 16 x 16 block at (m0, n0): acc[h][e] at row m0 + g + 8 (e / 2),
// column n0 + 8 h + 2 t + e % 2) += A B over k in [k_lo, k_hi), steps of
// 16. An operand of kPa (kPb) parts is the sum of that many bf16 tiles,
// `pa` (`pb`) elements apart, the high part first: one product per part,
// in that order.
template <bool kAT, bool kBT, int kPa, int kPb>
__device__ __forceinline__ void block_mma(float (&acc)[2][4], const bf16* a, int lda, int pa,
                                          const bf16* b, int ldb, int pb, int m0, int n0,
                                          int k_lo, int k_hi, int lane) {
  static_assert(kPa == 1 || kPb == 1, "at most one operand in parts");
  for (int k0 = k_lo; k0 < k_hi; k0 += 16) {
    uint32_t af[4], bf[4];
    frag_a<kAT>(af, a, lda, m0, k0, lane);
    frag_b<kBT>(bf, b, ldb, n0, k0, lane);
    mma_bf16(acc[0], af, bf[0], bf[1]);
    mma_bf16(acc[1], af, bf[2], bf[3]);
#pragma unroll
    for (int q = 1; q < kPa; ++q) {
      uint32_t aq[4];
      frag_a<kAT>(aq, a + q * pa, lda, m0, k0, lane);
      mma_bf16(acc[0], aq, bf[0], bf[1]);
      mma_bf16(acc[1], aq, bf[2], bf[3]);
    }
#pragma unroll
    for (int q = 1; q < kPb; ++q) {
      uint32_t bq[4];
      frag_b<kBT>(bq, b + q * pb, ldb, n0, k0, lane);
      mma_bf16(acc[0], af, bq[0], bq[1]);
      mma_bf16(acc[1], af, bq[2], bq[3]);
    }
  }
}

// (v0, v1) as kParts bf16 pairs at dst + at, dst + stride + at, ...
template <int kParts>
__device__ __forceinline__ void put_parts(bf16* dst, int stride, int at, float v0, float v1) {
  static_assert(kParts == 2 || kParts == 3, "two or three parts");
  uint32_t hi, mid, lo;
  if constexpr (kParts == 3) {
    split3_bf16(v0, v1, hi, mid, lo);
    *reinterpret_cast<uint32_t*>(dst + 2 * stride + at) = lo;
    lo = mid;
  } else {
    split_bf16(v0, v1, hi, lo);
  }
  *reinterpret_cast<uint32_t*>(dst + at) = hi;
  *reinterpret_cast<uint32_t*>(dst + stride + at) = lo;
}

__device__ __forceinline__ void zero(float (&acc)[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[h][e] = 0.f;
}

// The warp's 16 x 16 blocks of a [kL, W] output in kernel 3: one column
// block, 16 (warp % kNB), and the row blocks 16 (warp / kNB + k kWPC),
// k < kRB (row0 -1 past the chunk), so a B fragment serves them all
template <int W>
struct ColBlocks {
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kNB = W / 16;  // column blocks
  static_assert(kNB <= kWarps && kWarps % kNB == 0, "a column block per warp");
  static constexpr int kWPC = kWarps / kNB;  // warps per column block
  static constexpr int kRB = (kL / 16 + kWPC - 1) / kWPC;  // row blocks a warp
  static __device__ __forceinline__ int row0(int warp, int k) {
    const int rb = warp / kNB + k * kWPC;
    return rb < kL / 16 ? 16 * rb : -1;
  }
};

// acc += A B for one k step: A the 16 x 16 block at (m0, k0) of a tile in
// kParts parts `pa` elements apart (stored [m][k], or [k][m] with kAT), B
// the fragment bq; the high part first
template <bool kAT, int kParts>
__device__ __forceinline__ void mma_parts(float (&acc)[2][4], const bf16* a, int lda, int pa,
                                          const uint32_t (&bq)[4], int m0, int k0, int lane) {
#pragma unroll
  for (int q = 0; q < kParts; ++q) {
    uint32_t af[4];
    frag_a<kAT>(af, a + q * pa, lda, m0, k0, lane);
    mma_bf16(acc[0], af, bq[0], bq[1]);
    mma_bf16(acc[1], af, bq[2], bq[3]);
  }
}

// H_c and D_c, float32 [P][N] at hsrc and dsrc, as kStateParts bf16 tiles
// [P][N + kPad] each (P (N + kPad) elements apart) at hdst and ddst; the
// thread's loads are issued kBatch float4 pairs at a time before they are
// split, so their latencies overlap. Returns this thread's part of
// <D_c, H_c> in a fixed order.
template <int P, int N>
__device__ __forceinline__ float split_states(bf16* hdst, bf16* ddst,
                                              const float* __restrict__ hsrc,
                                              const float* __restrict__ dsrc) {
  constexpr int kVecs = P * N / 4;
  constexpr int kBatch = 4;  // float4 pairs in flight: 32 registers
  float dot = 0.f;
  for (int i0 = threadIdx.x; i0 < kVecs; i0 += kBatch * kThreads) {
    float4 hv[kBatch], dv[kBatch];
#pragma unroll
    for (int it = 0; it < kBatch; ++it) {
      const int i = i0 + it * kThreads;
      if (i < kVecs) {
        hv[it] = __ldg(reinterpret_cast<const float4*>(hsrc) + i);
        dv[it] = __ldg(reinterpret_cast<const float4*>(dsrc) + i);
      }
    }
#pragma unroll
    for (int it = 0; it < kBatch; ++it) {
      const int i = i0 + it * kThreads;
      if (i >= kVecs) continue;
      const int at = (i / (N / 4)) * (N + kPad) + (i % (N / 4)) * 4;
      put_parts<kStateParts>(hdst, P * (N + kPad), at, hv[it].x, hv[it].y);
      put_parts<kStateParts>(hdst, P * (N + kPad), at + 2, hv[it].z, hv[it].w);
      put_parts<kStateParts>(ddst, P * (N + kPad), at, dv[it].x, dv[it].y);
      put_parts<kStateParts>(ddst, P * (N + kPad), at + 2, dv[it].z, dv[it].w);
      dot = fmaf(dv[it].x, hv[it].x,
                 fmaf(dv[it].y, hv[it].y, fmaf(dv[it].z, hv[it].z, fmaf(dv[it].w, hv[it].w, dot))));
    }
  }
  return dot;
}

// dt and the running sum of a over one head's chunk (zeros past valid):
// threads < kL load dt, warp 0 loads a, two steps a lane, and scans it in
// a fixed order. The caller syncs before the results are read.
__device__ __forceinline__ void scan_steps(float* dt_s, float* csum, const Args& p, int b, int h,
                                           int s0, int valid) {
  static_assert(kL == 64, "two steps a lane of one warp");
  const long base = (static_cast<long>(b) * p.S + s0) * p.H + h;
  if (threadIdx.x < kL)
    dt_s[threadIdx.x] =
        static_cast<int>(threadIdx.x) < valid ? p.dt[base + static_cast<long>(threadIdx.x) * p.H]
                                              : 0.f;
  if (threadIdx.x < 32) {
    const int l = threadIdx.x;
    const float a0 = 2 * l < valid ? p.a[base + static_cast<long>(2 * l) * p.H] : 0.f;
    const float a1 = 2 * l + 1 < valid ? p.a[base + static_cast<long>(2 * l + 1) * p.H] : 0.f;
    float incl = a0 + a1;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (l >= off) incl += up;
    }
    float before = __shfl_up_sync(0xffffffffu, incl, 1);
    if (l == 0) before = 0.f;
    csum[2 * l] = before + a0;
    csum[2 * l + 1] = before + a0 + a1;
  }
}

// 1. S_c and R_c (x w and dy e, float32, in kStateParts parts) and the decay
template <int P, int N>
struct StateSmem {
  static constexpr int kLdP = P + kPad, kLdN = N + kPad;
  static constexpr size_t kBytes =
      sizeof(bf16) * (2 * kL * kLdN + (2 + 2 * kStateParts) * kL * kLdP) +
      sizeof(float) * 4 * kL;
  static_assert(kBytes <= 232448, "shared memory");
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_bwd_kernel_mma_chunk_state(Args p) {
  using M = StateSmem<P, N>;
  constexpr int ldp = M::kLdP, ldn = M::kLdN;
  extern __shared__ __align__(16) unsigned char sm1[];
  bf16* bs = reinterpret_cast<bf16*>(sm1);  // [kL][ldn]
  bf16* cs = bs + kL * ldn;
  bf16* xs = cs + kL * ldn;  // [kL][ldp]
  bf16* dys = xs + kL * ldp;
  bf16* us = dys + kL * ldp;  // x w in kStateParts tiles
  bf16* vs = us + kStateParts * kL * ldp;  // dy e
  float* dt_s = reinterpret_cast<float*>(vs + kStateParts * kL * ldp);
  float* csum = dt_s + kL;
  float* w = csum + kL;
  float* e = w + kL;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int s0 = c * kL;
  const int valid = min(kL, p.S - s0);
  const int g = h / (p.H / p.G);
  const long xrow = static_cast<long>(p.H) * P, grow = static_cast<long>(p.G) * N;
  const long xoff = (static_cast<long>(b) * p.S + s0) * xrow + static_cast<long>(h) * P;
  const long goff = (static_cast<long>(b) * p.S + s0) * grow + static_cast<long>(g) * N;
  stage_rows<P>(xs, static_cast<const bf16*>(p.x) + xoff, xrow, valid);
  stage_rows<P>(dys, static_cast<const bf16*>(p.dy) + xoff, xrow, valid);
  stage_rows<N>(bs, static_cast<const bf16*>(p.bm) + goff, grow, valid);
  stage_rows<N>(cs, static_cast<const bf16*>(p.cm) + goff, grow, valid);
  cp_async_commit();
  scan_steps(dt_s, csum, p, b, h, s0, valid);
  __syncthreads();
  if (threadIdx.x < kL) {
    w[threadIdx.x] = expf(csum[kL - 1] - csum[threadIdx.x]) * dt_s[threadIdx.x];
    e[threadIdx.x] = expf(csum[threadIdx.x]);
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = threadIdx.x; i < kL * P / 2; i += kThreads) {
    const int j = i / (P / 2), q = (i % (P / 2)) * 2;
    const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + j * ldp + q));
    const float2 yv =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dys + j * ldp + q));
    put_parts<kStateParts>(us, kL * ldp, j * ldp + q, xv.x * w[j], xv.y * w[j]);
    put_parts<kStateParts>(vs, kL * ldp, j * ldp + q, yv.x * e[j], yv.y * e[j]);
  }
  __syncthreads();

  // [P, N] = (x w)^T B and (dy e)^T C in 16 x 16 blocks, round robin
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  constexpr int kBlocks = (P / 16) * (N / 16);
  const long slot = ((static_cast<long>(b) * p.H + h) * p.nc + c) * P * N;
  for (int blk = warp; blk < kBlocks; blk += kThreads / 32) {
    const int p0 = (blk / (N / 16)) * 16, n0 = (blk % (N / 16)) * 16;
    float fa[2][4], ra[2][4];
    zero(fa);
    zero(ra);
    block_mma<true, true, kStateParts, 1>(fa, us, ldp, kL * ldp, bs, ldn, 0, p0, n0, 0, kL, lane);
    block_mma<true, true, kStateParts, 1>(ra, vs, ldp, kL * ldp, cs, ldn, 0, p0, n0, 0, kL, lane);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const long at = slot + static_cast<long>(p0 + gq + 8 * rr) * N + n0 + 8 * hh + 2 * tq;
        *reinterpret_cast<float2*>(p.fstates + at) = make_float2(fa[hh][2 * rr], fa[hh][2 * rr + 1]);
        *reinterpret_cast<float2*>(p.rstates + at) = make_float2(ra[hh][2 * rr], ra[hh][2 * rr + 1]);
      }
    }
  }
  if (threadIdx.x == 0) p.decay[(static_cast<long>(b) * p.H + h) * p.nc + c] = expf(csum[kL - 1]);
}

// the shared memory of kernel 3
template <int P, int N>
struct GradSmem {
  static constexpr int kLdP = P + kPad, kLdN = N + kPad;
  static constexpr int kQ = kL / 16;  // 16-row blocks of a chunk
  static constexpr int kParts = (P > N ? P : N) / 16;  // column blocks of a row sum
  static constexpr size_t kTiles =
      sizeof(bf16) * (2 * kL * kLdN + 2 * kL * kLdP + 2 * kStateParts * P * kLdN +
                      2 * kMParts * kL * kLdM);
  static constexpr size_t kFloats = 8 * kL + 32 + 3 * kQ * kL + 2 * kParts * kL;
  static constexpr size_t kBytes = kTiles + sizeof(float) * kFloats;
  static_assert(kTiles % 16 == 0, "alignment");
  static_assert(kBytes <= 232448, "shared memory");
};

// 3. the gradients of one chunk for the heads of one group, in head order:
// B, C and G = C B^T once, then per head the products on the tensor cores
// and the scalar sums (dcsum, da's reverse running sum, ddt); dB and dC
// summed over the heads in registers and written once, so the bf16 route
// needs neither per-head scratch nor kernel 4.
template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_kernel_mma_chunk_grad(Args p) {
  using M = GradSmem<P, N>;
  constexpr int ldp = M::kLdP, ldn = M::kLdN, kQ = M::kQ;
  constexpr int kSP = P * ldn, kMP = kL * kLdM;  // elements from one part to the next
  constexpr int kWarps = kThreads / 32;
  static_assert(kQ * kQ == 2 * kWarps, "two 16 x 16 blocks of G a warp");
  extern __shared__ __align__(16) unsigned char sm3[];
  bf16* bs = reinterpret_cast<bf16*>(sm3);  // [kL][ldn]
  bf16* cs = bs + kL * ldn;
  bf16* xs = cs + kL * ldn;  // [kL][ldp]
  bf16* dys = xs + kL * ldp;
  bf16* hs = dys + kL * ldp;  // H_c [P][ldn] in kStateParts tiles
  bf16* gs = hs + kStateParts * kSP;  // D_c
  bf16* m1 = gs + kStateParts * kSP;  // [kL][kLdM] G_ij E_ij dt_j in kMParts tiles
  bf16* m2 = m1 + kMParts * kMP;  // X_ij E_ij dt_j
  float* dt_s = reinterpret_cast<float*>(sm3 + M::kTiles);  // vectors [kL] each
  float* csum = dt_s + kL;
  float* ej = csum + kL;   // exp(csum_L - csum_j)
  float* ei = ej + kL;     // exp(csum_i)
  float* dcs = ei + kL;    // dcsum's intra-chunk part
  float* ddq = dcs + kL;   // sum_i G X E over i >= j
  float* xdb = ddq + kL;   // x_j^T D_c B_j
  float* rr = xdb + kL;    // exp(csum_i) dy_i^T H_c C_i
  float* red = rr + kL;    // [32]: the warps' parts of <D_c, H_c>
  float* rowq = red + 32;  // [kQ][kL]: row sums of Q = G X E dt by 16-column block
  float* colq = rowq + kQ * kL;  // [kQ][kL]: column sums of Q by 16-row block
  float* colw = colq + kQ * kL;  // [kQ][kL]: column sums of G X E by 16-row block
  float* xdb_part = colw + kQ * kL;  // [kParts][kL]
  float* rr_part = xdb_part + M::kParts * kL;  // [kParts][kL]

  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int s0 = c * kL;
  const int valid = min(kL, p.S - s0);
  const int reps = p.H / p.G;
  const long xrow = static_cast<long>(p.H) * P, grow = static_cast<long>(p.G) * N;
  const long goff = (static_cast<long>(b) * p.S + s0) * grow + static_cast<long>(g) * N;
  stage_rows<N>(bs, static_cast<const bf16*>(p.bm) + goff, grow, valid);
  stage_rows<N>(cs, static_cast<const bf16*>(p.cm) + goff, grow, valid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  // G = C B^T, once for the group's heads: the warp's blocks warp + 8 m
  // (row block (warp + 8 m) / kQ, column block (warp + 8 m) % kQ), those
  // on or below the diagonal
  float gr[2][2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int blk = warp + kWarps * m;
    const int i0 = (blk / kQ) * 16, j0 = (blk % kQ) * 16;
    zero(gr[m]);
    if (j0 <= i0) block_mma<false, false, 1, 1>(gr[m], cs, ldn, 0, bs, ldn, 0, i0, j0, 0, N, lane);
  }
  // dB and dC of the warp's 16 x 16 blocks (ColBlocks), summed over the heads
  using CN = ColBlocks<N>;
  float db[CN::kRB][2][4], dc[CN::kRB][2][4];
#pragma unroll
  for (int k = 0; k < CN::kRB; ++k) {
    zero(db[k]);
    zero(dc[k]);
  }

  for (int r = 0; r < reps; ++r) {
    const int h = g * reps + r;
    const long xoff = (static_cast<long>(b) * p.S + s0) * xrow + static_cast<long>(h) * P;
    stage_rows<P>(xs, static_cast<const bf16*>(p.x) + xoff, xrow, valid);
    stage_rows<P>(dys, static_cast<const bf16*>(p.dy) + xoff, xrow, valid);
    cp_async_commit();
    const long slot = ((static_cast<long>(b) * p.H + h) * p.nc + c) * P * N;
    {
      // <D_c, H_c>, summed in a fixed order: each thread's strided part, the
      // warp's butterfly, then the warps in order (in the tail below)
      float part = split_states<P, N>(hs, gs, p.fstates + slot, p.rstates + slot);
      part = group_sum<32>(part);
      if (lane == 0) red[warp] = part;
    }
    scan_steps(dt_s, csum, p, b, h, s0, valid);
    cp_async_wait<0>();
    __syncthreads();
    if (threadIdx.x < kL) {
      ej[threadIdx.x] = expf(csum[kL - 1] - csum[threadIdx.x]);
      ei[threadIdx.x] = expf(csum[threadIdx.x]);
    }

    // X = dy x^T, then m1 = G E dt and m2 = X E dt (in parts) and the row
    // and column sums of Q = G X E dt and of G X E, by block
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int blk = warp + kWarps * m;
      const int i0 = (blk / kQ) * 16, j0 = (blk % kQ) * 16;
      if (j0 > i0) {  // above the diagonal: never read as an operand, sums 0
        if (lane < 16) {
          rowq[(j0 / 16) * kL + i0 + lane] = 0.f;
          colq[(i0 / 16) * kL + j0 + lane] = 0.f;
          colw[(i0 / 16) * kL + j0 + lane] = 0.f;
        }
        continue;
      }
      float xa[2][4];
      zero(xa);
      block_mma<false, false, 1, 1>(xa, dys, ldp, 0, xs, ldp, 0, i0, j0, 0, P, lane);
      float rq[2] = {0.f, 0.f};
      float cq[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, cw[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          const int i = i0 + gq + 8 * r2;
          const int j = j0 + 8 * hf + 2 * tq;
          float v1[2], v2[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float gv = gr[m][hf][2 * r2 + q], xv = xa[hf][2 * r2 + q];
            const float ee = j + q <= i ? expf(csum[i] - csum[j + q]) : 0.f;
            const float w = gv * xv * ee;
            const float qv = w * dt_s[j + q];
            v1[q] = gv * ee * dt_s[j + q];
            v2[q] = xv * ee * dt_s[j + q];
            rq[r2] += qv;
            cq[hf][q] += qv;
            cw[hf][q] += w;
          }
          put_parts<kMParts>(m1, kMP, i * kLdM + j, v1[0], v1[1]);
          put_parts<kMParts>(m2, kMP, i * kLdM + j, v2[0], v2[1]);
        }
      }
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        rq[r2] += __shfl_xor_sync(0xffffffffu, rq[r2], 1);
        rq[r2] += __shfl_xor_sync(0xffffffffu, rq[r2], 2);
      }
      if (tq == 0) {
        rowq[(j0 / 16) * kL + i0 + gq] = rq[0];
        rowq[(j0 / 16) * kL + i0 + gq + 8] = rq[1];
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
#pragma unroll
          for (int off = 4; off < 32; off *= 2) {
            cq[hf][q] += __shfl_xor_sync(0xffffffffu, cq[hf][q], off);
            cw[hf][q] += __shfl_xor_sync(0xffffffffu, cw[hf][q], off);
          }
          if (gq == 0) {
            colq[(i0 / 16) * kL + j0 + 8 * hf + 2 * tq + q] = cq[hf][q];
            colw[(i0 / 16) * kL + j0 + 8 * hf + 2 * tq + q] = cw[hf][q];
          }
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < kL) {  // the blocks' sums in block order
      const int i = threadIdx.x;
      float row = 0.f, col = 0.f, dd = 0.f;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        row += rowq[q * kL + i];
        col += colq[q * kL + i];
        dd += colw[q * kL + i];
      }
      dcs[i] = row - col;
      ddq[i] = dd;
    }

    const long hbase = (static_cast<long>(b) * p.S + s0) * p.H + h;  // [B, S, H] rows
    // dx_j = sum_i m1_ij dy_i + dt_j e_j (D_c B_j) (D_c in two parts: dx
    // only). A warp takes one 16-column block and its row blocks, so each
    // B fragment is read once for them all.
    {
      using CP = ColBlocks<P>;
      bf16* dx = static_cast<bf16*>(p.dx) + xoff;
      const int q0 = 16 * (warp % CP::kNB);
      float t1[CP::kRB][2][4], u[CP::kRB][2][4];
#pragma unroll
      for (int k = 0; k < CP::kRB; ++k) {
        zero(t1[k]);
        zero(u[k]);
      }
      for (int k0 = 0; k0 < kL; k0 += 16) {  // over i, from each row block's own j0
        uint32_t bq[4];
        frag_b<true>(bq, dys, ldp, q0, k0, lane);
#pragma unroll
        for (int k = 0; k < CP::kRB; ++k) {
          const int j0 = CP::row0(warp, k);
          if (j0 < 0 || k0 < j0) continue;
          mma_parts<true, kMParts>(t1[k], m1, kLdM, kMP, bq, j0, k0, lane);
        }
      }
      for (int k0 = 0; k0 < N; k0 += 16) {
        uint32_t bq[2][4];
#pragma unroll
        for (int q = 0; q < 2; ++q) frag_b<false>(bq[q], gs + q * kSP, ldn, q0, k0, lane);
#pragma unroll
        for (int k = 0; k < CP::kRB; ++k) {
          const int j0 = CP::row0(warp, k);
          if (j0 < 0) continue;
          uint32_t af[4];
          frag_a<false>(af, bs, ldn, j0, k0, lane);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            mma_bf16(u[k][0], af, bq[q][0], bq[q][1]);
            mma_bf16(u[k][1], af, bq[q][2], bq[q][3]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < CP::kRB; ++k) {
        const int j0 = CP::row0(warp, k);
        if (j0 < 0) continue;
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          const int j = j0 + gq + 8 * r2;
          if (j >= valid) continue;
          const float f = dt_s[j] * ej[j];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<__nv_bfloat162*>(dx + j * xrow + q0 + 8 * hf + 2 * tq) =
                __floats2bfloat162_rn(t1[k][hf][2 * r2] + f * u[k][hf][2 * r2],
                                      t1[k][hf][2 * r2 + 1] + f * u[k][hf][2 * r2 + 1]);
        }
      }
    }
    // dB_j += sum_i m2_ij C_i + dt_j e_j D_c^T x_j, and x_j^T D_c B_j =
    // B_j . (D_c^T x_j); dC_i += sum_j m2_ij B_j + exp(csum_i) H_c^T dy_i,
    // and C_i . (H_c^T dy_i); the m2 products accumulate straight into dB
    // and dC, the state products (D_c, H_c in three parts) into t2
    {
      const int n0 = 16 * (warp % CN::kNB);
      float t2[CN::kRB][2][4];
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {  // 0: dB (rows j), 1: dC (rows i)
        const bf16* st = pass == 0 ? gs : hs;  // D_c, H_c
        const bf16* ain = pass == 0 ? xs : dys;
        const bf16* bin = pass == 0 ? cs : bs;
        float* part_out = pass == 0 ? xdb_part : rr_part;
        const bf16* rowv = pass == 0 ? bs : cs;  // B_j or C_i for the row sums
#pragma unroll
        for (int k = 0; k < CN::kRB; ++k) zero(t2[k]);
        for (int k0 = 0; k0 < kL; k0 += 16) {
          uint32_t bq[4];
          frag_b<true>(bq, bin, ldn, n0, k0, lane);
#pragma unroll
          for (int k = 0; k < CN::kRB; ++k) {
            const int r0 = CN::row0(warp, k);
            if (r0 < 0) continue;
            if (pass == 0) {  // m2^T C over i >= j
              if (k0 >= r0) mma_parts<true, kMParts>(db[k], m2, kLdM, kMP, bq, r0, k0, lane);
            } else {  // m2 B over j <= i
              if (k0 <= r0) mma_parts<false, kMParts>(dc[k], m2, kLdM, kMP, bq, r0, k0, lane);
            }
          }
        }
        for (int k0 = 0; k0 < P; k0 += 16) {
          uint32_t bq[kStateParts][4];
#pragma unroll
          for (int q = 0; q < kStateParts; ++q) frag_b<true>(bq[q], st + q * kSP, ldn, n0, k0, lane);
#pragma unroll
          for (int k = 0; k < CN::kRB; ++k) {
            const int r0 = CN::row0(warp, k);
            if (r0 < 0) continue;
            uint32_t af[4];
            frag_a<false>(af, ain, ldp, r0, k0, lane);
#pragma unroll
            for (int q = 0; q < kStateParts; ++q) {
              mma_bf16(t2[k][0], af, bq[q][0], bq[q][1]);
              mma_bf16(t2[k][1], af, bq[q][2], bq[q][3]);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < CN::kRB; ++k) {
          const int r0 = CN::row0(warp, k);
          if (r0 < 0) continue;
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2) {
            const int i = r0 + gq + 8 * r2;
            const float f = pass == 0 ? dt_s[i] * ej[i] : ei[i];
            float part = 0.f;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const float2 rv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                  rowv + i * ldn + n0 + 8 * hf + 2 * tq));
              part = fmaf(rv.x, t2[k][hf][2 * r2], part);
              part = fmaf(rv.y, t2[k][hf][2 * r2 + 1], part);
              if (pass == 0) {
                db[k][hf][2 * r2] += f * t2[k][hf][2 * r2];
                db[k][hf][2 * r2 + 1] += f * t2[k][hf][2 * r2 + 1];
              } else {
                dc[k][hf][2 * r2] += f * t2[k][hf][2 * r2];
                dc[k][hf][2 * r2 + 1] += f * t2[k][hf][2 * r2 + 1];
              }
            }
            part += __shfl_xor_sync(0xffffffffu, part, 1);
            part += __shfl_xor_sync(0xffffffffu, part, 2);
            if (tq == 0) part_out[(n0 / 16) * kL + i] = part;
          }
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < kL) {  // the row sums' column blocks in order
      const int j = threadIdx.x;
      float xs_sum = 0.f, rs_sum = 0.f;
      for (int q = 0; q < N / 16; ++q) xs_sum += xdb_part[q * kL + j];
      for (int q = 0; q < N / 16; ++q) rs_sum += rr_part[q * kL + j];
      xdb[j] = xs_sum;
      rr[j] = ei[j] * rs_sum;
    }
    __syncthreads();
    if (warp == 0) {
      // dcsum's other terms, then da_j = sum_{i >= j} dcsum_i: lane l holds
      // steps 2 l and 2 l + 1; the sums run in a fixed butterfly / scan order
      float dot = 0.f;
      for (int wv = 0; wv < kWarps; ++wv) dot += red[wv];
      const int j0 = 2 * lane, j1 = j0 + 1;
      const float t0 = dt_s[j0] * ej[j0] * xdb[j0], t1 = dt_s[j1] * ej[j1] * xdb[j1];
      float d0 = dcs[j0] + (rr[j0] - t0), d1 = dcs[j1] + (rr[j1] - t1);
      const float tsum = group_sum<32>(t0 + t1);
      if (lane == 31) d1 += tsum + ei[kL - 1] * dot;
      float incl = d0 + d1;  // this pair and every later one
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float dn = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += dn;
      }
      float after = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) after = 0.f;
      const float da1 = d1 + after, da0 = d0 + da1;
      if (j0 < valid) {
        p.da[hbase + static_cast<long>(j0) * p.H] = da0;
        p.ddt[hbase + static_cast<long>(j0) * p.H] = ddq[j0] + ej[j0] * xdb[j0];
      }
      if (j1 < valid) {
        p.da[hbase + static_cast<long>(j1) * p.H] = da1;
        p.ddt[hbase + static_cast<long>(j1) * p.H] = ddq[j1] + ej[j1] * xdb[j1];
      }
    }
    __syncthreads();  // the next head writes the tiles and vectors
  }

  // dB and dC of the group, summed over its heads, rounded once
  bf16* dbo = static_cast<bf16*>(p.db) + goff;
  bf16* dco = static_cast<bf16*>(p.dc) + goff;
  const int n0 = 16 * (warp % CN::kNB);
#pragma unroll
  for (int k = 0; k < CN::kRB; ++k) {
    const int r0 = CN::row0(warp, k);
    if (r0 < 0) continue;
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const int j = r0 + gq + 8 * r2;
      if (j >= valid) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const long at = j * grow + n0 + 8 * hf + 2 * tq;
        *reinterpret_cast<__nv_bfloat162*>(dbo + at) =
            __floats2bfloat162_rn(db[k][hf][2 * r2], db[k][hf][2 * r2 + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dco + at) =
            __floats2bfloat162_rn(dc[k][hf][2 * r2], dc[k][hf][2 * r2 + 1]);
      }
    }
  }
}

}  // namespace tc

// Raises a kernel's dynamic shared-memory cap once per device (a launch
// inside a CUDA-graph capture then only enqueues).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done & (1u << dev))) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

// Kernels 1-4 on `stream`: kernels 1 and 3 by dtype (bf16 tc::, float32
// the scalar ones)
template <typename T, int P, int N>
int launch(const Args& a, cudaStream_t stream) {
  static unsigned state_set = 0, grad_set = 0;
  const dim3 grid(a.nc, a.H, a.B);
  cudaError_t err;
  size_t smem3;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    err = allow_smem(tc::ssd_bwd_kernel_mma_chunk_state<P, N>, tc::StateSmem<P, N>::kBytes,
                     state_set);
    if (err == cudaSuccess)
      err = allow_smem(tc::ssd_bwd_kernel_mma_chunk_grad<P, N>, tc::GradSmem<P, N>::kBytes,
                       grad_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    tc::ssd_bwd_kernel_mma_chunk_state<P, N>
        <<<grid, kThreads, tc::StateSmem<P, N>::kBytes, stream>>>(a);
    smem3 = tc::GradSmem<P, N>::kBytes;
  } else {
    const size_t smem1 = sizeof(float) * (2 * kL * P + 2 * kL * N + 4 * kL);
    smem3 = sizeof(float) * GradSmem<P, N>::kFloats;
    err = allow_smem(ssd_bwd_kernel_chunk_state<T, P, N>, smem1, state_set);
    if (err == cudaSuccess) err = allow_smem(ssd_bwd_kernel_chunk_grad<T, P, N>, smem3, grad_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_bwd_kernel_chunk_state<T, P, N><<<grid, kThreads, smem1, stream>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2(2 * ((P * N + kThreads - 1) / kThreads), a.H, a.B);
  ssd_bwd_kernel_state_pass<<<grid2, kThreads, 0, stream>>>(a, P * N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // one block per (chunk, group, batch), its heads in order; writes dB
    // and dC itself: no kernel 4
    tc::ssd_bwd_kernel_mma_chunk_grad<P, N><<<dim3(a.nc, a.G, a.B), kThreads, smem3, stream>>>(a);
  } else {
    ssd_bwd_kernel_chunk_grad<T, P, N><<<grid, kThreads, smem3, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long rows = static_cast<long>(a.B) * a.S;
    const int blocks = 132 * 8;
    ssd_bwd_kernel_group_sum<T><<<blocks, kThreads, 0, stream>>>(
        a.db_h, static_cast<T*>(a.db), rows, a.H, a.G, N);
    ssd_bwd_kernel_group_sum<T><<<blocks, kThreads, 0, stream>>>(
        a.dc_h, static_cast<T*>(a.dc), rows, a.H, a.G, N);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int dispatch_n(int N, const Args& a, cudaStream_t s) {
  if (N == 32) return launch<T, P, 32>(a, s);
  if (N == 64) return launch<T, P, 64>(a, s);
  if (N == 128) return launch<T, P, 128>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_p(int P, int N, const Args& a, cudaStream_t s) {
  if (P == 16) return dispatch_n<T, 16>(N, a, s);
  if (P == 32) return dispatch_n<T, 32>(N, a, s);
  if (P == 64) return dispatch_n<T, 64>(N, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The backward's own chunk length (scratch is sized by it).
extern "C" int ssd_scan_backward_chunk() { return kL; }

// x and dy [B, S, H, P] contiguous in one dtype (0 float32, 1 bfloat16);
// a = dt * A and dt [B, S, H] float32 contiguous; B and C [B, S, G, N]
// contiguous in x's dtype; init and dfinal [B, H, P, N] float32 or null
// (zeros). Outputs: dx like x, ddt and da [B, S, H] float32 (da the
// gradient with respect to a; dt's here is its direct part only), dB and
// dC like B and C, dinit [B, H, P, N] float32 or null (not wanted).
// Scratch, float32: fstates and rstates [B, H, nc, P, N], decay [B, H,
// nc], nc = ceil(S / ssd_scan_backward_chunk()); and for float32 only
// (bf16 ignores them) db_h and dc_h [B, S, H, N]. P in {16, 32, 64}, N in
// {32, 64, 128}, G divides H. Runs the kernels on `stream` (four for
// float32, three for bf16); returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for a shape or dtype it does not take).
extern "C" int ssd_scan_backward(const void* x, const float* dt, const float* a, const void* bm,
                                 const void* cm, const float* init, const void* dy,
                                 const float* dfinal, void* dx, float* ddt, float* da, void* db,
                                 void* dc, float* dinit, float* fstates, float* rstates,
                                 float* decay, float* db_h, float* dc_h, int B, int S, int H,
                                 int G, int P, int N, int dtype, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (G <= 0 || H % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S == 0) {  // no steps: the initial state's gradient is the final one's
    if (dinit == nullptr) return 0;
    const size_t bytes = sizeof(float) * B * H * P * N;
    return static_cast<int>(dfinal != nullptr
                                ? cudaMemcpyAsync(dinit, dfinal, bytes, cudaMemcpyDeviceToDevice, s)
                                : cudaMemsetAsync(dinit, 0, bytes, s));
  }
  const Args r{x,     dt,    a,     bm,      cm,      init,  dy,   dfinal, dx, ddt,
               da,    db,    dc,    dinit,   fstates, rstates, decay, db_h, dc_h,
               B,     S,     H,     G,       (S + kL - 1) / kL};
  if (dtype == 0) return dispatch_p<float>(P, N, r, s);
  if (dtype == 1) return dispatch_p<__nv_bfloat16>(P, N, r, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
