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
// whatever the forward's), csum the running sum of a within a chunk, H_c
// the state entering chunk c and D_c the gradient arriving at its end
// (from the later chunks and the final state). Four kernels in stream
// order, no atomics, every sum in a fixed order, so two runs give the same
// bits:
//
//   1. ssd_bwd_kernel_chunk_state, one block per (chunk, head, batch):
//      the chunk's own forward state S_c = sum_j exp(csum_L - csum_j) dt_j
//      x_j (x) B_j, its reverse state R_c = sum_i exp(csum_i) dy_i (x) C_i,
//      and its decay exp(csum_L), into float32 scratch.
//   2. ssd_bwd_kernel_state_pass, two threads per (state element, head,
//      batch): one H_c = decay_c H_{c-1} + S_c in chunk order from the
//      initial state, the other D_{c-1} = decay_c D_c + R_c in reverse
//      order from the final state's gradient, each written over its
//      chunk's slot, eight chunks' loads issued together; the initial
//      state's gradient is D_{-1}.
//   3. ssd_bwd_kernel_chunk_grad, one block per (chunk, head, batch): with
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
//      dB and dC are written per head into float32 scratch.
//   4. ssd_bwd_kernel_group_sum: dB and dC of each group, the sum over its
//      heads in head order, rounded once to the input dtype.
//
// The exponents are always differences csum_i - csum_j with i >= j (or
// csum_L - csum_j), so <= 0: nothing overflows. A ragged tail is padded
// inside the kernels with zeros (a = dt = 0 there), which leaves every
// sum as it was; its rows are not written.
//
// Units: float32 FMAs on the CUDA cores (SIMT), every operand staged in
// shared memory as float32 (bf16 inputs converted once), each thread a
// 4-row tile of each product. A simple kernel first: the tensor cores are a
// later PR's.
//
// What bounds it on this card: bytes. At the mamba2-130m training step (B 4,
// S 2048, H 24, P 64, G 1, N 128, bf16) the function reads x, dy, B, C, a,
// dt once and writes dx, dB, dC, da, ddt once: about 87 MB, 26 us at 3.35
// TB/s. The float32 chunk states and per-head dB, dC add 4 x 100 MB of
// scratch traffic, and the SIMT products are far from the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T, int P, int N>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem1 = sizeof(float) * (2 * kL * P + 2 * kL * N + 4 * kL);
  const size_t smem3 = sizeof(float) * GradSmem<P, N>::kFloats;
  // once per device: a launch inside a CUDA-graph capture then only enqueues
  static unsigned attr_set = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32 || !(attr_set & (1u << dev))) {
    err = cudaFuncSetAttribute(ssd_bwd_kernel_chunk_state<T, P, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem1));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_bwd_kernel_chunk_grad<T, P, N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem3));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 32) attr_set |= 1u << dev;
  }
  const dim3 grid(a.nc, a.H, a.B);
  ssd_bwd_kernel_chunk_state<T, P, N><<<grid, kThreads, smem1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2(2 * ((P * N + kThreads - 1) / kThreads), a.H, a.B);
  ssd_bwd_kernel_state_pass<<<grid2, kThreads, 0, stream>>>(a, P * N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_kernel_chunk_grad<T, P, N><<<grid, kThreads, smem3, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long rows = static_cast<long>(a.B) * a.S;
  const int blocks = 132 * 8;
  ssd_bwd_kernel_group_sum<T><<<blocks, kThreads, 0, stream>>>(a.db_h, static_cast<T*>(a.db), rows,
                                                             a.H, a.G, N);
  ssd_bwd_kernel_group_sum<T><<<blocks, kThreads, 0, stream>>>(a.dc_h, static_cast<T*>(a.dc), rows,
                                                             a.H, a.G, N);
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
// nc], db_h and dc_h [B, S, H, N], nc = ceil(S / ssd_scan_backward_chunk()).
// P in {16, 32, 64}, N in {32, 64, 128}, G divides H. Runs the four
// kernels on `stream`; returns cudaGetLastError() after the launches
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
