// Mamba-2 SSD scan for Hopper (sm_90a): y and the final state of
//
//   state_s = exp(a_s) * state_{s-1} + dt_s * x_s (x) B_s     [P, N] per head
//   y_s     = state_s . C_s
//
// from an optional initial state, for every (batch, head) in one call.
//
// Replaces `repro/kernels/ssd_scan.py::ssd_scan_pallas` (:65, `pallas_call`
// at :87), and serves as the port's `ssd_chunked_jnp`
// (`repro/models/transformer/ssm.py:33`): the same function, which the
// Mamba-2 prefill runs with the cache's state as the initial state.
//
// Design: the chunked SSD of Dao & Gu (arXiv:2405.21060), as the TPU kernel
// computes it, but parallel over chunks: B x H x S / L tiles where the TPU
// grid walks the chunks in order. L is the kernels' own chunk length
// (kChunkBf16 / kChunkF32 below); the caller's `chunk` is the plain
// version's and does not change the math. With csum the running sum of a
// within a chunk (float32, one fixed-order warp scan, the same bits in
// kernels 1 and 3), three kernels run in stream order:
//
//   1. ssd_scan_kernel_chunk_state, one block per (batch, chunk, up to
//      kMaxHeads heads of one group): each chunk's own state
//      S_c = (x . w)^T B with w_j = exp(csum_L - csum_j) dt_j, staged in
//      shared memory and written whole rows at a time into float32
//      scratch [B, H, S / L, P, N], and the chunk's decay exp(csum_L).
//   2. ssd_scan_kernel_state_pass, one block per (batch, head, 512 state
//      elements): H_c = exp(csum_L,c) H_{c-1} + S_c in float32, in chunk
//      order, all of a thread's loads issued together; slot c is
//      overwritten with the state entering chunk c, and the final state
//      written. The only serial part left: S / L steps.
//   3. ssd_scan_kernel_chunk_out, one block per (batch, chunk, up to
//      kMaxHeads heads): G = C B^T [L, L] once for the heads of the block
//      (they share the group's B and C); then per head
//      y = diag(exp(csum)) C H_{c-1}^T + M x with
//      M_ij = G_ij exp(csum_i - csum_j) dt_j for j <= i. The exponent is
//      never split as exp(csum_i) exp(-csum_j), which overflows: on the
//      diagonal 16 x 16 block it is taken per pair, and left of it as
//      exp(csum_i - csum_e) exp(csum_e - csum_j) with e the block's last
//      step, i > e >= j, so both exponents are <= 0 (a <= 0).
//
// Kernel 1 and 3 load the next head's tiles while this head computes. In
// kernel 3 two warps share 16 rows: the even one takes M's even 16-column
// blocks and the first half of N for C H^T, the odd one the rest, so the
// causal work of the longest rows is split in two; the pair adds its two
// sums in a fixed order. The separate state pass was measured against
// handing H_c from chunk to chunk inside kernel 1 behind flags (tiles
// taken by ticket): 0.2169 vs 0.2097 ms (PERF.md), a 3% gain for spin
// waits, tickets and zeroed flags, so the pass stays a kernel of its own.
// No float atomics anywhere: each sum runs in a fixed order, and two runs
// give the same bits.
//
// Units. bfloat16: every product runs on the tensor cores as
// `mma.sync.m16n8k16` (bf16 in, float32 accumulators), operands loaded with
// `ldmatrix` (`.trans` where a tile is stored the other way round) from
// shared-memory rows padded by 16 bytes, which keeps them free of bank
// conflicts. `mma.sync` and not `wgmma`: a warp's products are 16 rows
// wide and cut at the causal diagonal, which 64-row warpgroup tiles would
// not follow. The places the bf16 path leaves float32 for an MMA operand:
//   - x . w (kernel 1) is split into a bf16 high part and the bf16 of the
//     remainder, two products, so S_c and the final state keep about 16
//     bits: the final state is held at float32's 1e-4;
//   - H_{c-1} (C H^T, kernel 3), split the same way;
//   - M (M x, kernel 3), split the same way. With M and H each rounded
//     once, y missed its 1e-2 tolerance by up to 0.5 where long-memory
//     heads sum many large terms that cancel (PERF.md).
// x, B and C are bf16 inputs and enter exactly; G, the carried states H and
// every accumulator stay float32. float32 inputs run the same algorithm
// with scalar FMAs at L = 64 (float32 tiles of 128 would not fit shared
// memory), in the same fragment layout; no TF32.
//
// Tiles are staged with 16-byte `cp.async` when every pointer and stride is
// 16-byte aligned (else element loads); rows past S (the ragged tail) are
// zero, which gives a = 0 and dt = 0 there and leaves the state as it was.
// No padding copies. TMA bulk copies (a row each, on mbarriers) measured no
// faster in kernel 3's bf16 build (0.0867 against 0.0840 ms; PERF.md).
//
// What bounds it on this card: bytes, of which the float32 chunk states
// are most. At the mamba2-130m prefill (B 4, S 2048, H 24, P 64, N 128,
// bf16) the function's own bytes (x, B, C, a, dt, y and the states once)
// are 62 MB, 19 us at 3.35 TB/s; the chunk states add 4 x 50 MB at
// L = 128 (written, read and rewritten by the pass, read by kernel 3).
// The products are about 10 GFLOP, twice that with the splits. Measured
// times and the L sweep (tools/ssd_sweep.py) are in PERF.md.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

// The bf16 kernels' chunk length L (64 or 128), chosen by
// tools/ssd_sweep.py (PERF.md); -DREPRO_SSD_CHUNK=<L> builds another, for
// that sweep.
#ifndef REPRO_SSD_CHUNK
#define REPRO_SSD_CHUNK 128
#endif

namespace {

constexpr int kChunkBf16 = REPRO_SSD_CHUNK;
constexpr int kChunkF32 = 64;  // float32 tiles at 128 would not fit shared memory
// Most heads of one group that a block of kernels 1 and 3 takes (G is
// computed once for them): the largest power of two up to this that
// divides H / G. 4 beat 2 and 8 at the mamba2-130m prefill (PERF.md).
constexpr int kMaxHeads = 4;
constexpr int kPad = 8;  // elements of padding after each shared-memory row
constexpr int kPassThreads = 128;
constexpr int kPassVec = 4;  // state elements a thread of the pass carries
constexpr int kPassAhead = 16;  // chunks whose loads the pass issues together
constexpr int kPassElems = kPassThreads * kPassVec;  // 512 divides every P * N

static_assert(kChunkBf16 == 64 || kChunkBf16 == 128, "REPRO_SSD_CHUNK must be 64 or 128");

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

template <typename T>
constexpr int chunk_of() {
  return kIsF32<T> ? kChunkF32 : kChunkBf16;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 b16 matrices; lanes 8m..8m+7 give the row addresses of matrix m
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a . b for one 16x8 tile: lane l (g = l / 4, t = l % 4) holds
// d[0..1] = D[g][2t..2t+1], d[2..3] = D[g+8][2t..2t+1]
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) rounded to bf16, v0 in the low half
__device__ __forceinline__ uint32_t pack_bf16(float v0, float v1) {
  return as_u32(__floats2bfloat162_rn(v0, v1));
}

// (v0, v1) = hi + lo to about 16 bits: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

struct Params {
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
  float* states;  // [B, H, nc, P, N]: S_c (kernel 1), then the state entering chunk c (2)
  float* decay;   // [B, H, nc]: exp of the chunk's summed a
  int B, S, H, G, nc, hb, vec;
};

// The tile of kernels 1 and 3: batch b, chunk c, heads [h0, h0 + hb) of
// group grp; `valid` of its L rows lie before S. Tile `id` counts head
// blocks fastest, then batches, then chunks.
struct Tile {
  int b, c, h0, grp, valid;
  long long s0;
};

__device__ __forceinline__ Tile tile_of(const Params& r, int L, int id) {
  const int per = r.H / r.hb;
  Tile t;
  t.h0 = (id % per) * r.hb;
  id /= per;
  t.b = id % r.B;
  t.c = id / r.B;
  t.grp = t.h0 / (r.H / r.G);
  t.s0 = static_cast<long long>(t.c) * L;
  t.valid = min(L, static_cast<int>(r.S - t.s0));
  return t;
}

// ROWS x W elements from src (row i at src + i * stride) into dst (row
// stride ld); rows >= valid are zeros. vec: 16-byte cp.async (the caller
// waits), else element loads.
template <typename T, int ROWS, int W, int THREADS>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src, long long stride, int valid,
                                      bool vec) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  constexpr int kRow = W / kPer;
  static_assert(W % kPer == 0, "rows must be whole 16-byte pieces");
  for (int i = threadIdx.x; i < ROWS * kRow; i += THREADS) {
    const int row = i / kRow, col = (i % kRow) * kPer;
    T* d = dst + row * ld + col;
    if (row >= valid) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const T* s = src + row * stride + col;
    if (vec) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) d[e] = s[e];
    }
  }
}

// One head's a and dt over a chunk, in registers: thread i < L holds dt_i,
// lane l of warp 0 holds a over steps [l L / 32, (l + 1) L / 32); 0 past
// S. Fetched a head ahead, so the loads overlap the head before.
template <int L>
struct Steps {
  float a[L / 32];
  float dt;
};

template <int L>
__device__ __forceinline__ Steps<L> fetch_steps(const Params& r, const Tile& t, int h) {
  constexpr int kPer = L / 32;
  const long long base = (static_cast<long long>(t.b) * r.S + t.s0) * r.H + h;
  Steps<L> st;
  const int i = threadIdx.x;
  st.dt = i < t.valid ? r.dt[base + static_cast<long long>(i) * r.H] : 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = i * kPer + k;
    st.a[k] = i < 32 && j < t.valid ? r.a[base + static_cast<long long>(j) * r.H] : 0.f;
  }
  return st;
}

// dts[i] = dt_i and cs[i] = a_0 + ... + a_i. Warp 0 scans: lane l sums its
// L / 32 steps in order, then the lanes' totals are scanned with shuffles;
// the order is fixed, so kernels 1 and 3 get the same bits. The caller
// syncs.
template <int L>
__device__ __forceinline__ void put_steps(const Steps<L>& st, float* cs, float* dts) {
  constexpr int kPer = L / 32;
  if (threadIdx.x < L) dts[threadIdx.x] = st.dt;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float v[kPer];
    float run = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      run += st.a[k];
      v[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    float before = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) before = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) cs[lane * kPer + k] = before + v[k];
  }
}

template <typename T, int P, int N>
struct Shape {
  static constexpr int L = chunk_of<T>();
  static constexpr int kWarps = L / 16;
  static constexpr int kThreads = 32 * kWarps;  // kernel 1; > L: one step a thread
  static constexpr int kOutThreads = 2 * kThreads;  // kernel 3: two warps per 16 rows
  static constexpr int ldn = N + kPad;  // rows of B, C and H
  static constexpr int ldp = P + kPad;  // rows of x and x . w
  static constexpr int ldl = L + kPad;  // rows of G (float32 path)
  static constexpr size_t kX = sizeof(T) * L * ldp;  // one x tile
  static constexpr size_t kH = sizeof(float) * P * ldn;  // one float32 state tile
  // x . w (bf16: high and low parts), later the chunk's state S_c (float32)
  static constexpr size_t kU = kX * (kIsF32<T> ? 1 : 2) > kH ? kX * (kIsF32<T> ? 1 : 2) : kH;
  // kernel 1: B, two x tiles, x . w or S_c; cs, dt, w
  static constexpr size_t kStateSmem = sizeof(T) * L * ldn + 2 * kX + kU + sizeof(float) * 3 * L;
  // kernel 3: C, B, two x tiles, two state tiles (bf16: the float32 state
  // and its high and low parts), the odd warps' sums, G (float32 path); cs,
  // dt, column factors
  static constexpr size_t kOutSmem = sizeof(T) * 2 * L * ldn + 2 * kX + 2 * kH +
                                     sizeof(float) * L * P +
                                     (kIsF32<T> ? sizeof(float) * L * ldl : 0) +
                                     sizeof(float) * 3 * L;
  static_assert(P % 16 == 0 && N % 16 == 0, "P and N must be multiples of 16");
  static_assert(kOutSmem <= 232448 && kStateSmem <= 232448, "shared memory");
};

template <typename T, int P>
__device__ __forceinline__ const T* x_tile(const Params& r, const Tile& t, int h) {
  return static_cast<const T*>(r.x) + t.b * r.x_sb + t.s0 * r.x_ss + static_cast<long long>(h) * P;
}

// Kernel 1: per head, the chunk's own state S_c = (x . w)^T B, staged in
// shared memory and written whole rows at a time, and the chunk's decay.
// The next head's x and steps load while this head computes.
template <typename T, int P, int N>
__global__ void __launch_bounds__(Shape<T, P, N>::kThreads)
    ssd_scan_kernel_chunk_state(const Params r) {
  using Sh = Shape<T, P, N>;
  constexpr int L = Sh::L, ldn = Sh::ldn, ldp = Sh::ldp, kWarps = Sh::kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  T* bs = reinterpret_cast<T*>(smem);  // [L][ldn]
  T* xbuf = bs + L * ldn;              // two [L][ldp] x tiles
  T* uhi = xbuf + 2 * L * ldp;         // [L][ldp] x . w (bf16: its high part)
  T* ulo = uhi + L * ldp;              // [L][ldp] bf16 only: the low part
  float* sc = reinterpret_cast<float*>(uhi);  // [P][ldn] S_c, once x . w is read
  float* cs = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(uhi) + Sh::kU);
  float* dts = cs + L;
  float* w = dts + L;

  const Tile t = tile_of(r, L, blockIdx.x);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  stage<T, L, N, Sh::kThreads>(
      bs, ldn, static_cast<const T*>(r.bm) + t.b * r.b_sb + t.s0 * r.b_ss + t.grp * N, r.b_ss,
      t.valid, r.vec);
  stage<T, L, P, Sh::kThreads>(xbuf, ldp, x_tile<T, P>(r, t, t.h0), r.x_ss, t.valid, r.vec);
  Steps<L> steps = fetch_steps<L>(r, t, t.h0);

  for (int hh = 0; hh < r.hb; ++hh) {
    const int h = t.h0 + hh;
    const long long bh = static_cast<long long>(t.b) * r.H + h;
    const T* xs = xbuf + (hh & 1) * L * ldp;
    cp_async_wait_all();
    put_steps<L>(steps, cs, dts);
    __syncthreads();
    if (hh + 1 < r.hb) {  // into the x tile the last head read before its products
      stage<T, L, P, Sh::kThreads>(xbuf + ((hh + 1) & 1) * L * ldp, ldp,
                                   x_tile<T, P>(r, t, h + 1), r.x_ss, t.valid, r.vec);
      steps = fetch_steps<L>(r, t, h + 1);
    }
    const float last = cs[L - 1];
    if (threadIdx.x < L) w[threadIdx.x] = expf(last - cs[threadIdx.x]) * dts[threadIdx.x];
    if (threadIdx.x == 0) r.decay[bh * r.nc + t.c] = expf(last);
    __syncthreads();
    for (int i = threadIdx.x; i < L * P / 2; i += Sh::kThreads) {
      const int j = i / (P / 2), p = (i % (P / 2)) * 2;
      const float v0 = to_f(xs[j * ldp + p]) * w[j], v1 = to_f(xs[j * ldp + p + 1]) * w[j];
      if constexpr (kIsF32<T>) {
        store2(uhi + j * ldp + p, v0, v1);
      } else {
        uint32_t hi, lo;
        split_bf16(v0, v1, hi, lo);
        *reinterpret_cast<uint32_t*>(uhi + j * ldp + p) = hi;
        *reinterpret_cast<uint32_t*>(ulo + j * ldp + p) = lo;
      }
    }
    __syncthreads();

    // S_c in 16 x 16 output blocks (p0, n0), round robin over the warps
    constexpr int kBlocks = (P / 16) * (N / 16);
    constexpr int kMine = (kBlocks + kWarps - 1) / kWarps;
    constexpr bool kEven = kBlocks % kWarps == 0;  // no warp idles: no branch
    float acc[kMine][2][4] = {};
    if constexpr (kIsF32<T>) {
      for (int j = 0; j < L; ++j) {
#pragma unroll
        for (int m = 0; m < kMine; ++m) {
          const int blk = warp + m * kWarps;
          if (!kEven && blk >= kBlocks) continue;
          const int p0 = (blk / (N / 16)) * 16, n0 = (blk % (N / 16)) * 16;
          const float u0 = uhi[j * ldp + p0 + g], u1 = uhi[j * ldp + p0 + g + 8];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float2 bv = *reinterpret_cast<const float2*>(bs + j * ldn + n0 + 8 * q + 2 * tq);
            acc[m][q][0] = fmaf(u0, bv.x, acc[m][q][0]);
            acc[m][q][1] = fmaf(u0, bv.y, acc[m][q][1]);
            acc[m][q][2] = fmaf(u1, bv.x, acc[m][q][2]);
            acc[m][q][3] = fmaf(u1, bv.y, acc[m][q][3]);
          }
        }
      }
    } else {
      // A = (x . w)^T: [p][j] from the [j][p] tile by ldmatrix.trans; B = B[j][n] likewise
      const int ar = (lane & 7) + 8 * (lane >> 4), ac = 8 * ((lane >> 3) & 1);
      const int br = (lane & 7) + 8 * ((lane >> 3) & 1), bc = 8 * (lane >> 4);
#pragma unroll
      for (int k0 = 0; k0 < L; k0 += 16) {
#pragma unroll
        for (int m = 0; m < kMine; ++m) {
          const int blk = warp + m * kWarps;
          if (!kEven && blk >= kBlocks) continue;
          const int p0 = (blk / (N / 16)) * 16, n0 = (blk % (N / 16)) * 16;
          uint32_t ah[4], al[4], bq[4];
          ldsm_x4_t(ah, uhi + (k0 + ar) * ldp + p0 + ac);
          ldsm_x4_t(al, ulo + (k0 + ar) * ldp + p0 + ac);
          ldsm_x4_t(bq, bs + (k0 + br) * ldn + n0 + bc);
          mma_bf16(acc[m][0], ah, bq[0], bq[1]);
          mma_bf16(acc[m][0], al, bq[0], bq[1]);
          mma_bf16(acc[m][1], ah, bq[2], bq[3]);
          mma_bf16(acc[m][1], al, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // x . w is read: S_c takes its place
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
      const int blk = warp + m * kWarps;
      if (!kEven && blk >= kBlocks) continue;
      const int p0 = (blk / (N / 16)) * 16, n0 = (blk % (N / 16)) * 16;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = n0 + 8 * q + 2 * tq;
        store2(sc + (p0 + g) * ldn + n, acc[m][q][0], acc[m][q][1]);
        store2(sc + (p0 + g + 8) * ldn + n, acc[m][q][2], acc[m][q][3]);
      }
    }

    __syncthreads();
    float4* out = reinterpret_cast<float4*>(r.states + (bh * r.nc + t.c) * P * N);
    for (int i = threadIdx.x; i < P * N / 4; i += Sh::kThreads)
      out[i] = *reinterpret_cast<const float4*>(sc + (i / (N / 4)) * ldn + (i % (N / 4)) * 4);
    __syncthreads();  // the next head writes x . w over S_c only after this
  }
}

// Kernel 2: the states entering each chunk, in chunk order, in float32;
// slot c of `states` is read (S_c) and overwritten (H_{c-1}).
__global__ void __launch_bounds__(kPassThreads)
    ssd_scan_kernel_state_pass(float* __restrict__ states, const float* __restrict__ decay,
                               const float* __restrict__ init, float* __restrict__ final_state,
                               int nc, int pn) {
  const int per = pn / kPassElems;
  const long long bh = blockIdx.x / per;
  const int e = ((blockIdx.x % per) * kPassThreads + threadIdx.x) * kPassVec;
  float4 h = init ? *reinterpret_cast<const float4*>(init + bh * pn + e)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  float* sp = states + bh * nc * pn + e;
  const float* dp = decay + bh * nc;
  for (int c0 = 0; c0 < nc; c0 += kPassAhead) {
    float4 s[kPassAhead];
    float d[kPassAhead];
#pragma unroll
    for (int k = 0; k < kPassAhead; ++k) {
      if (c0 + k < nc) {
        s[k] = *reinterpret_cast<const float4*>(sp + static_cast<long long>(c0 + k) * pn);
        d[k] = dp[c0 + k];
      }
    }
#pragma unroll
    for (int k = 0; k < kPassAhead; ++k) {
      if (c0 + k < nc) {
        *reinterpret_cast<float4*>(sp + static_cast<long long>(c0 + k) * pn) = h;
        h.x = fmaf(d[k], h.x, s[k].x);
        h.y = fmaf(d[k], h.y, s[k].y);
        h.z = fmaf(d[k], h.z, s[k].z);
        h.w = fmaf(d[k], h.w, s[k].w);
      }
    }
  }
  *reinterpret_cast<float4*>(final_state + bh * pn + e) = h;
}

// Kernel 3: y = diag(exp(csum)) C H_{c-1}^T + M x per head, M from G = C B^T.
// Two warps per 16 rows: warp s of the pair takes the 16-column blocks q
// of M with q % 2 == s and half of N for C H^T (so the causal work of a
// row is split in two), and the pair adds its two partial sums in a fixed
// order. The next head's x, state and steps load while this head computes.
template <typename T, int P, int N>
__global__ void __launch_bounds__(Shape<T, P, N>::kOutThreads)
    ssd_scan_kernel_chunk_out(const Params r) {
  using Sh = Shape<T, P, N>;
  constexpr int L = Sh::L, ldn = Sh::ldn, ldp = Sh::ldp, ldl = Sh::ldl;
  constexpr int kThreads = Sh::kOutThreads;
  constexpr int kQ = L / 16;         // row tiles, and 16-column blocks of G
  constexpr int kQh = (kQ + 1) / 2;  // blocks a warp of a pair holds
  constexpr int kAcc = P / 8 * 4;    // accumulators a lane holds
  extern __shared__ __align__(16) unsigned char smem[];
  T* ct = reinterpret_cast<T*>(smem);  // [L][ldn]
  T* bs = ct + L * ldn;                // [L][ldn]
  T* xbuf = bs + L * ldn;              // two [L][ldp] x tiles
  // two [P][ldn] float32 tiles of the state entering the chunk: float32
  // takes them in turn; bf16 loads into the first and splits it into high
  // and low parts [P][ldn] in the second (the same bytes)
  float* hbuf = reinterpret_cast<float*>(xbuf + 2 * L * ldp);
  __nv_bfloat16* hhi = reinterpret_cast<__nv_bfloat16*>(hbuf + P * ldn);
  __nv_bfloat16* hlo = hhi + P * ldn;
  float* part = hbuf + 2 * P * ldn;             // [kQ][kAcc][32] the odd warps' sums
  float* gs = part + kQ * kAcc * 32;            // [L][ldl] float32 path only
  float* cs = gs + (kIsF32<T> ? L * ldl : 0);
  float* dts = cs + L;
  float* colf = dts + L;  // bf16: exp(csum_e - csum_j) dt_j, e the last step of j's 16

  const Tile t = tile_of(r, L, blockIdx.x);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int tile = warp / 2, s = warp % 2;
  const int m0 = 16 * tile;  // the pair's rows
  const auto state_tile = [&](int h) {
    return r.states + ((static_cast<long long>(t.b) * r.H + h) * r.nc + t.c) * P * N;
  };
  stage<T, L, N, kThreads>(
      ct, ldn, static_cast<const T*>(r.cm) + t.b * r.c_sb + t.s0 * r.c_ss + t.grp * N, r.c_ss,
      t.valid, r.vec);
  stage<T, L, N, kThreads>(
      bs, ldn, static_cast<const T*>(r.bm) + t.b * r.b_sb + t.s0 * r.b_ss + t.grp * N, r.b_ss,
      t.valid, r.vec);
  stage<T, L, P, kThreads>(xbuf, ldp, x_tile<T, P>(r, t, t.h0), r.x_ss, t.valid, r.vec);
  stage<float, P, N, kThreads>(hbuf, ldn, state_tile(t.h0), N, P, true);
  Steps<L> steps = fetch_steps<L>(r, t, t.h0);
  cp_async_wait_all();
  __syncthreads();

  // G rows m0 .. m0 + 15 in this warp's column blocks q = 2u + s <= tile:
  // gr[2u + k][e] holds G[m0 + g + 8 (e / 2)][16 q + 8 k + 2 tq + e % 2]
  float gr[2 * kQh][4];
#pragma unroll
  for (int u = 0; u < kQh; ++u) {
    const int q = 2 * u + s;
#pragma unroll
    for (int e = 0; e < 4; ++e) gr[2 * u][e] = gr[2 * u + 1][e] = 0.f;
    if (q > tile) continue;
    if constexpr (kIsF32<T>) {
      for (int n = 0; n < N; ++n) {
        const float c0 = ct[(m0 + g) * ldn + n], c1 = ct[(m0 + g + 8) * ldn + n];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int j = 16 * q + 8 * k + 2 * tq;
          const float b0 = bs[j * ldn + n], b1 = bs[(j + 1) * ldn + n];
          gr[2 * u + k][0] = fmaf(c0, b0, gr[2 * u + k][0]);
          gr[2 * u + k][1] = fmaf(c0, b1, gr[2 * u + k][1]);
          gr[2 * u + k][2] = fmaf(c1, b0, gr[2 * u + k][2]);
          gr[2 * u + k][3] = fmaf(c1, b1, gr[2 * u + k][3]);
        }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {  // this warp's blocks, for its own M below
        store2(gs + (m0 + g) * ldl + 16 * q + 8 * k + 2 * tq, gr[2 * u + k][0], gr[2 * u + k][1]);
        store2(gs + (m0 + g + 8) * ldl + 16 * q + 8 * k + 2 * tq, gr[2 * u + k][2],
               gr[2 * u + k][3]);
      }
    } else {
#pragma unroll
      for (int k0 = 0; k0 < N; k0 += 16) {
        uint32_t af[4], bq[4];
        ldsm_x4(af, ct + (m0 + (lane & 15)) * ldn + k0 + 8 * (lane >> 4));
        ldsm_x4(bq, bs + (16 * q + (lane & 7) + 8 * (lane >> 4)) * ldn + k0 +
                        8 * ((lane >> 3) & 1));
        mma_bf16(gr[2 * u], af, bq[0], bq[1]);
        mma_bf16(gr[2 * u + 1], af, bq[2], bq[3]);
      }
    }
  }
  if constexpr (kIsF32<T>) __syncwarp();

  for (int hh = 0; hh < r.hb; ++hh) {
    const int h = t.h0 + hh;
    const T* xs = xbuf + (hh & 1) * L * ldp;
    const float* hs = hbuf + (kIsF32<T> ? (hh & 1) * P * ldn : 0);
    cp_async_wait_all();
    put_steps<L>(steps, cs, dts);
    if constexpr (!kIsF32<T>) {
      __syncthreads();  // the float32 state and the steps have landed
      if (threadIdx.x < L)
        colf[threadIdx.x] = __expf(cs[threadIdx.x | 15] - cs[threadIdx.x]) * dts[threadIdx.x];
      for (int i = threadIdx.x; i < P * N / 4; i += kThreads) {  // split once, not per warp
        const int p = i / (N / 4), n = (i % (N / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(hs + p * ldn + n);
        uint2 hi, lo;
        split_bf16(v.x, v.y, hi.x, lo.x);
        split_bf16(v.z, v.w, hi.y, lo.y);
        *reinterpret_cast<uint2*>(hhi + p * ldn + n) = hi;
        *reinterpret_cast<uint2*>(hlo + p * ldn + n) = lo;
      }
    }
    __syncthreads();
    if (hh + 1 < r.hb) {  // into tiles no warp reads any more
      stage<T, L, P, kThreads>(xbuf + ((hh + 1) & 1) * L * ldp, ldp, x_tile<T, P>(r, t, h + 1),
                               r.x_ss, t.valid, r.vec);
      stage<float, P, N, kThreads>(hbuf + (kIsF32<T> ? ((hh + 1) & 1) * P * ldn : 0), ldn,
                                   state_tile(h + 1), N, P, true);
      steps = fetch_steps<L>(r, t, h + 1);
    }

    const int i0 = m0 + g, i1 = m0 + g + 8;
    const float ci0 = cs[i0], ci1 = cs[i1];
    float acc[P / 8][4] = {};
    // inter-chunk: C H^T over this warp's half of N, rows scaled by exp(csum_i)
    constexpr int kHalf = N / 2;
    if constexpr (kIsF32<T>) {
      for (int n = s * kHalf; n < (s + 1) * kHalf; ++n) {
        const float c0 = ct[i0 * ldn + n], c1 = ct[i1 * ldn + n];
#pragma unroll
        for (int pt = 0; pt < P / 8; ++pt) {
          const int p = 8 * pt + 2 * tq;
          const float h0 = hs[p * ldn + n], h1 = hs[(p + 1) * ldn + n];
          acc[pt][0] = fmaf(c0, h0, acc[pt][0]);
          acc[pt][1] = fmaf(c0, h1, acc[pt][1]);
          acc[pt][2] = fmaf(c1, h0, acc[pt][2]);
          acc[pt][3] = fmaf(c1, h1, acc[pt][3]);
        }
      }
    } else {
      const int hr = (lane & 7) + 8 * (lane >> 4), hc = 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int kk = 0; kk < kHalf; kk += 16) {
        const int k0 = s * kHalf + kk;
        uint32_t af[4];
        ldsm_x4(af, ct + (m0 + (lane & 15)) * ldn + k0 + 8 * (lane >> 4));
#pragma unroll
        for (int pq = 0; pq < P / 16; ++pq) {
          uint32_t hi[4], lo[4];
          ldsm_x4(hi, hhi + (16 * pq + hr) * ldn + k0 + hc);
          ldsm_x4(lo, hlo + (16 * pq + hr) * ldn + k0 + hc);
          mma_bf16(acc[2 * pq], af, hi[0], hi[1]);
          mma_bf16(acc[2 * pq], af, lo[0], lo[1]);
          mma_bf16(acc[2 * pq + 1], af, hi[2], hi[3]);
          mma_bf16(acc[2 * pq + 1], af, lo[2], lo[3]);
        }
      }
    }
    const float e0 = expf(ci0), e1 = expf(ci1);
#pragma unroll
    for (int pt = 0; pt < P / 8; ++pt) {
      acc[pt][0] *= e0;
      acc[pt][1] *= e0;
      acc[pt][2] *= e1;
      acc[pt][3] *= e1;
    }

    // intra-chunk: M x over this warp's column blocks, j <= i
    if constexpr (kIsF32<T>) {
      for (int q = s; q <= tile; q += 2) {
        for (int j = 16 * q; j < 16 * q + 16; ++j) {
          const float cj = cs[j], dj = dts[j];
          const float mv0 = j <= i0 ? gs[i0 * ldl + j] * expf(ci0 - cj) * dj : 0.f;
          const float mv1 = j <= i1 ? gs[i1 * ldl + j] * expf(ci1 - cj) * dj : 0.f;
#pragma unroll
          for (int pt = 0; pt < P / 8; ++pt) {
            const float2 xv = *reinterpret_cast<const float2*>(xs + j * ldp + 8 * pt + 2 * tq);
            acc[pt][0] = fmaf(mv0, xv.x, acc[pt][0]);
            acc[pt][1] = fmaf(mv0, xv.y, acc[pt][1]);
            acc[pt][2] = fmaf(mv1, xv.x, acc[pt][2]);
            acc[pt][3] = fmaf(mv1, xv.y, acc[pt][3]);
          }
        }
      }
    } else {
      const int xr = (lane & 7) + 8 * ((lane >> 3) & 1), xc = 8 * (lane >> 4);
#pragma unroll
      for (int u = 0; u < kQh; ++u) {
        const int q = 2 * u + s;
        if (q > tile) continue;
        // the A fragment of M's columns 16 q .. 16 q + 15, from G in registers
        float mv[2][4];
        if (q < tile) {  // i > e >= j: exp(csum_i - csum_e) exp(csum_e - csum_j), both <= 1
          const float ce = cs[16 * q + 15];
          const float r0 = __expf(ci0 - ce), r1 = __expf(ci1 - ce);
#pragma unroll
          for (int k = 0; k < 2; ++k) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float cf = colf[16 * q + 8 * k + 2 * tq + e];
              mv[k][e] = gr[2 * u + k][e] * r0 * cf;
              mv[k][2 + e] = gr[2 * u + k][2 + e] * r1 * cf;
            }
          }
        } else {  // the diagonal block: per pair, j <= i only
#pragma unroll
          for (int k = 0; k < 2; ++k) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = 16 * q + 8 * k + 2 * tq + e;
              const float cj = cs[j], dj = dts[j];
              mv[k][e] = j <= i0 ? gr[2 * u + k][e] * __expf(ci0 - cj) * dj : 0.f;
              mv[k][2 + e] = j <= i1 ? gr[2 * u + k][2 + e] * __expf(ci1 - cj) * dj : 0.f;
            }
          }
        }
        uint32_t ahi[4], alo[4];
        split_bf16(mv[0][0], mv[0][1], ahi[0], alo[0]);
        split_bf16(mv[0][2], mv[0][3], ahi[1], alo[1]);
        split_bf16(mv[1][0], mv[1][1], ahi[2], alo[2]);
        split_bf16(mv[1][2], mv[1][3], ahi[3], alo[3]);
#pragma unroll
        for (int qp = 0; qp < P / 16; ++qp) {
          uint32_t bq[4];
          ldsm_x4_t(bq, xs + (16 * q + xr) * ldp + 16 * qp + xc);
          mma_bf16(acc[2 * qp], ahi, bq[0], bq[1]);
          mma_bf16(acc[2 * qp], alo, bq[0], bq[1]);
          mma_bf16(acc[2 * qp + 1], ahi, bq[2], bq[3]);
          mma_bf16(acc[2 * qp + 1], alo, bq[2], bq[3]);
        }
      }
    }

    // the pair's sum, even warp's + odd warp's, and y
    float* mine = part + tile * kAcc * 32 + lane;
    if (s == 1) {
#pragma unroll
      for (int pt = 0; pt < P / 8; ++pt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(4 * pt + e) * 32] = acc[pt][e];
    }
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + tile) : "memory");  // the pair only
    if (s == 0) {
      T* yb = static_cast<T*>(r.y) + ((static_cast<long long>(t.b) * r.S + t.s0) * r.H + h) * P;
      const long long ys = static_cast<long long>(r.H) * P;
#pragma unroll
      for (int pt = 0; pt < P / 8; ++pt) {
        const int p = 8 * pt + 2 * tq;
        if (i0 < t.valid)
          store2(yb + i0 * ys + p, acc[pt][0] + mine[(4 * pt) * 32],
                 acc[pt][1] + mine[(4 * pt + 1) * 32]);
        if (i1 < t.valid)
          store2(yb + i1 * ys + p, acc[pt][2] + mine[(4 * pt + 2) * 32],
                 acc[pt][3] + mine[(4 * pt + 3) * 32]);
      }
    }
    __syncthreads();  // the next head writes cs, dt, colf, the split state and the sums
  }
}

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

template <typename T, int P, int N>
int launch(const Params& r, cudaStream_t stream) {
  using Sh = Shape<T, P, N>;
  static unsigned state_set = 0, out_set = 0;
  const long long tiles = static_cast<long long>(r.B) * r.nc * (r.H / r.hb);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (tiles > 0) {
    err = allow_smem(ssd_scan_kernel_chunk_state<T, P, N>, Sh::kStateSmem, state_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_scan_kernel_chunk_state<T, P, N>
        <<<static_cast<unsigned>(tiles), Sh::kThreads, Sh::kStateSmem, stream>>>(r);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long pass_blocks = static_cast<long long>(r.B) * r.H * (P * N / kPassElems);
  ssd_scan_kernel_state_pass<<<static_cast<unsigned>(pass_blocks), kPassThreads, 0, stream>>>(
      r.states, r.decay, r.init, r.final_state, r.nc, P * N);
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 0) return static_cast<int>(err);
  err = allow_smem(ssd_scan_kernel_chunk_out<T, P, N>, Sh::kOutSmem, out_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel_chunk_out<T, P, N>
      <<<static_cast<unsigned>(tiles), Sh::kOutThreads, Sh::kOutSmem, stream>>>(r);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int dispatch_n(int N, const Params& r, cudaStream_t s) {
  switch (N) {
    case 32: return launch<T, P, 32>(r, s);
    case 64: return launch<T, P, 64>(r, s);
    case 128: return launch<T, P, 128>(r, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_p(int P, int N, const Params& r, cudaStream_t s) {
  switch (P) {
    case 16: return dispatch_n<T, 16>(N, r, s);
    case 32: return dispatch_n<T, 32>(N, r, s);
    case 64: return dispatch_n<T, 64>(N, r, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// The kernels' chunk length for a dtype code (0 float32, 1 bfloat16): the
// caller sizes the scratch by it.
extern "C" int ssd_scan_chunk(int dtype) { return dtype == 0 ? kChunkF32 : kChunkBf16; }

// x [B, S, H, P] with P contiguous, heads P apart, steps x_ss and batches
// x_sb elements apart; a = dt * A and dt [B, S, H] float32 contiguous;
// B and C [B, S, G, N] with N contiguous, groups N apart, steps b_ss / c_ss
// and batches b_sb / c_sb apart; init [B, H, P, N] float32 or null (zeros);
// y [B, S, H, P] contiguous in x's dtype (0 float32, 1 bfloat16);
// final_state [B, H, P, N] float32; scratch: states [B, H, nc, P, N] and
// decay [B, H, nc] float32, nc = ceil(S / ssd_scan_chunk(dtype)). P in
// {16, 32, 64}, N in {32, 64, 128}, G divides H. Runs the three kernels on
// `stream`; returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for a shape or dtype it does not take).
extern "C" int ssd_scan(const void* x, long long x_sb, long long x_ss, const float* a,
                        const float* dt, const void* bm, long long b_sb, long long b_ss,
                        const void* cm, long long c_sb, long long c_ss, const float* init,
                        void* y, float* final_state, float* states, float* decay, int B, int S,
                        int H, int G, int P, int N, int dtype, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (G <= 0 || H % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int L = ssd_scan_chunk(dtype);
  int hb = kMaxHeads;
  while ((H / G) % hb != 0) hb /= 2;
  const long long es = dtype == 0 ? 4 : 2;
  const long long strides[] = {x_sb, x_ss, b_sb, b_ss, c_sb, c_ss};
  bool vec = aligned16(x) && aligned16(bm) && aligned16(cm);
  for (long long st : strides) vec = vec && (st * es) % 16 == 0;
  const Params r{x, x_sb, x_ss, a, dt, bm, b_sb, b_ss, cm, c_sb, c_ss, init, y, final_state,
                 states, decay, B, S, H, G, (S + L - 1) / L, hb, vec ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_p<float>(P, N, r, s);
  return dispatch_p<__nv_bfloat16>(P, N, r, s);
}
