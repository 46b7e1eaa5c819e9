// Sorted-segment (CSR) sums, with or without a gather:
//   segment_sum:        out[r] = sum of msg[e] over the edges e of row r
//   gather_segment_sum: out[r] = sum of feats[idx[e]] over the edges e of row r
//
// segment_sum replaces src/repro/kernels/fused_gnn.py::segment_spmm_ragged_pallas,
// gather_segment_sum replaces fused_gnn.py::gather_spmm_ragged_pallas and,
// after the stable sort of segment_sort.cu (with idx = the permutation, or
// idx[perm]), the dense gather_spmm_pallas / segment_spmm_pallas call
// forms, whose ids come in any order. The TPU kernels turn the scatter into a one-hot matmul per
// edge tile for the MXU, with the gather done inside the tile so the [E, D]
// message array never exists. On Hopper the sum does no arithmetic worth a
// tensor core (one add per element read), so it is bound by the bytes of the
// rows it reads, and by their latency where a thread group waits on one
// row after another. Each row is reduced by a group of `tpr` threads with
// 16-byte loads per thread and a float accumulator per column; the gather
// form reads the row through `idx` in the load (idx < 0 drops the edge), so
// it too never writes an [E, D] array. The row is written once, cast to the
// dtype at the end.
//
// Long rows. A row of at most L = kSumChunk edges (common.cuh) is walked by
// one group in edge order. A longer row is cut into chunks of L edge slots
// counted from its own first slot; each chunk is summed in edge order by a
// group of its own into a float32 partial, and the group that finishes the
// row's last chunk adds the partials in chunk order (an integer counter per
// row picks that group; no float atomics). So a call no longer lasts as
// long as its longest row, and a row's bits depend only on its own edges:
// the same in any batch, at any offset, on every run (chunks cut at global
// edge positions would make them depend on the rows before it).
// The groups find the chunks without a list and without the host: the
// grid's first blocks take one window of L edge slots [wL, wL + L) per
// group, and a window holds the first slot of at most two chunks: one of
// the row of its first slot, and chunk 0 of the row of its last slot (a row
// in between lies inside the window, so it is short). Their partials go to
// slots 2w and 2w + 1 of a float32 scratch [2 ceil(E / L), D]. The grid is
// sized from E / L + n; windows and rows with nothing to do return at once.
// Within a walk of several edges per row, the loads of the next
// kEdgeBatch edges (index and row) are issued before their adds, which
// stay in edge order.
// The training backward of the gather is the gather form itself over the
// edges sorted by idx, with idx and seg swapped (kernels/fused_gnn.py).
#include "common.cuh"

namespace repro_torch {

// Row offsets from a segment-id array: row_ptr[r] = first slot whose key is
// >= r, for r in [0, n]. Thread e writes the rows in (key[e-1], key[e]]; for
// a non-decreasing key every row is written exactly once. A decrease sets
// *unsorted (zeroed by the caller), and the reductions then take the
// fallback of `for_each_edge`.
__global__ void segment_offsets_kernel(const int* __restrict__ seg, int E, int n,
                                       int* __restrict__ row_ptr, int* __restrict__ unsorted) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e > E) return;
  const int lo = (e == 0) ? 0 : seg_key(seg[e - 1], n) + 1;
  const int hi = (e == E) ? n : seg_key(seg[e], n);
  for (int r = lo; r <= hi; ++r) row_ptr[r] = e;
  if (e > 0 && e < E && hi < lo - 1) *unsorted = 1;
}

// Two builds of the kernel, which add in the same order and so give the
// same bits; the wrapper picks one from the dtype and the edges per row
// (E / n), as the time of a call goes (tools/chunk_sweep.py, H100: both
// builds at 150,000 rows of Poisson(k) edges, k 1-8, D 128 and 256):
//  - BATCH = 1: one edge at a time, capped at 40 registers (6 blocks an
//    SM), so more rows are in flight. Float32 at every k: at or below the
//    batched build in the gather form (k = 8, D 128: 0.167 against 0.187
//    ms), within 1% of it in the plain form; bf16 below about 4 edges a
//    row. On the training path's largest gather (38,144 rows of 1.4
//    edges, D 128; tools/time_sampled_rows.py) the call took 0.0202 ms
//    at 6 blocks, 0.0242 at 8 (32 registers and spills), 0.0241 batched.
//  - BATCH = kEdgeBatch: a group has the loads of that many edges in flight
//    at once, capped at 64 registers a thread (4 blocks an SM); bf16 from
//    about 4 edges a row (k = 8, D 128: 0.092 against 0.098 ms gathered,
//    0.124 against 0.140 plain). On the stand-in's 1.05 M edges 4 edges at
//    4 blocks took the dense sum's kernel from 0.50 ms (8 edges, 138
//    registers, one block an SM) to 0.22, and 8 at 4 to 0.26.
constexpr int kEdgeBatch = 4;
constexpr int kBatchedMinBlocks = 4;
constexpr int kLeanMinBlocks = 6;

template <int BATCH>
constexpr int sum_min_blocks() {
  return BATCH == 1 ? kLeanMinBlocks : kBatchedMinBlocks;
}

// The lanes of this thread's group (tpr a power of two up to 32, groups
// aligned within the warp).
__device__ __forceinline__ unsigned group_mask(int tpr) {
  const unsigned base = (threadIdx.x & 31u) & ~static_cast<unsigned>(tpr - 1);
  return tpr == 32 ? 0xffffffffu : ((1u << tpr) - 1u) << base;
}

// The source row of edge slot e (-1: none, past `end` or a dropped gather).
template <bool GATHER>
__device__ __forceinline__ int edge_row(const int* __restrict__ idx, int e, int end) {
  if (e >= end) return -1;
  return GATHER ? idx[e] : e;
}

// acc += the columns [c, c + VEC) of the rows of edge slots [beg, end), in
// edge order. With BATCH > 1 the rows of BATCH edges load at once, and the
// next batch's indices while this batch's rows do.
template <typename T, int VEC, bool GATHER, int BATCH>
__device__ __forceinline__ void add_edges(const T* __restrict__ src, const int* __restrict__ idx,
                                          int beg, int end, int D, int c, float (&acc)[VEC]) {
  if constexpr (BATCH == 1) {
#pragma unroll 4
    for (int j = beg; j < end; ++j) {
      const int r = edge_row<GATHER>(idx, j, end);
      if (r >= 0) add_raw(acc, load_raw<T, VEC>(src + static_cast<size_t>(r) * D + c));
    }
  } else {
    int r[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) r[b] = edge_row<GATHER>(idx, beg + b, end);
    for (int j = beg; j < end; j += BATCH) {
      Raw<T, VEC> x[BATCH];
      int cur[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        cur[b] = r[b];
        if (cur[b] >= 0) x[b] = load_raw<T, VEC>(src + static_cast<size_t>(cur[b]) * D + c);
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) r[b] = edge_row<GATHER>(idx, j + BATCH + b, end);
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        if (cur[b] >= 0) add_raw(acc, x[b]);
      }
    }
  }
}

// VEC floats written by another block in this launch: read from L2.
template <int VEC>
__device__ __forceinline__ void load_cg(const float* p, float (&x)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(p + i));
      x[i] = v.x; x[i + 1] = v.y; x[i + 2] = v.z; x[i + 3] = v.w;
    }
  } else if constexpr (VEC == 2) {
    const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
    x[0] = v.x; x[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = __ldcg(p + i);
  }
}

// The scratch slot of chunk k of the long row whose first edge slot is beg:
// 2w for the chunk whose first slot opens window w's first row, 2w + 1 for
// chunk 0 of a row that starts inside window w.
__device__ __forceinline__ int chunk_slot(int beg, int k) {
  if (k > 0) return 2 * ((beg + k * kSumChunk) / kSumChunk);
  return 2 * (beg / kSumChunk) + (beg % kSumChunk != 0);
}

// One group: chunk k (first slot s) of the long row [beg, end) into its
// scratch slot; the group that completes the row then adds its partials in
// chunk order into out[row] and rearms the row's counter for the next call.
template <typename T, int VEC, bool GATHER, int BATCH>
__device__ __forceinline__ void sum_chunk(const T* __restrict__ src, const int* __restrict__ idx,
                                          int row, int beg, int end, int s, int slot, int D,
                                          int lane, int tpr, int* __restrict__ done,
                                          float* __restrict__ partial, T* __restrict__ out) {
  const int e1 = min(s + kSumChunk, end);
  for (int c = lane * VEC; c < D; c += tpr * VEC) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    add_edges<T, VEC, GATHER, BATCH>(src, idx, s, e1, D, c, acc);
    store_vec<VEC>(partial + static_cast<size_t>(slot) * D + c, acc);
  }
  __threadfence();  // this lane's partial is visible before the count moves
  const unsigned mask = group_mask(tpr);
  __syncwarp(mask);
  const int chunks = (end - beg + kSumChunk - 1) / kSumChunk;
  int* counter = done + chunk_slot(beg, 0);
  int last = 0;
  if (lane == 0) last = atomicAdd(counter, 1) == chunks - 1;
  if (!__shfl_sync(mask, last, 0, tpr)) return;
  __threadfence();  // every partial of the row is visible from here
  for (int c = lane * VEC; c < D; c += tpr * VEC) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < chunks; k0 += BATCH) {
      float x[BATCH][VEC];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        if (k0 + b < chunks) {
          load_cg<VEC>(partial + static_cast<size_t>(chunk_slot(beg, k0 + b)) * D + c, x[b]);
        }
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        if (k0 + b < chunks) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] += x[b][i];
        }
      }
    }
    store_vec<VEC>(out + static_cast<size_t>(row) * D + c, acc);
  }
  if (lane == 0) *counter = 0;
}

// GATHER false: row r sums src[e]; true: row r sums src[idx[e]], skipping
// idx[e] < 0. Blocks [0, window_blocks) hold one window group each of the
// long rows' chunks; the rest one row group each.
template <typename T, int VEC, bool GATHER, int BATCH>
__global__ void __launch_bounds__(kThreads, sum_min_blocks<BATCH>())
    segment_sum_kernel(const T* __restrict__ src, const int* __restrict__ idx,
                       const int* __restrict__ seg, int E, const int* __restrict__ row_ptr,
                       const int* __restrict__ unsorted, int* __restrict__ done,
                       float* __restrict__ partial, int n, int D, int tpr, int window_blocks,
                       T* __restrict__ out) {
  // The ids and offsets load before the unsorted flag is tested: they are
  // in range either way (the offsets exist for unsorted input too).
  const int group = threadIdx.x / tpr;
  const int lane = threadIdx.x % tpr;
  const int groups = kThreads / tpr;
  if (static_cast<int>(blockIdx.x) < window_blocks) {
    const long long w0 = (static_cast<long long>(blockIdx.x) * groups + group) * kSumChunk;
    if (w0 >= E) return;
    const int w = static_cast<int>(w0 / kSumChunk);
    const int w1 = static_cast<int>(min(w0 + kSumChunk, static_cast<long long>(E)));
    const int first = seg_key(seg[w0], n);
    const int last = seg_key(seg[w1 - 1], n);
    if (*unsorted) return;  // no CSR rows: the row groups scan for their edges
    for (int which = 0; which < 2; ++which) {
      const int row = which == 0 ? first : last;
      if (row >= n || (which == 1 && last == first)) continue;
      const int beg = row_ptr[row], end = row_ptr[row + 1];
      if (end - beg <= kSumChunk) continue;
      // the row's chunk whose first slot lies in this window, if any
      const int k = which == 0 ? (static_cast<int>(w0) - beg + kSumChunk - 1) / kSumChunk : 0;
      const int s = beg + k * kSumChunk;
      if (s >= w1 || s >= end) continue;
      sum_chunk<T, VEC, GATHER, BATCH>(src, idx, row, beg, end, s, 2 * w + which, D, lane, tpr,
                                       done, partial, out);
    }
    return;
  }
  const int row = (blockIdx.x - window_blocks) * groups + group;
  if (row >= n) return;
  const int beg = row_ptr[row], end = row_ptr[row + 1];
  if (*unsorted) {  // the O(E) fallback of for_each_edge, one edge at a time
    for (int c = lane * VEC; c < D; c += tpr * VEC) {
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
      for_each_edge(row, n, row_ptr, seg, E, true, [&](int e) {
        int r = e;
        if constexpr (GATHER) {
          r = idx[e];
          if (r < 0) return;
        }
        float x[VEC];
        load_vec<VEC>(src + static_cast<size_t>(r) * D + c, x);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += x[i];
      });
      store_vec<VEC>(out + static_cast<size_t>(row) * D + c, acc);
    }
    return;
  }
  if (end - beg > kSumChunk) return;  // a long row: the window groups sum it
  for (int c = lane * VEC; c < D; c += tpr * VEC) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    add_edges<T, VEC, GATHER, BATCH>(src, idx, beg, end, D, c, acc);
    store_vec<VEC>(out + static_cast<size_t>(row) * D + c, acc);
  }
}

// The layout of the long rows' scratch, known here only (the wrapper asks
// for its sizes through segment_index_words and segment_sum_scratch_rows).
constexpr long long sum_windows(long long E) {
  return (E + kSumChunk - 1) / kSumChunk;
}

// Two scratch slots a window: a float32 partial row each, and an integer
// counter each in the CSR index after the row offsets and the flag.
constexpr long long chunk_slots(long long E) { return 2 * sum_windows(E); }

constexpr long long index_words(long long E, long long n) { return n + 2 + chunk_slots(E); }

template <typename T, int VEC, bool GATHER>
static cudaError_t launch_sum(const void* src, const int* idx, const int* seg, int E,
                              const int* row_ptr, const int* unsorted, int* done, float* partial,
                              int n, int D, int tpr, int lean, void* out, cudaStream_t stream) {
  const int groups = kThreads / tpr;
  const long long window_blocks = (sum_windows(E) + groups - 1) / groups;
  const unsigned blocks = static_cast<unsigned>(window_blocks + (n + groups - 1) / groups);
  const T* in = static_cast<const T*>(src);
  T* o = static_cast<T*>(out);
  if (lean) {
    segment_sum_kernel<T, VEC, GATHER, 1><<<blocks, kThreads, 0, stream>>>(
        in, idx, seg, E, row_ptr, unsorted, done, partial, n, D, tpr,
        static_cast<int>(window_blocks), o);
  } else {
    segment_sum_kernel<T, VEC, GATHER, kEdgeBatch><<<blocks, kThreads, 0, stream>>>(
        in, idx, seg, E, row_ptr, unsorted, done, partial, n, D, tpr,
        static_cast<int>(window_blocks), o);
  }
  return cudaGetLastError();
}

template <bool GATHER>
static int dispatch_sum(const void* src, const void* idx, const void* seg, int E,
                        const void* index, long long index_len, int n, int D, int dtype,
                        int vec, int tpr, int lean, void* partial, long long partial_rows,
                        void* out, void* stream) {
  if (n == 0) return 0;
  // sized for another L (or the index of another E or n): refused
  if (index_len != index_words(E, n) || partial_rows != chunk_slots(E)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* ix = static_cast<const int*>(idx);
  const int* sg = static_cast<const int*>(seg);
  const int* rp = static_cast<const int*>(index);
  const int* un = rp + n + 1;
  int* dn = const_cast<int*>(rp) + n + 2;
  float* pt = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SUM(T, V) \
  launch_sum<T, V, GATHER>(src, ix, sg, E, rp, un, dn, pt, n, D, tpr, lean, out, s)
  if (dtype == kF32) {
    switch (vec) {
      case 4: return REPRO_SUM(float, 4);
      case 2: return REPRO_SUM(float, 2);
      case 1: return REPRO_SUM(float, 1);
    }
  } else if (dtype == kBF16) {
    switch (vec) {
      case 8: return REPRO_SUM(__nv_bfloat16, 8);
      case 4: return REPRO_SUM(__nv_bfloat16, 4);
      case 2: return REPRO_SUM(__nv_bfloat16, 2);
      case 1: return REPRO_SUM(__nv_bfloat16, 1);
    }
  }
#undef REPRO_SUM
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro_torch

using namespace repro_torch;

// Words of the CSR index of E edges into n rows: row_ptr in [0, n], the
// unsorted flag at [n + 1], then one counter per scratch slot of the long
// rows' chunks (each call of the sums leaves them at zero).
extern "C" long long segment_index_words(int E, int n) { return index_words(E, n); }

// Rows of the float32 scratch [rows, D] of the sums over E edges: one
// partial sum per scratch slot.
extern "C" long long segment_sum_scratch_rows(int E) { return chunk_slots(E); }

// seg [E] int32; index [segment_index_words(E, n)] int32, zeroed.
extern "C" int segment_offsets(const void* seg, int E, int n, void* index, void* stream) {
  int* idx = static_cast<int*>(index);
  const int blocks = E / kThreads + 1;  // E + 1 threads
  segment_offsets_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seg), E, n, idx, idx + n + 1);
  return static_cast<int>(cudaGetLastError());
}

// msg [E, D] (dtype), seg [E], index [index_len] from segment_offsets,
// partial float32 scratch [partial_rows, D], out [n, D] (dtype). Lengths
// other than segment_index_words(E, n) and segment_sum_scratch_rows(E) are
// refused. `vec` elements per load, `tpr` threads per group and `lean`
// (non-zero: the build that takes one edge at a time) are chosen by the
// wrapper.
extern "C" int segment_sum(const void* msg, const void* seg, int E, const void* index,
                           long long index_len, int n, int D, int dtype, int vec, int tpr,
                           int lean, void* partial, long long partial_rows, void* out,
                           void* stream) {
  return dispatch_sum<false>(msg, nullptr, seg, E, index, index_len, n, D, dtype, vec, tpr, lean,
                             partial, partial_rows, out, stream);
}

// feats [F, D] (dtype), idx [E] int32 rows of feats (-1 = padding), seg [E],
// index from segment_offsets over seg, partial as for segment_sum, out
// [n, D] (dtype).
extern "C" int gather_segment_sum(const void* feats, const void* idx, const void* seg, int E,
                                  const void* index, long long index_len, int n, int D,
                                  int dtype, int vec, int tpr, int lean, void* partial,
                                  long long partial_rows, void* out, void* stream) {
  return dispatch_sum<true>(feats, idx, seg, E, index, index_len, n, D, dtype, vec, tpr, lean,
                            partial, partial_rows, out, stream);
}
