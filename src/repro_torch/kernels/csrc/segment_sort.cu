// Stable sort of segment ids on the card: an LSD radix sort with 8-bit digits.
//
// With the CSR gather kernel of segment_sum.cu it is the Hopper route of the
// dense call forms, whose ids come in any order:
//   src/repro/kernels/segment_spmm.py::segment_spmm_pallas (msg rows)
//   src/repro/kernels/fused_gnn.py::gather_spmm_pallas     (feats[idx] rows)
// The TPU kernels multiply a one-hot tile per (row block, edge block) on the
// MXU, where the order of the ids never matters. On Hopper a row is summed
// from a contiguous run of edge slots (a CSR row), so the ids are first
// sorted: this source computes the permutation that stable-sorts
// key(e) = seg_key(seg[e], n), with the padding (seg < 0) and ids >= n last.
// Stability keeps each row's edges in index order, so the CSR kernel sums a
// row in the order it sums it over input that came sorted.
//
// Each pass sorts by one 8-bit digit, least significant first, and the
// wrapper runs ceil(bits(n) / 8) passes (3 at n = 150,000). A pass is three
// kernels:
//   1. count: each tile of kSortTile keys counts its 256 digits in shared
//      memory (one integer add per warp and digit), into the digit-major
//      table tbl[d * tiles + t];
//   2. scan: one block per digit turns its row of the table into its
//      exclusive prefix sum over the tiles, and writes the row's total;
//   3. scatter: each block scans the 256 totals (the first output slot of
//      each digit); each warp ranks its keys stably (rounds of 32 keys in
//      index order; __match_any_sync groups equal digits, a popcount of the
//      lower lanes ranks within a round, per-warp digit counters carry
//      across rounds), the warps' counts are combined in warp order, and
//      each key and its edge id go to the digit's slot + tbl[d][t] + the
//      warp's base + the rank.
// Together, steps 2 and 3 take the exclusive scan of the whole digit-major
// table in parallel (one block scanning all of it is serial: 0.082 ms a pass
// at 1.05 M keys on an H100).
// The first pass reads the raw ids and takes the edge ids from the position;
// the last may also write idx[perm] for the gather form. A single counting
// pass over n + 1 bins would need tiles x (n + 1) counters to be stable.
//
// Bound by bytes: a pass reads the keys twice and writes keys and edge ids
// once. Integer counts only and no dependence on block order: the
// permutation is a function of the input, and no pass waits for the host,
// so a CUDA graph can capture the whole sort.
//
// Built with -DREPRO_SORT_JITTER (tools/sanitize_sort.py --jitter), every
// thread sleeps a pseudo-random 0-1023 ns at each point where data passes
// between lanes, warps or blocks, so that a missing barrier changes the
// permutation instead of hiding behind a lucky schedule.
#include "common.cuh"

namespace repro_torch {

constexpr int kRadix = 256;
constexpr int kSortWarps = 8;
constexpr int kSortThreads = kSortWarps * 32;
constexpr int kSortItems = 16;                        // keys per thread
constexpr int kSortTile = kSortThreads * kSortItems;  // 4096 keys
constexpr int kWarpKeys = kSortTile / kSortWarps;     // 512 keys, 16 rounds
constexpr int kNoDigit = kRadix;  // lanes past the last key
static_assert(kSortThreads == kRadix, "one thread per digit in count, scan and scatter");

__device__ __forceinline__ void jitter(int salt) {
#ifdef REPRO_SORT_JITTER
  unsigned h = static_cast<unsigned>(clock64()) ^ (blockIdx.x * 0x9E3779B1u) ^
               (threadIdx.x * 0x85EBCA6Bu) ^ (static_cast<unsigned>(salt) * 0xC2B2AE35u);
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  __nanosleep(h & 1023u);
#endif
}

// Exclusive prefix sum of one int per thread over a kSortThreads block;
// `warp_sums` is kSortWarps ints of shared memory, `total` gets the sum.
// Every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int off = 1; off < 32; off *= 2) {
    const int t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  jitter(incl);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < kSortWarps; ++w) {
    const int s = warp_sums[w];
    before += w < warp ? s : 0;
    sum += s;
  }
  __syncthreads();  // warp_sums may be written again
  *total = sum;
  return before + incl - v;
}

template <bool FIRST>
__device__ __forceinline__ int load_key(const int* __restrict__ in, long long e, int n) {
  return FIRST ? seg_key(in[e], n) : in[e];
}

__device__ __forceinline__ int digit_of(int key, int shift) {
  return (key >> shift) & (kRadix - 1);
}

template <bool FIRST>
__global__ void __launch_bounds__(kSortThreads)
    radix_count_kernel(const int* __restrict__ keys, int E, int n, int shift, int tiles,
                       int* __restrict__ tbl) {
  __shared__ int hist[kRadix];
  hist[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long start = static_cast<long long>(blockIdx.x) * kSortTile;
  for (int j = threadIdx.x; j < kSortTile; j += kSortThreads) {
    const long long e = start + j;
    const int d = e < E ? digit_of(load_key<FIRST>(keys, e, n), shift) : kNoDigit;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    jitter(j);
    if (d != kNoDigit && lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
  }
  __syncthreads();
  jitter(0);
  tbl[static_cast<size_t>(threadIdx.x) * tiles + blockIdx.x] = hist[threadIdx.x];
}

// Row d of the digit-major table (its `tiles` counts) becomes its exclusive
// prefix sum, in rounds of kSortThreads tiles; totals[d] gets the row's sum.
__global__ void __launch_bounds__(kSortThreads)
    radix_scan_kernel(int* __restrict__ tbl, int tiles, int* __restrict__ totals) {
  __shared__ int warp_sums[kSortWarps];
  int* row = tbl + static_cast<size_t>(blockIdx.x) * tiles;
  int carry = 0;
  for (int base = 0; base < tiles; base += kSortThreads) {
    const int t = base + threadIdx.x;
    const int v = t < tiles ? row[t] : 0;
    jitter(t);
    int sum;
    const int excl = block_exclusive_scan(v, warp_sums, &sum);
    if (t < tiles) row[t] = carry + excl;
    carry += sum;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

template <bool FIRST, bool LAST>
__global__ void __launch_bounds__(kSortThreads)
    radix_scatter_kernel(const int* __restrict__ keys_in, const int* __restrict__ vals_in, int E,
                         int n, int shift, int tiles, const int* __restrict__ tbl,
                         const int* __restrict__ totals, const int* __restrict__ idx,
                         int* __restrict__ keys_out, int* __restrict__ vals_out,
                         int* __restrict__ idx_out) {
  // per warp and digit: the warp's count, then its first output slot
  __shared__ int base[kSortWarps][kRadix];
  __shared__ int warp_sums[kSortWarps];
  for (int w = 0; w < kSortWarps; ++w) base[w][threadIdx.x] = 0;
  int all;
  // the first output slot of digit threadIdx.x: the keys of smaller digits
  const int digit_first = block_exclusive_scan(totals[threadIdx.x], warp_sums, &all);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const long long first =
      static_cast<long long>(blockIdx.x) * kSortTile + warp * kWarpKeys + lane;
  int key[kSortItems], val[kSortItems], rank[kSortItems];
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const long long e = first + r * 32;
    key[r] = e < E ? load_key<FIRST>(keys_in, e, n) : 0;
    val[r] = e < E ? (FIRST ? static_cast<int>(e) : vals_in[e]) : 0;
  }
  __syncthreads();
  int* count = base[warp];
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const bool ok = first + r * 32 < E;
    const int d = ok ? digit_of(key[r], shift) : kNoDigit;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int before = count[ok ? d : 0];  // a lane past the keys reads a real slot, unused
    jitter(r);
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) count[d] = before + __popc(peers);
    jitter(r + kSortItems);
    __syncwarp();
    rank[r] = ok ? before + __popc(peers & below) : -1;
  }
  jitter(1);
  __syncthreads();
  {
    const int d = threadIdx.x;
    int run = digit_first + tbl[static_cast<size_t>(d) * tiles + blockIdx.x];
    for (int w = 0; w < kSortWarps; ++w) {
      const int c = base[w][d];
      base[w][d] = run;
      run += c;
    }
  }
  jitter(2);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    if (rank[r] < 0) continue;
    const int dst = count[digit_of(key[r], shift)] + rank[r];
    keys_out[dst] = key[r];
    vals_out[dst] = val[r];
    if constexpr (LAST) {
      if (idx != nullptr) idx_out[dst] = idx[val[r]];
    }
  }
}

template <bool FIRST, bool LAST>
static void launch_scatter(const int* keys_in, const int* vals_in, int E, int n, int shift,
                           int tiles, const int* tbl, const int* totals, const int* idx,
                           int* keys_out, int* vals_out, int* idx_out, cudaStream_t s) {
  radix_scatter_kernel<FIRST, LAST><<<tiles, kSortThreads, 0, s>>>(
      keys_in, vals_in, E, n, shift, tiles, tbl, totals, idx, keys_out, vals_out, idx_out);
}

}  // namespace repro_torch

using namespace repro_torch;

// One pass of the sort, by the digit at bit `shift`, over E > 0 keys:
//   first: keys_in is the raw seg [E] (keys seg_key(seg, n)) and vals_in is
//          unused (edge e's value is e); else keys_in and vals_in [E] are
//          the previous pass's output;
//   last:  with idx [E] given, also writes idx_out[j] = idx[vals_out[j]].
// table: int32 scratch of table_size >= 256 * (ceil(E / 4096) + 1) entries
// (the digit-major counts, then the 256 digit totals).
// Launches count, scan and scatter on `stream`; returns the first CUDA
// error, or cudaErrorInvalidValue for a table too small.
extern "C" int segment_sort_pass(const void* keys_in, const void* vals_in, int E, int n,
                                 int shift, int first, int last, const void* idx, void* table,
                                 long long table_size, void* keys_out, void* vals_out,
                                 void* idx_out, void* stream) {
  if (E <= 0) return 0;
  const int tiles = static_cast<int>((static_cast<long long>(E) + kSortTile - 1) / kSortTile);
  if (table_size < static_cast<long long>(kRadix) * (tiles + 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kin = static_cast<const int*>(keys_in);
  const int* vin = static_cast<const int*>(vals_in);
  const int* ix = static_cast<const int*>(idx);
  int* tbl = static_cast<int*>(table);
  int* totals = tbl + static_cast<size_t>(kRadix) * tiles;
  int* kout = static_cast<int*>(keys_out);
  int* vout = static_cast<int*>(vals_out);
  int* iout = static_cast<int*>(idx_out);
  if (first) {
    radix_count_kernel<true><<<tiles, kSortThreads, 0, s>>>(kin, E, n, shift, tiles, tbl);
  } else {
    radix_count_kernel<false><<<tiles, kSortThreads, 0, s>>>(kin, E, n, shift, tiles, tbl);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  radix_scan_kernel<<<kRadix, kSortThreads, 0, s>>>(tbl, tiles, totals);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (first && last) {
    launch_scatter<true, true>(kin, vin, E, n, shift, tiles, tbl, totals, ix, kout, vout, iout, s);
  } else if (first) {
    launch_scatter<true, false>(kin, vin, E, n, shift, tiles, tbl, totals, ix, kout, vout, iout, s);
  } else if (last) {
    launch_scatter<false, true>(kin, vin, E, n, shift, tiles, tbl, totals, ix, kout, vout, iout, s);
  } else {
    launch_scatter<false, false>(kin, vin, E, n, shift, tiles, tbl, totals, ix, kout, vout, iout, s);
  }
  return static_cast<int>(cudaGetLastError());
}
