// Stable sort of segment ids on the card: an LSD radix sort with digits of
// at most 8 bits.
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
// The wrapper runs ceil(bits(n) / 8) passes and splits bits(n) evenly
// among them (3 passes of 6 bits at n = 150,000: 64 digits a pass, not
// 256, 256 and 4). A pass is three kernels:
//   1. count: each tile of kSortTile keys loads its keys at once and counts
//      its digits in shared memory (one integer add per warp and digit),
//      into the digit-major table tbl[d * tiles + t];
//   2. scan: one block per digit turns its row of the table into its
//      exclusive prefix sum over the tiles, and writes the row's total;
//   3. scatter: each block scans the digit totals (the first output slot of
//      each digit); each warp ranks its keys stably (rounds of 32 keys in
//      index order; one ballot per digit bit groups equal digits, a
//      popcount of the lower lanes ranks within a round, per-warp digit
//      counters carry across rounds); the warps' counts are combined in
//      warp order into each key's slot in the tile sorted by digit; the
//      block stages keys and edge ids there in shared memory, then writes
//      each digit's run of the tile to consecutive output slots (digit's
//      first slot + tbl[d][t] + the place in the run), so the writes
//      coalesce instead of landing 4 bytes at a time all over the output.
// Together, steps 2 and 3 take the exclusive scan of the whole digit-major
// table in parallel (one block scanning all of it is serial).
// The first pass reads the raw ids and takes the edge ids from the position;
// the last may also write idx[perm] for the gather form. A single counting
// pass over n + 1 bins would need tiles x (n + 1) counters to be stable.
//
// Bound by bytes: a pass reads the keys twice and the edge ids once, and
// writes keys and edge ids once. At 1.05 M ids (n = 150,000, H100) the
// sort takes 0.064 ms, against 0.136 for the first design (8-bit digits,
// each key written straight to its slot) and torch.sort's 0.11; its
// scatter 0.011 ms a pass, its count 0.006. Integer counts only and no
// dependence on block order: the permutation is a function of the input,
// and no pass waits for the host, so a CUDA graph can capture the whole
// sort. Not taken: wider digits (9 bits would sort n = 150,000 in two
// passes, but the pass count is fixed by sort_passes and the card's launch
// counts), and a count fused into the scatter through a chained look-back
// scan (each block would wait on its predecessors' counts, a hand-over
// between blocks in flight, for a pass of one kernel where the card tests
// pin three; the count is 0.006 of the pass's 0.019 ms).
//
// Built with -DREPRO_SORT_JITTER (tools/sanitize_sort.py --jitter), every
// thread sleeps a pseudo-random 0-1023 ns at each point where data passes
// between lanes, warps or blocks, so that a missing barrier changes the
// permutation instead of hiding behind a lucky schedule. Built with
// -DREPRO_SORT_DROP=k as well, the scatter's barrier k is left out: a
// mutant that the jittered runs must catch (tools/sanitize_sort.py --drop).
#include "common.cuh"

namespace repro_torch {

constexpr int kRadix = 256;  // digits of at most 8 bits
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

// The scatter's barrier K, left out in a -DREPRO_SORT_DROP=K build.
template <int K>
__device__ __forceinline__ void scatter_barrier() {
#ifdef REPRO_SORT_DROP
  if (K == REPRO_SORT_DROP) return;
#endif
  __syncthreads();
}

// Exclusive prefix sum of one int per thread over a kSortThreads block;
// `warp_sums` is kSortWarps ints of shared memory, `total` gets the sum.
// Every thread of the block must call it; it starts and ends with a
// barrier's worth of ordering (shared writes before it are seen after it).
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

__device__ __forceinline__ int digit_of(int key, int shift, int mask) {
  return (key >> shift) & mask;
}

// The lanes of the warp whose digit equals this lane's (d < 2^bits, or
// kNoDigit for a lane past the keys): one ballot per bit of the digit and
// one for kNoDigit's bit, as CUB's radix rank matches its labels. With
// __match_any_sync instead the sort of the stand-in's 1.05 M ids took
// 0.071 ms, with the ballots 0.064 (tools/chunk_sweep.py, H100).
__device__ __forceinline__ unsigned match_digit(int d, int bits) {
  const bool none = d == kNoDigit;
  const unsigned lanes = __ballot_sync(0xffffffffu, none);
  unsigned peers = none ? lanes : ~lanes;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    if (b < bits) {  // the same for every lane
      const bool one = (d >> b) & 1;
      const unsigned vote = __ballot_sync(0xffffffffu, one);
      peers &= one ? vote : ~vote;
    }
  }
  return peers;
}

template <bool FIRST>
__global__ void __launch_bounds__(kSortThreads)
    radix_count_kernel(const int* __restrict__ keys, int E, int n, int shift, int bits, int tiles,
                       int* __restrict__ tbl) {
  __shared__ int hist[kRadix];
  hist[threadIdx.x] = 0;
  const int lane = threadIdx.x & 31;
  const int mask = (1 << bits) - 1;
  const long long start = static_cast<long long>(blockIdx.x) * kSortTile + threadIdx.x;
  int d[kSortItems];
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {  // every load of the tile in flight at once
    const long long e = start + r * kSortThreads;
    d[r] = e < E ? digit_of(load_key<FIRST>(keys, e, n), shift, mask) : kNoDigit;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const unsigned peers = match_digit(d[r], bits);
    jitter(r);
    if (d[r] != kNoDigit && lane == __ffs(peers) - 1) atomicAdd(&hist[d[r]], __popc(peers));
  }
  __syncthreads();
  jitter(0);
  if (threadIdx.x <= mask) tbl[static_cast<size_t>(threadIdx.x) * tiles + blockIdx.x] = hist[threadIdx.x];
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

// Three blocks an SM (85 registers a thread: the keys and ranks of 16 keys
// in registers, the edge ids read when staged), 37 KB of shared memory a
// block.
template <bool FIRST, bool LAST>
__global__ void __launch_bounds__(kSortThreads, 3)
    radix_scatter_kernel(const int* __restrict__ keys_in, const int* __restrict__ vals_in, int E,
                         int n, int shift, int bits, int tiles, const int* __restrict__ tbl,
                         const int* __restrict__ totals, const int* __restrict__ idx,
                         int* __restrict__ keys_out, int* __restrict__ vals_out,
                         int* __restrict__ idx_out) {
  __shared__ int skey[kSortTile];  // the tile's keys and edge ids in digit order
  __shared__ int sval[kSortTile];
  // per warp and digit: the warp's count, then its keys' first slot in the tile
  __shared__ unsigned short first_slot[kSortWarps][kRadix];
  __shared__ int to_global[kRadix];  // per digit: output slot - tile slot
  __shared__ int warp_sums[kSortWarps];
  const int mask = (1 << bits) - 1;
  for (int w = 0; w < kSortWarps; ++w) first_slot[w][threadIdx.x] = 0;
  int all;
  // the first output slot of digit threadIdx.x: the keys of smaller digits
  // (the scan's barriers also publish the zeroed counters)
  const int digit_first =
      block_exclusive_scan(threadIdx.x <= mask ? totals[threadIdx.x] : 0, warp_sums, &all);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const long long tile = static_cast<long long>(blockIdx.x) * kSortTile;
  const long long first = tile + warp * kWarpKeys + lane;
  int key[kSortItems], rank[kSortItems];
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const long long e = first + r * 32;
    key[r] = e < E ? load_key<FIRST>(keys_in, e, n) : 0;
  }
  unsigned short* count = first_slot[warp];
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const bool ok = first + r * 32 < E;
    const int d = ok ? digit_of(key[r], shift, mask) : kNoDigit;
    const unsigned peers = match_digit(d, bits);
    const int before = count[ok ? d : 0];  // a lane past the keys reads a real slot, unused
    jitter(r);
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) count[d] = static_cast<unsigned short>(before + __popc(peers));
    jitter(r + kSortItems);
    __syncwarp();
    rank[r] = ok ? before + __popc(peers & below) : -1;
  }
  jitter(1);
  scatter_barrier<1>();
  {
    // digit d: each warp's first place in the digit's run (warp order), the
    // run's first slot in the tile, and where the run goes in the output
    const int d = threadIdx.x;
    int run = 0;
    for (int w = 0; w < kSortWarps; ++w) {
      const int c = first_slot[w][d];
      first_slot[w][d] = static_cast<unsigned short>(run);
      run += c;
    }
    int tile_keys;
    const int local = block_exclusive_scan(run, warp_sums, &tile_keys);
    jitter(2);
    for (int w = 0; w < kSortWarps; ++w) {
      first_slot[w][d] = static_cast<unsigned short>(first_slot[w][d] + local);
    }
    if (d <= mask) to_global[d] = digit_first + tbl[static_cast<size_t>(d) * tiles + blockIdx.x] - local;
  }
  scatter_barrier<2>();
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    if (rank[r] < 0) continue;
    const int slot = count[digit_of(key[r], shift, mask)] + rank[r];
    const long long e = first + r * 32;
    jitter(slot);
    skey[slot] = key[r];
    sval[slot] = FIRST ? static_cast<int>(e) : vals_in[e];
  }
  scatter_barrier<3>();
  jitter(3);
  const int valid = static_cast<int>(min(static_cast<long long>(kSortTile), E - tile));
  for (int i = threadIdx.x; i < valid; i += kSortThreads) {
    const int k = skey[i];
    const int v = sval[i];
    const int dst = to_global[digit_of(k, shift, mask)] + i;
    keys_out[dst] = k;
    vals_out[dst] = v;
    if constexpr (LAST) {
      if (idx != nullptr) idx_out[dst] = idx[v];
    }
  }
}

template <bool FIRST, bool LAST>
static void launch_scatter(const int* keys_in, const int* vals_in, int E, int n, int shift,
                           int bits, int tiles, const int* tbl, const int* totals, const int* idx,
                           int* keys_out, int* vals_out, int* idx_out, cudaStream_t s) {
  radix_scatter_kernel<FIRST, LAST><<<tiles, kSortThreads, 0, s>>>(
      keys_in, vals_in, E, n, shift, bits, tiles, tbl, totals, idx, keys_out, vals_out, idx_out);
}

}  // namespace repro_torch

using namespace repro_torch;

// One pass of the sort, by the `bits`-wide digit (1..8) at bit `shift`,
// over E > 0 keys:
//   first: keys_in is the raw seg [E] (keys seg_key(seg, n)) and vals_in is
//          unused (edge e's value is e); else keys_in and vals_in [E] are
//          the previous pass's output;
//   last:  with idx [E] given, also writes idx_out[j] = idx[vals_out[j]].
// table: int32 scratch of table_size >= 2^bits * (ceil(E / 4096) + 1)
// entries (the digit-major counts, then the digit totals).
// Launches count, scan and scatter on `stream`; returns the first CUDA
// error, or cudaErrorInvalidValue for a table too small or a bad width.
extern "C" int segment_sort_pass(const void* keys_in, const void* vals_in, int E, int n,
                                 int shift, int bits, int first, int last, const void* idx,
                                 void* table, long long table_size, void* keys_out,
                                 void* vals_out, void* idx_out, void* stream) {
  if (E <= 0) return 0;
  if (bits < 1 || bits > 8 || shift < 0 || shift > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int radix = 1 << bits;
  const int tiles = static_cast<int>((static_cast<long long>(E) + kSortTile - 1) / kSortTile);
  if (table_size < static_cast<long long>(radix) * (tiles + 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kin = static_cast<const int*>(keys_in);
  const int* vin = static_cast<const int*>(vals_in);
  const int* ix = static_cast<const int*>(idx);
  int* tbl = static_cast<int*>(table);
  int* totals = tbl + static_cast<size_t>(radix) * tiles;
  int* kout = static_cast<int*>(keys_out);
  int* vout = static_cast<int*>(vals_out);
  int* iout = static_cast<int*>(idx_out);
  if (first) {
    radix_count_kernel<true><<<tiles, kSortThreads, 0, s>>>(kin, E, n, shift, bits, tiles, tbl);
  } else {
    radix_count_kernel<false><<<tiles, kSortThreads, 0, s>>>(kin, E, n, shift, bits, tiles, tbl);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  radix_scan_kernel<<<radix, kSortThreads, 0, s>>>(tbl, tiles, totals);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
#define REPRO_SCATTER(F, L) \
  launch_scatter<F, L>(kin, vin, E, n, shift, bits, tiles, tbl, totals, ix, kout, vout, iout, s)
  if (first && last) {
    REPRO_SCATTER(true, true);
  } else if (first) {
    REPRO_SCATTER(true, false);
  } else if (last) {
    REPRO_SCATTER(false, true);
  } else {
    REPRO_SCATTER(false, false);
  }
#undef REPRO_SCATTER
  return static_cast<int>(cudaGetLastError());
}
