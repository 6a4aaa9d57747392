// expand_rows: the reduce-side expansion of a probe, with the join step's
// column selection and -1 fill folded in.
//
// Replaces the Pallas `_expand_rows_kernel`
// (src/repro/kernels/scatter_pack.py:217, launched by `expand_rows` at
// :246/:276) and the epilogue that the reference's `_local_join`
// (src/repro/core/executor.py:594-602) runs on its output.  Per destination
// b, output slot t is left[li] ++ right[perm[lo[li] + t - off[li]]], li the
// last left row with off[li] <= t (clipped to [0, n_l)), the right position
// clipped to [0, n_r), off the exclusive scan of counts; valid = t < total.
// The output holds the columns `map.col` of that row: each < wl is a left
// column, each >= wl a column of rsel (below).  Slots past the total hold
// -1 (`fill`), or the clipped formula's row (`!fill`, the reference
// kernel's full output with the identity map).
//
// Bound: the (B, cap, n_cols) int32 output and the valid bytes; the reads
// (counts, the matched left rows, the right rows) are a few per cent of
// that.  Pure int32 copying: no tensor-core work.  The design:
//   1. off and total: a tiled scan of counts (tile sums, scan_rows over
//      the tile sums, a rescan of each tile from its base), as wide as the
//      data, not one block per destination;
//   2. rsel[b, p, j] = right[b, perm[b, p], rcol[j]] in one pass over the
//      n_r positions, only for the right columns that the map takes (the
//      TPU kernel's own pre-permute): the main pass then reads right rows
//      in order within each left row's window;
//   3. a merge path: each destination's output is the merge of the
//      non-decreasing off[0..n_l) with the slots 0..S, S = min(total, cap)
//      (a row precedes slot t when off[row] <= t).  The merge is cut into
//      tiles of EXPAND_TILE items (rows + slots) by one binary search per
//      tile boundary, so a tile's work is bounded however many zero-count
//      rows lie between matches and however long one row's window is;
//   4. one block per tile: the tile's off / (lo - off) window goes to
//      shared memory, each thread walks EXPAND_IPT items in order (no
//      search per slot) and leaves each slot's (li, position) in shared
//      memory, then the block writes its contiguous output span, consecutive
//      threads on consecutive words, and the span's valid bytes;
//   5. slots from S to cap: no search and no gather with `fill` (-1 and
//      valid 0); the clipped formula with li = n_l - 1 without.
#include "common.cuh"

#define EXPAND_THREADS 256
#define EXPAND_IPT 8
#define EXPAND_TILE (EXPAND_THREADS * EXPAND_IPT)
#define EXPAND_MAX_COLS 16
#define EXPAND_UNROLL 4
#define SCAN_THREADS 256
#define SCAN_ITEMS 8
#define SCAN_TILE (SCAN_THREADS * SCAN_ITEMS)

struct ExpandMap {
  int n_cols;                  // output columns
  int n_rsel;                  // columns of rsel
  unsigned magic;              // ceil(2^32 / n_cols): e / n_cols by umulhi
  int col[EXPAND_MAX_COLS];    // < wl: left column; else wl + rsel column
  int rcol[EXPAND_MAX_COLS];   // right column of each rsel column
};

// Exclusive scan of one int per thread over the block; *total gets the sum.
static __device__ __forceinline__ int block_exclusive_scan(int x, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(REPRO_FULL_MASK, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int ws = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(REPRO_FULL_MASK, ws, o);
      if (lane >= o) ws += y;
    }
    if (lane < n_warps) warp_sums[lane] = ws;
  }
  __syncthreads();
  *total = warp_sums[n_warps - 1];
  const int before = (warp > 0 ? warp_sums[warp - 1] : 0) + inc - x;
  __syncthreads();  // warp_sums is reused by the next call
  return before;
}

// 1a. tsum[b, tile] = sum of counts over the tile (SCAN_TILE entries).
static __global__ void scan_tile_sums_kernel(const int* counts, long long n_l,
                                             long long n_tiles, int* tsum) {
  const int b = blockIdx.y;
  const long long base = (long long)blockIdx.x * SCAN_TILE;
  const int* p = counts + (long long)b * n_l;
  int s = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const long long i = base + (long long)k * SCAN_THREADS + threadIdx.x;
    if (i < n_l) s += p[i];
  }
  int total;
  block_exclusive_scan(s, &total);
  if (threadIdx.x == 0) tsum[(long long)b * n_tiles + blockIdx.x] = total;
}

// 1c. off over one tile, from the tile's scanned base in tsum.  The tile
// goes through shared memory so that loads and stores stay coalesced while
// each thread scans SCAN_ITEMS consecutive entries.
static __global__ void scan_tile_rescan_kernel(const int* counts,
                                               long long n_l, long long n_tiles,
                                               const int* tbase, int* off) {
  __shared__ int s[SCAN_TILE + SCAN_TILE / 32];   // padded: no bank conflicts
  const int b = blockIdx.y;
  const long long base = (long long)blockIdx.x * SCAN_TILE;
  const int* p = counts + (long long)b * n_l;
  int* q = off + (long long)b * n_l;
  auto at = [](int i) { return i + (i >> 5); };
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int i = k * SCAN_THREADS + threadIdx.x;
    s[at(i)] = base + i < n_l ? p[base + i] : 0;
  }
  __syncthreads();
  int v[SCAN_ITEMS], sum = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    v[k] = s[at(threadIdx.x * SCAN_ITEMS + k)];
    sum += v[k];
  }
  int total;
  int run = block_exclusive_scan(sum, &total) +
            tbase[(long long)b * n_tiles + blockIdx.x];
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    s[at(threadIdx.x * SCAN_ITEMS + k)] = run;
    run += v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int i = k * SCAN_THREADS + threadIdx.x;
    if (base + i < n_l) q[base + i] = s[at(i)];
  }
}

// 2. rsel[b, p, j] = right[b, perm[b, p], rcol[j]].
static __global__ void prepermute_kernel(const int* right, const int* perm,
                                         long long n_r, int wr,
                                         const __grid_constant__ ExpandMap map,
                                         int* rsel) {
  const int b = blockIdx.y;
  const int w = map.n_rsel;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_r * w) return;
  const long long p = e / w;
  const int j = (int)(e - p * w);
  const long long src = perm[(long long)b * n_r + p];
  rsel[(long long)b * n_r * w + e] =
      right[((long long)b * n_r + src) * wr + map.rcol[j]];
}

// Items of destination b's merge: every left row and the S = min(total,
// cap) slots; none when there is no slot.
static __device__ __forceinline__ long long merge_items(long long n_l,
                                                        long long cap,
                                                        int total,
                                                        long long* S) {
  *S = total < cap ? (long long)total : cap;
  return *S > 0 ? n_l + *S : 0;
}

// Rows among the first d items of the merge of a[0..n_a) (non-decreasing)
// with the slots j_base + [0, n_b): the least i with a[i] > j_base + d - i
// - 1, searched over [max(0, d - n_b), min(d, n_a)].
template <class A>
static __device__ __forceinline__ long long merge_split(A a, long long n_a,
                                                        long long j_base,
                                                        long long n_b,
                                                        long long d) {
  long long lo = d - n_b > 0 ? d - n_b : 0;
  long long hi = d < n_a ? d : n_a;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if ((long long)a(mid) <= j_base + d - mid - 1) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// 3. splits[b, k] = rows among the first k * EXPAND_TILE items (the item
// count for k past the end), k in [0, n_tiles].
static __global__ void merge_partition_kernel(const int* off, const int* total,
                                              long long n_l, long long cap,
                                              long long n_tiles,
                                              long long* splits) {
  const int b = blockIdx.y;
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k > n_tiles) return;
  long long S;
  const long long n_items = merge_items(n_l, cap, total[b], &S);
  long long d = k * EXPAND_TILE;
  if (d > n_items) d = n_items;
  const int* boff = off + (long long)b * n_l;
  splits[(long long)b * (n_tiles + 1) + k] =
      n_items == 0 ? 0
                   : merge_split([&](long long i) { return boff[i]; }, n_l, 0,
                                 S, d);
}

// e / n_cols for 0 <= e < EXPAND_TILE * EXPAND_MAX_COLS: the high word of
// e * ceil(2^32 / n_cols) (exact while e * n_cols < 2^32).
static __device__ __forceinline__ int slot_of(int e, const ExpandMap& map) {
  return map.n_cols == 1 ? e : (int)__umulhi((unsigned)e, map.magic);
}

static __device__ __forceinline__ long long clip(long long x, long long n) {
  return x < 0 ? 0 : (x > n - 1 ? n - 1 : x);
}

// The value of output column c (map.col[c] = col) of a slot with left row li
// and right position pos.
static __device__ __forceinline__ int slot_value(const int* left,
                                                 const int* rsel, int wl,
                                                 int n_rsel, long long li,
                                                 long long pos, int col) {
  return col < wl ? left[li * wl + col] : rsel[pos * n_rsel + col - wl];
}

// 4. One block per merge tile of one destination.
static __global__ void __launch_bounds__(EXPAND_THREADS)
expand_tile_kernel(const int* left, const int* rsel, const int* off,
                   const int* lo, const int* total, const long long* splits,
                   long long n_l, int wl, long long n_r, long long cap,
                   long long n_tiles,
                   const __grid_constant__ ExpandMap map, int* out,
                   unsigned char* valid) {
  // Row x of the tile (global row i0 + x, x in [-1, n_a)) at x + 1.
  __shared__ int s_off[EXPAND_TILE + 1];
  __shared__ int s_base[EXPAND_TILE + 1];   // lo - off
  __shared__ int s_li[EXPAND_TILE];         // per slot of the tile
  __shared__ int s_pos[EXPAND_TILE];
  __shared__ int s_col[EXPAND_MAX_COLS];
  const int b = blockIdx.y;
  long long S;
  const long long n_items = merge_items(n_l, cap, total[b], &S);
  const long long d0 = (long long)blockIdx.x * EXPAND_TILE;
  if (d0 >= n_items) return;
  const long long d1 = d0 + EXPAND_TILE < n_items ? d0 + EXPAND_TILE : n_items;
  const long long* bs = splits + (long long)b * (n_tiles + 1);
  const long long i0 = bs[blockIdx.x], i1 = bs[blockIdx.x + 1];
  const long long j0 = d0 - i0;
  const int n_a = (int)(i1 - i0), n_b = (int)(d1 - i1 - j0);
  const int* boff = off + (long long)b * n_l;
  const int* blo = lo + (long long)b * n_l;
  if (threadIdx.x < EXPAND_MAX_COLS) s_col[threadIdx.x] = map.col[threadIdx.x];
  for (int x = (int)threadIdx.x - 1; x < n_a; x += EXPAND_THREADS) {
    const long long i = i0 + x;
    if (i >= 0) {
      s_off[x + 1] = boff[i];
      s_base[x + 1] = blo[i] - boff[i];
    }
  }
  __syncthreads();

  // This thread's items: [dd, dd + EXPAND_IPT) of the tile, in merge order.
  const int n_tile = n_a + n_b;
  const int dd = (int)threadIdx.x * EXPAND_IPT;
  if (dd < n_tile) {
    int ia = (int)merge_split([&](long long x) { return s_off[x + 1]; }, n_a,
                              j0, n_b, dd);
    int ja = dd - ia;
    long long li = i0 + ia - 1;
    int base = s_base[ia];
    const int end = dd + EXPAND_IPT < n_tile ? dd + EXPAND_IPT : n_tile;
    for (int item = dd; item < end; ++item) {
      if (ia < n_a && (ja >= n_b || (long long)s_off[ia + 1] <= j0 + ja)) {
        li = i0 + ia;
        base = s_base[++ia];
      } else {
        s_li[ja] = (int)li;
        s_pos[ja] = (int)clip((long long)base + j0 + ja, n_r);
        ++ja;
      }
    }
  }
  __syncthreads();

  // The tile's slots [j0, j0 + n_b): a contiguous span of the output,
  // EXPAND_UNROLL words a thread at a time, their loads issued before
  // their stores.
  const int nc = map.n_cols;
  const int* bleft = left + (long long)b * n_l * wl;
  const int* brsel = rsel + (long long)b * n_r * map.n_rsel;
  int* o = out + ((long long)b * cap + j0) * nc;
  const int n_el = n_b * nc;
  for (int e0 = threadIdx.x; e0 < n_el;
       e0 += EXPAND_THREADS * EXPAND_UNROLL) {
    int v[EXPAND_UNROLL];
#pragma unroll
    for (int u = 0; u < EXPAND_UNROLL; ++u) {
      const int e = e0 + u * EXPAND_THREADS;
      if (e < n_el) {
        const int s = slot_of(e, map);
        v[u] = slot_value(bleft, brsel, wl, map.n_rsel, s_li[s], s_pos[s],
                          s_col[e - s * nc]);
      }
    }
#pragma unroll
    for (int u = 0; u < EXPAND_UNROLL; ++u) {
      const int e = e0 + u * EXPAND_THREADS;
      if (e < n_el) o[e] = v[u];
    }
  }
  unsigned char* v = valid + (long long)b * cap + j0;
  for (int x = threadIdx.x; x < n_b; x += EXPAND_THREADS) v[x] = 1;
}

// 5. Slots [S, cap) of each destination: -1 and valid 0 (`fill`), or the
// clipped formula's row with li = n_l - 1.
static __global__ void __launch_bounds__(EXPAND_THREADS)
expand_tail_kernel(const int* left, const int* rsel, const int* off,
                   const int* lo, const int* total, long long n_l, int wl,
                   long long n_r, long long cap,
                   const __grid_constant__ ExpandMap map, int fill,
                   int* out, unsigned char* valid) {
  const int b = blockIdx.y;
  long long S;
  merge_items(n_l, cap, total[b], &S);
  long long t0 = (long long)blockIdx.x * EXPAND_TILE;
  long long t1 = t0 + EXPAND_TILE < cap ? t0 + EXPAND_TILE : cap;
  if (t0 < S) t0 = S;
  if (t0 >= t1) return;
  const int nc = map.n_cols;
  const int n_el = (int)(t1 - t0) * nc;
  int* o = out + ((long long)b * cap + t0) * nc;
  if (fill) {
    for (int e = threadIdx.x; e < n_el; e += EXPAND_THREADS) o[e] = -1;
  } else {
    const long long li = n_l - 1;
    const long long base = (long long)lo[(long long)b * n_l + li] -
                           off[(long long)b * n_l + li];
    const int* bleft = left + (long long)b * n_l * wl;
    const int* brsel = rsel + (long long)b * n_r * map.n_rsel;
    for (int e = threadIdx.x; e < n_el; e += EXPAND_THREADS) {
      const int s = slot_of(e, map);
      o[e] = slot_value(bleft, brsel, wl, map.n_rsel, li,
                        clip(base + t0 + s, n_r), map.col[e - s * nc]);
    }
  }
  unsigned char* v = valid + (long long)b * cap;
  for (long long t = t0 + threadIdx.x; t < t1; t += EXPAND_THREADS) v[t] = 0;
}

// cols: n_cols output columns (< wl left, else wl + right column); fill:
// -1 past the total (else the clipped formula).  Scratch from the wrapper:
// tsum (B, n_scan_tiles), off (B, n_l), total (B,), rsel (B, n_r, n_rsel)
// for the n_rsel distinct right columns that cols takes (rcols), splits
// (B, n_tiles + 1) int64.
extern "C" int expand_rows_launch(const int* left, const int* right,
                                  const int* counts, const int* lo,
                                  const int* perm, int B, long long n_l,
                                  int wl, long long n_r, int wr, long long cap,
                                  const int* cols, int n_cols,
                                  const int* rcols, int n_rsel, int fill,
                                  long long n_scan_tiles, int* tsum, int* off,
                                  int* total, int* rsel, long long n_tiles,
                                  long long* splits, int* out,
                                  unsigned char* valid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_cols < 1 || n_cols > EXPAND_MAX_COLS || n_rsel < 0 ||
      n_rsel > EXPAND_MAX_COLS)
    return (int)cudaErrorInvalidValue;
  ExpandMap map{};
  map.n_cols = n_cols;
  map.n_rsel = n_rsel;
  map.magic = (unsigned)((0x100000000ULL + n_cols - 1) / n_cols);
  for (int c = 0; c < n_cols; ++c) map.col[c] = cols[c];
  for (int j = 0; j < n_rsel; ++j) map.rcol[j] = rcols[j];
  cudaError_t err;
  // 1. off, total.
  scan_tile_sums_kernel<<<dim3((unsigned)n_scan_tiles, B), SCAN_THREADS, 0,
                          s>>>(counts, n_l, n_scan_tiles, tsum);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = launch_scan_rows(tsum, B, n_scan_tiles, 1, 1, total, s)) !=
      cudaSuccess)
    return (int)err;
  scan_tile_rescan_kernel<<<dim3((unsigned)n_scan_tiles, B), SCAN_THREADS,
                            0, s>>>(counts, n_l, n_scan_tiles, tsum, off);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 2. rsel.
  if (n_rsel > 0) {
    prepermute_kernel<<<dim3(blocks_for(n_r * n_rsel, EXPAND_THREADS), B),
                        EXPAND_THREADS, 0, s>>>(right, perm, n_r, wr, map,
                                                rsel);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // 3. merge partition.
  merge_partition_kernel<<<dim3(blocks_for(n_tiles + 1, EXPAND_THREADS), B),
                           EXPAND_THREADS, 0, s>>>(off, total, n_l, cap,
                                                   n_tiles, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 4. merge tiles; 5. slots past the total.
  expand_tile_kernel<<<dim3((unsigned)n_tiles, B), EXPAND_THREADS, 0, s>>>(
      left, rsel, off, lo, total, splits, n_l, wl, n_r, cap, n_tiles, map, out,
      valid);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  expand_tail_kernel<<<dim3(blocks_for(cap, EXPAND_TILE), B), EXPAND_THREADS,
                       0, s>>>(left, rsel, off, lo, total, n_l, wl, n_r, cap,
                               map, fill, out, valid);
  return (int)cudaGetLastError();
}
