// bucket_rank / bucket_pack: the staged map's stable counting-sort pack.
//
// Replaces the Pallas `_bucket_rank_kernel` (src/repro/kernels/bucket_pack.py:57,
// launched by `bucket_rank` at :84, its pallas_call at :97) and the assembly
// of `bucket_pack` (`_assemble` at :141, called at :162).  Per batch row b
// (one source shard), item i of dest[b] is a member of bin d = dest when
// dest is in [0, k); bucket_rank also puts every other item in a sentinel
// bin k.  rank[b, i] is the item's stable arrival rank within its bin and
// hist[b, d] (d < k) the bin's size.  bucket_pack writes rows[b, i] to
// buf[b, d, rank] for members with rank < cap, -1 everywhere else in the
// (B, k, cap, w) buffer, and overflow[b] = sum_d max(hist - cap, 0).  The
// ranks are exactly the reference's, so overflow drops the same copies.
//
// Bound: reading dest once and the kept members' rows, and writing the
// whole buffer (records and -1 fill).  The TPU kernel carries its histogram
// across a grid that runs in order; CUDA blocks run in no order, so a bin's
// base in each tile comes from a count pass and a scan over tiles, and this
// design reads dest twice, once a pass: a tile's counts must be known
// before any later tile can place a copy.  At the full-size two_way cell
// only about 6 % of the copies are members, so the work follows them:
//   1. count (bucket_count_kernel): a block of BUCKET_THREADS threads takes
//      a tile of BUCKET_TILE_ITEMS items of one row's dest, read with
//      16-byte loads where the row is aligned, and counts its members per
//      bin in shared memory (bucket_rank: every item, with the sentinel).
//      A warp whose 32 items are all outside [0, k) skips the match and the
//      counters.  The counts go bin-major to th[b, d, tile].
//   2. an exclusive scan of th over tiles per (b, d) (common.cuh's
//      launch_scan_rows): each tile's base per bin; the totals are hist.
//   3. rank and write (bucket_rank_kernel), the same tiles: warp v holds
//      the v-th eighth of the tile in registers and walks it once, 32 items
//      a round, counting per (bin, warp) in shared memory and keeping each
//      member's rank among its warp's items of the bin; the (bin, warp)
//      counts are scanned bin-major, which places every member in bin order
//      in the tile.  bucket_rank writes each item's rank (its tile's base
//      plus its place in the bin).  bucket_pack writes no rank: the tile's
//      members are listed in bin order in shared memory, and each bin's run
//      [base_d, base_d + n_d) ∩ [0, cap) is written as consecutive w-word
//      records, consecutive threads on consecutive words, each word read
//      from rows in place.  Copying the records into shared memory first
//      (by plain loads after the walk, or by cp.async as soon as the bins
//      are known) measured slower on an H100: the members are scattered,
//      so staging saves no bytes and adds a pass and a barrier.
//   4. fill (common.cuh's scatter_fill_kernel): -1 into slots
//      [min(hist, cap), cap) of each (b, d), the only slots no record
//      reaches;
//   5. overflow from hist (common.cuh's bins_overflow_kernel).
// Limits (mirrored by kernels/bucket_pack.py::bucket_geometry): any w >= 1,
// since records are copied in place.  The counters sit in shared memory for
// up to BUCKET_SHARED_BINS bins (k, or k + 1 with the sentinel): 36 bytes a
// bin and the 8 KB list of members, 152 KiB at the limit.  Past that, one
// warp walks each tile with its counters read in place in th (device
// memory) and each member's record written by its lane (bucket_warp_kernel).
#include "common.cuh"

#include <cub/block/block_scan.cuh>
#include <stdint.h>

#define BUCKET_THREADS 256
#define BUCKET_WARPS (BUCKET_THREADS / 32)
#define BUCKET_TILE_ITEMS 2048
#define BUCKET_SHARED_BINS 4096

using BucketScan = cub::BlockScan<int, BUCKET_THREADS>;

// In-place exclusive scan of a[0, len) in shared memory by the whole block
// (each thread a contiguous run); returns the total.  The caller's barrier
// must precede it; it ends with the block in step.
__device__ __forceinline__ int bucket_block_scan(
    int* a, int len, typename BucketScan::TempStorage& tmp) {
  const int per = (len + BUCKET_THREADS - 1) / BUCKET_THREADS;
  const int b = min((int)threadIdx.x * per, len), e = min(b + per, len);
  int s = 0;
  for (int i = b; i < e; ++i) s += a[i];
  int run, total;
  BucketScan(tmp).ExclusiveSum(s, run, total);
  for (int i = b; i < e; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
  return total;
}

// The bin of an item: -1 for a lane past the tile (`in` false); a value in
// [0, k) is its own bin; any other value `other` (-1: none, k: the
// sentinel).
__device__ __forceinline__ int bucket_bin(int v, bool in, int k, int other) {
  return !in ? -1 : v >= 0 && v < k ? v : other;
}

// Stage 1: per-tile bin counts, th[b, d, tile].  Each thread counts four
// consecutive items at a time, read with one 16-byte load where the row is
// aligned.
static __global__ void __launch_bounds__(BUCKET_THREADS)
bucket_count_kernel(const int* dest, long long m, int k, int n_bins,
                    long long n_tiles, int* th) {
  extern __shared__ int cnt[];  // n_bins
  for (int d = threadIdx.x; d < n_bins; d += blockDim.x) cnt[d] = 0;
  __syncthreads();
  const long long b = blockIdx.x / n_tiles, t = blockIdx.x % n_tiles;
  const long long i0 = t * BUCKET_TILE_ITEMS;
  const int n = (int)(m - i0 < BUCKET_TILE_ITEMS ? m - i0 : BUCKET_TILE_ITEMS);
  const int* p = dest + b * m + i0;
  const bool aligned = (((uintptr_t)p) & 15) == 0;
  const int other = n_bins > k ? k : -1;
  constexpr int kVec = BUCKET_TILE_ITEMS / (4 * BUCKET_THREADS);
  int4 v[kVec];
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const int i = 4 * (u * BUCKET_THREADS + (int)threadIdx.x);
    if (aligned && i + 4 <= n) {
      v[u] = *reinterpret_cast<const int4*>(p + i);
    } else {
      v[u].x = i < n ? p[i] : 0;
      v[u].y = i + 1 < n ? p[i + 1] : 0;
      v[u].z = i + 2 < n ? p[i + 2] : 0;
      v[u].w = i + 3 < n ? p[i + 3] : 0;
    }
  }
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const int i = 4 * (u * BUCKET_THREADS + (int)threadIdx.x);
    bucket_count_warp(bucket_bin(v[u].x, i < n, k, other), cnt);
    bucket_count_warp(bucket_bin(v[u].y, i + 1 < n, k, other), cnt);
    bucket_count_warp(bucket_bin(v[u].z, i + 2 < n, k, other), cnt);
    bucket_count_warp(bucket_bin(v[u].w, i + 3 < n, k, other), cnt);
  }
  __syncthreads();
  int* col = th + b * n_bins * n_tiles + t;  // th[b, d, t] = col[d * n_tiles]
  for (int d = threadIdx.x; d < n_bins; d += blockDim.x)
    col[(long long)d * n_tiles] = cnt[d];
}

// Stage 3: rank the tile's items (kPack false: every item, ranks written)
// or its members (kPack: records written in bin order).  Warp v owns the
// v-th eighth of the tile; lane l holds items c * 32 + l of it, c < kChunks,
// in registers.
template <bool kPack>
static __global__ void __launch_bounds__(BUCKET_THREADS)
bucket_rank_kernel(const int* dest, const int* __restrict__ rows, long long m,
                   int w, int k, int cap, long long n_tiles, const int* th,
                   int* rank, int* buf) {
  constexpr int kChunks = BUCKET_TILE_ITEMS / BUCKET_THREADS;
  constexpr int kShare = 32 * kChunks;
  extern __shared__ int smem[];
  __shared__ typename BucketScan::TempStorage scan_tmp;
  const int n_bins = kPack ? k : k + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* cnt = smem;                               // n_bins x warps, bin-major
  int* run_base = cnt + n_bins * BUCKET_WARPS;   // n_bins: the tile's bases
  int* perm = run_base + n_bins;                 // tile: bin << 16 | item

  const long long b = blockIdx.x / n_tiles, t = blockIdx.x % n_tiles;
  const long long i0 = t * BUCKET_TILE_ITEMS;
  const int n = (int)(m - i0 < BUCKET_TILE_ITEMS ? m - i0 : BUCKET_TILE_ITEMS);
  const int e0 = warp * kShare;
  const int* p = dest + b * m + i0 + e0;
  int d[kChunks], lr[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const bool in = e0 + c * 32 + lane < n;
    d[c] = bucket_bin(in ? p[c * 32 + lane] : 0, in, k, kPack ? -1 : k);
    lr[c] = 0;
  }
  for (int i = threadIdx.x; i < n_bins * BUCKET_WARPS; i += blockDim.x)
    cnt[i] = 0;
  const int* tb = th + b * n_bins * n_tiles + t;
  for (int x = threadIdx.x; x < n_bins; x += blockDim.x)
    run_base[x] = tb[(long long)x * n_tiles];
  __syncthreads();

  // lr: a member's rank among the warp's items of its bin; cnt[d, warp]:
  // the warp's count of bin d.
  const unsigned lt = lanemask_lt();
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (!__ballot_sync(REPRO_FULL_MASK, d[c] >= 0)) continue;
    const unsigned same = __match_any_sync(REPRO_FULL_MASK, d[c]);
    const int base = d[c] >= 0 ? cnt[d[c] * BUCKET_WARPS + warp] : 0;
    lr[c] = base + __popc(same & lt);
    __syncwarp();
    if (d[c] >= 0 && lane == __ffs(same) - 1)
      cnt[d[c] * BUCKET_WARPS + warp] = base + __popc(same);
    __syncwarp();
  }
  __syncthreads();
  // cnt[d, warp] becomes the place of the warp's first item of bin d in the
  // tile's bin order; cnt[d, 0] is where bin d's run starts.
  const int n_members = bucket_block_scan(cnt, n_bins * BUCKET_WARPS,
                                          scan_tmp);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (d[c] < 0) continue;
    const int e = e0 + c * 32 + lane;
    const int pos = cnt[d[c] * BUCKET_WARPS + warp] + lr[c];
    if constexpr (kPack)
      perm[pos] = d[c] << 16 | e;
    else
      rank[b * m + i0 + e] = run_base[d[c]] + pos - cnt[d[c] * BUCKET_WARPS];
  }
  if constexpr (kPack) {
    __syncthreads();
    // Word i of the tile's records in bin order is column col of position
    // q, item e of bin d at rank run_base[d] + q - (start of d); (q, col)
    // advance by the block's stride without a division.
    const int* trows = rows + (b * m + i0) * w;
    int* out = buf + b * k * (long long)cap * w;
    const int q_step = BUCKET_THREADS / w, col_step = BUCKET_THREADS % w;
    int q = threadIdx.x / w, col = threadIdx.x % w;
    for (int i = threadIdx.x; i < n_members * w; i += BUCKET_THREADS) {
      const int pe = perm[q];
      const int dq = pe >> 16, e = pe & 0xffff;
      const int r = run_base[dq] + q - cnt[dq * BUCKET_WARPS];
      if (r < cap)
        out[((long long)dq * cap + r) * w + col] =
            __ldg(trows + (long long)e * w + col);
      q += q_step;
      col += col_step;
      if (col >= w) {
        col -= w;
        ++q;
      }
    }
  }
}

// Past BUCKET_SHARED_BINS bins: one warp a tile, its counters th[b, d, t]
// read and written in place (zeroed before the count pass, scanned before
// the rank pass), with common.cuh's warp_tile_walk.  buf == nullptr: every
// item has a bin (the sentinel k) and its rank is written; else members'
// records with rank < cap are written by their lanes.
template <bool kRankPass>
static __global__ void bucket_warp_kernel(const int* dest, const int* rows,
                                          int B, long long m, int w, int k,
                                          int cap, long long n_tiles, int* th,
                                          int* rank, int* buf) {
  const long long gw =
      (long long)blockIdx.x * BUCKET_WARPS + (threadIdx.x >> 5);
  if (gw >= (long long)B * n_tiles) return;
  const long long b = gw / n_tiles, t = gw % n_tiles;
  const int n_bins = buf != nullptr ? k : k + 1;
  int* col = th + b * n_bins * n_tiles + t;
  const int* bdest = dest + b * m;
  const long long i1 =
      (t + 1) * BUCKET_TILE_ITEMS < m ? (t + 1) * BUCKET_TILE_ITEMS : m;
  auto bin = [&](long long i) {
    return bucket_bin(bdest[i], true, k, buf != nullptr ? -1 : k);
  };
  auto counter = [&](int d) -> int& { return col[(long long)d * n_tiles]; };
  if constexpr (kRankPass) {
    warp_tile_walk<true>(t * BUCKET_TILE_ITEMS, i1, bin, counter,
                         [&](long long i, int d, int r) {
      if (buf == nullptr) {
        rank[b * m + i] = r;
      } else if (r < cap) {
        const int* src = rows + (b * m + i) * w;
        int* dst = buf + ((b * k + d) * (long long)cap + r) * w;
        for (int c = 0; c < w; ++c) dst[c] = src[c];
      }
    });
  } else {
    warp_tile_walk<false>(t * BUCKET_TILE_ITEMS, i1, bin, counter,
                          [](long long, int, int) {});
  }
}

// buf == nullptr: bucket_rank (ranks and histogram of k + 1 bins; rows, w,
// cap and overflow unused).  Else bucket_pack (rank unused).  tile and
// shared are the wrapper's bucket_geometry(n_bins).
extern "C" int bucket_pack_launch(const int* dest, const int* rows, int B,
                                  long long m, int w, int k, int cap,
                                  int tile, long long n_tiles, int shared,
                                  int* th, int* rank, int* hist, int* buf,
                                  int* overflow, void* stream) {
  const bool pack = buf != nullptr;
  const int n_bins = pack ? k : k + 1;
  if (k < 1 || cap < 0 || B < 0 || m < 0 || tile != BUCKET_TILE_ITEMS ||
      n_tiles != (m + tile - 1) / tile ||
      (pack ? w < 1 || overflow == nullptr : rank == nullptr) ||
      (shared && n_bins > BUCKET_SHARED_BINS))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || m == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_blocks = (long long)B * n_tiles;
  const unsigned warp_blocks = blocks_for(n_blocks, BUCKET_WARPS);
  cudaError_t err;
  if (shared) {
    bucket_count_kernel<<<(unsigned)n_blocks, BUCKET_THREADS,
                          sizeof(int) * n_bins, s>>>(dest, m, k, n_bins,
                                                     n_tiles, th);
  } else {
    err = cudaMemsetAsync(th, 0, sizeof(int) * (size_t)(n_blocks * n_bins), s);
    if (err != cudaSuccess) return (int)err;
    bucket_warp_kernel<false><<<warp_blocks, BUCKET_THREADS, 0, s>>>(
        dest, rows, B, m, w, k, cap, n_tiles, th, rank, buf);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = launch_scan_rows(th, (long long)B * n_bins, n_tiles, n_bins, k,
                              hist, s)) != cudaSuccess)
    return (int)err;
  if (shared) {
    auto kernel = pack ? bucket_rank_kernel<true> : bucket_rank_kernel<false>;
    const size_t smem =
        sizeof(int) * ((size_t)n_bins * (BUCKET_WARPS + 1)
                       + (pack ? (size_t)BUCKET_TILE_ITEMS : 0));
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(
             (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) != cudaSuccess) {
      cudaGetLastError();  // cleared, so it does not surface at a later launch
      return (int)err;
    }
    kernel<<<(unsigned)n_blocks, BUCKET_THREADS, smem, s>>>(
        dest, rows, m, w, k, cap, n_tiles, th, rank, buf);
  } else {
    bucket_warp_kernel<true><<<warp_blocks, BUCKET_THREADS, 0, s>>>(
        dest, rows, B, m, w, k, cap, n_tiles, th, rank, buf);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (!pack) return 0;
  if (cap > 0) {
    const long long n_pairs = (long long)B * k;
    const long long slab_vecs = ((long long)cap * w + 3) / 4;
    long long chunks = (slab_vecs + 8LL * BUCKET_THREADS - 1)
                       / (8LL * BUCKET_THREADS);
    chunks = chunks < 1 ? 1 : (chunks > 64 ? 64 : chunks);
    scatter_fill_kernel<<<(unsigned)(n_pairs * chunks), BUCKET_THREADS, 0,
                          s>>>(hist, n_pairs, k, k, cap, w, (int)chunks, buf);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  bins_overflow_kernel<<<blocks_for(B, 128), 128, 0, s>>>(hist, B, k, k, cap,
                                                         overflow);
  return (int)cudaGetLastError();
}
