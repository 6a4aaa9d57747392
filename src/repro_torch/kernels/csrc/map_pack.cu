// map_count (the prepare-time counting pass) and map_pack (the fused map's
// per-copy streams) on the card.
//
// map_count replaces the Pallas `_map_count_kernel`
// (src/repro/kernels/map_pack.py:192, launched by `map_count` at
// :298/:317).  Every row goes through every residual route of its relation
// (eq / not-in constraints against the heavy hitters, the -1 padding mask,
// multiply-shift hashes combined in mixed radix, replication offsets) and
// each member copy adds one to counts[source, logical % k], source =
// row / rows_per_src (rows_per_src = max(n / n_src, 1); rows past
// n_src * rows_per_src count toward nothing, as in the reference).
//
// Bound: reading the rows once (n * w * 4 bytes); the (n_src, k) output is
// tiny.  The TPU kernel walks every (row, copy) with a histogram carried
// across a sequential grid.  Here the counts do not depend on order, and
// the work follows rows, as scatter_pack's count kernel does: a block of
// MAP_COUNT_THREADS threads takes MAP_COUNT_ROWS_PER_BLOCK rows of ONE
// source, a tile at a time copied into shared memory with one coalesced
// read (1,024 rows, or as many as fit MAP_COUNT_ROW_WORDS words; one row at
// the least).  The int32 descriptor (scatter_pack's) sits in shared memory
// up to MAP_COUNT_SHARED_DESC_WORDS words, else it is read in place.  A
// thread a row tests each route's eq / not-in constraints once and hashes a
// member route once; a heavy-hitter route's many reps are spread over the
// warp's lanes when its member rows are few.  The warp's cells are added to
// counters in shared memory (k up to MAP_COUNT_SHARED_BINS, else in device
// memory) with one add a distinct cell (__match_any_sync), and the block
// flushes its non-zero counters with one device atomic each.  What holds
// it above its bound: the flush's atomics (k a block) and the
// load-then-count sequence of each tile within a block.
#include "common.cuh"

#define MAP_COUNT_THREADS 256
#define MAP_COUNT_ROWS_PER_BLOCK 2048
#define MAP_COUNT_TILE_ROWS 1024
#define MAP_COUNT_ROW_WORDS 8192
#define MAP_COUNT_SHARED_BINS 8192
#define MAP_COUNT_SHARED_DESC_WORDS 4096

// Adds the cell of each lane's (row, copy) to bins; all 32 lanes call it
// with the same route q.  `mine`: the lane's row is a member of the route.
static __device__ __forceinline__ void map_count_route(bool mine,
                                                       const int* row,
                                                       const int* rec,
                                                       const int* adds,
                                                       int reps, int k,
                                                       int* bins) {
  const unsigned members = __ballot_sync(REPRO_FULL_MASK, mine);
  if (!members) return;
  const uint32_t base = mine ? scatter_base(row, rec) : 0;
  auto cell = [k](uint32_t logical) {
    return (int)(logical < (uint32_t)k ? logical : logical % (uint32_t)k);
  };
  if (__popc(members) * ((reps + 31) / 32) >= reps) {
    for (int j = 0; j < reps; ++j)
      bucket_count_warp(mine ? cell(base + (uint32_t)adds[2 * j]) : -1, bins);
    return;
  }
  const int lane = threadIdx.x & 31;
  for (unsigned m = members; m; m &= m - 1) {
    const uint32_t b = __shfl_sync(REPRO_FULL_MASK, base, __ffs(m) - 1);
    for (int j0 = 0; j0 < reps; j0 += 32) {
      const int j = j0 + lane;
      bucket_count_warp(j < reps ? cell(b + (uint32_t)adds[2 * j]) : -1, bins);
    }
  }
}

template <bool kSharedDesc, bool kSharedBins>
static __global__ void __launch_bounds__(MAP_COUNT_THREADS)
map_count_kernel(const int* rows, long long n, int w, const int* desc,
                 int desc_len, int n_routes, int k, long long rows_per_src,
                 int tile_rows, long long blocks_per_src, int* counts) {
  extern __shared__ int smem[];
  int* row_words = smem;                              // tile_rows * w
  int* cnt = row_words + (long long)tile_rows * w;    // k (kSharedBins)
  desc = scatter_desc<kSharedDesc>(desc, desc_len,
                                   cnt + (kSharedBins ? k : 0));
  const long long src = blockIdx.x / blocks_per_src;
  const long long blk = blockIdx.x % blocks_per_src;
  long long src_end = (src + 1) * rows_per_src;
  if (src_end > n) src_end = n;
  const long long r_blk = src * rows_per_src + blk * MAP_COUNT_ROWS_PER_BLOCK;
  long long r_end = r_blk + MAP_COUNT_ROWS_PER_BLOCK;
  if (r_end > src_end) r_end = src_end;
  int* out = counts + src * k;
  int* bins = kSharedBins ? cnt : out;
  if (kSharedBins)
    for (int c = threadIdx.x; c < k; c += blockDim.x) cnt[c] = 0;
  const int* rfirst = desc + desc_len - (n_routes + 1);
  for (long long r0 = r_blk; r0 < r_end; r0 += tile_rows) {
    const int n_rows = (int)(r_end - r0 < tile_rows ? r_end - r0 : tile_rows);
    __syncthreads();   // the last tile's rows are read
    scatter_stage_rows(rows + r0 * w, n_rows * w, row_words);
    __syncthreads();
    const int F = desc[0];
    // Whole warps step over the rows (map_count_route needs every lane).
    for (int rb = 0; rb < n_rows; rb += blockDim.x) {
      const int r = rb + threadIdx.x;
      const int* row = row_words + (long long)(r < n_rows ? r : 0) * w;
      const bool live = r < n_rows && row[0] != -1;
      for (int q = 0; q < n_routes; ++q) {
        const int j0 = rfirst[q], reps = rfirst[q + 1] - j0;
        if (!reps) continue;
        const int* rec = desc + desc[2 + 2 * F + q];
        map_count_route(live && scatter_member(row, rec), row, rec,
                        desc + 3 + 2 * j0, reps, k, bins);
      }
    }
  }
  if (kSharedBins) {
    __syncthreads();
    for (int c = threadIdx.x; c < k; c += blockDim.x)
      if (cnt[c]) atomicAdd(&out[c], cnt[c]);
  }
}

// desc: scatter_pack's int32 descriptor of desc_len words over n_routes
// routes; counts: (n_src, k), zeroed here.
extern "C" int map_count_launch(const int* rows, long long n, int w,
                                const int* desc, int desc_len, int n_routes,
                                int k, int n_src, long long rows_per_src,
                                int* counts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)n_src * k, s);
  if (err != cudaSuccess) return (int)err;
  if (n == 0 || n_src == 0 || n_routes == 0 || rows_per_src < 1) return 0;
  int tile_rows = MAP_COUNT_ROW_WORDS / (w > 0 ? w : 1);
  tile_rows = tile_rows < 1 ? 1
              : (tile_rows > MAP_COUNT_TILE_ROWS ? MAP_COUNT_TILE_ROWS
                                                 : tile_rows);
  const long long blocks_per_src =
      (rows_per_src + MAP_COUNT_ROWS_PER_BLOCK - 1) / MAP_COUNT_ROWS_PER_BLOCK;
  const bool shared_desc = desc_len <= MAP_COUNT_SHARED_DESC_WORDS;
  const bool shared_bins = k <= MAP_COUNT_SHARED_BINS;
  auto kernel = shared_desc
      ? (shared_bins ? map_count_kernel<true, true>
                     : map_count_kernel<true, false>)
      : (shared_bins ? map_count_kernel<false, true>
                     : map_count_kernel<false, false>);
  const size_t smem =
      sizeof(int) * ((size_t)tile_rows * w + (shared_bins ? (size_t)k : 0) +
                     (shared_desc ? (size_t)desc_len : 0));
  if ((err = scatter_allow_smem((const void*)kernel, smem)) != cudaSuccess)
    return (int)err;
  kernel<<<(unsigned)(n_src * blocks_per_src), MAP_COUNT_THREADS, smem, s>>>(
      rows, n, w, desc, desc_len, n_routes, k, rows_per_src, tile_rows,
      blocks_per_src, counts);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// map_pack
// ---------------------------------------------------------------------------
//
// Replaces the Pallas `_map_pack_kernel` (src/repro/kernels/map_pack.py:157,
// launched by `map_pack` at :225/:245).  Per source shard, every (row, copy)
// in row-major order is routed (route_copy) and folded through the (k,)
// placement table: d = ptable[logical % k] for a member copy, the sentinel
// n_dev otherwise; tag = the unwrapped logical cell, -1 on non-members; rank
// = the copy's stable arrival rank within d (the sentinel bin included).
// The three streams go to the planes of a (3, n_src, n_loc * F) array and
// the (n_src, n_dev + 1) histogram to hist.  The buffer is assembled from
// them outside the kernel (kernels/map_pack.py::_assemble_tagged, torch
// ops, as XLA does it outside the Pallas call).
//
// Bound: reading the rows once and writing 12 bytes a copy.  The TPU
// kernel carries its histogram across a grid that runs in order; here the
// rank takes three stages on pack_tile_kernel below: per-tile counts, an
// exclusive scan over tiles per (source, device) whose totals are hist, and
// the in-order re-walk that emits the streams.

#define PACK_TILE_THREADS (32 * REPRO_WARPS_PER_BLOCK)

// Device of copy c (row c / F, copy c % F) of one source's rows: the
// placement table's entry for a member copy's wrapped cell, else the
// sentinel n_dev.  *logical gets the unwrapped cell, -1 on non-members.
static __device__ __forceinline__ int pack_dest(const int* rows, int w,
                                                const long long* desc, int F,
                                                const int* ptable, int k,
                                                int n_dev, long long c,
                                                int* logical) {
  const long long row = c / F;
  const int j = (int)(c % F);
  if (route_copy(rows + row * w, desc, j, logical))
    return ptable[*logical % k];
  *logical = -1;
  return n_dev;
}

// One warp per (source, tile of tile_rows rows) walks the tile's copies in
// (row, copy) order.  Count pass (rank_pass = 0): per-device copies of the
// tile, written bin-major to th[src, d, tile] (n_dev + 1 bins, the last
// the non-members').  Rank pass: counters start at the tile's scanned base
// in th, and every copy gets its stable rank within its device; for every
// copy g of source src it writes the three planes of a (3, n_src, n_loc * F)
// array: d, logical and rank.  Counters live in shared memory (n_dev + 1
// per warp).
static __global__ void pack_tile_kernel(const int* rows, int n_src,
                                        long long n_loc, int w,
                                        const long long* desc, int F,
                                        const int* ptable, int k, int n_dev,
                                        long long tile_rows,
                                        long long n_tiles, int* th,
                                        int rank_pass, int* out) {
  extern __shared__ int smem[];
  const int nb = n_dev + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long gw = (long long)blockIdx.x * REPRO_WARPS_PER_BLOCK + warp;
  if (gw >= (long long)n_src * n_tiles) return;
  const int src = (int)(gw / n_tiles);
  const long long t = gw % n_tiles;
  int* cnt = smem + warp * nb;
  int* col = th + (long long)src * nb * n_tiles + t;  // th[src, d, t] = col[d * n_tiles]
  for (int d = lane; d < nb; d += 32) cnt[d] = rank_pass ? col[d * n_tiles] : 0;
  __syncwarp();
  const int* srows = rows + (long long)src * n_loc * w;
  long long end_row = (t + 1) * tile_rows;
  if (end_row > n_loc) end_row = n_loc;
  int logical = 0;
  auto bin = [&](long long c) {
    return pack_dest(srows, w, desc, F, ptable, k, n_dev, c, &logical);
  };
  auto counter = [&](int d) -> int& { return cnt[d]; };
  if (rank_pass) {
    warp_tile_walk<true>(t * tile_rows * F, end_row * F, bin, counter,
                         [&](long long c, int d, int rank) {
      const long long plane = (long long)n_src * n_loc * F;
      int* o = out + (long long)src * n_loc * F + c;
      o[0] = d;
      o[plane] = logical;
      o[2 * plane] = rank;
    });
  } else {
    warp_tile_walk<false>(t * tile_rows * F, end_row * F, bin, counter,
                          [](long long, int, int) {});
    for (int d = lane; d < nb; d += 32) col[d * n_tiles] = cnt[d];
  }
}

extern "C" int map_pack_launch(const int* rows, int n_src, long long n_loc,
                               int w, const long long* desc, int F,
                               const int* ptable, int k, int n_dev,
                               long long tile_rows, long long n_tiles, int* th,
                               int* hist, int* streams, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = n_dev + 1;
  const unsigned blocks =
      blocks_for((long long)n_src * n_tiles, REPRO_WARPS_PER_BLOCK);
  const size_t smem = sizeof(int) * (size_t)nb * REPRO_WARPS_PER_BLOCK;
  pack_tile_kernel<<<blocks, PACK_TILE_THREADS, smem, s>>>(
      rows, n_src, n_loc, w, desc, F, ptable, k, n_dev, tile_rows, n_tiles,
      th, 0, streams);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if ((err = launch_scan_rows(th, (long long)n_src * nb, n_tiles, nb, nb,
                              hist, s)) != cudaSuccess)
    return (int)err;
  pack_tile_kernel<<<blocks, PACK_TILE_THREADS, smem, s>>>(
      rows, n_src, n_loc, w, desc, F, ptable, k, n_dev, tile_rows, n_tiles,
      th, 1, streams);
  return (int)cudaGetLastError();
}
