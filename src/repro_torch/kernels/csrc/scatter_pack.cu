// scatter_pack (map phase); the reduce-side expansion is expand_rows.cu.
//
// scatter_pack replaces the Pallas `_scatter_pack_kernel`
// (src/repro/kernels/scatter_pack.py:94, launched by `scatter_pack` at
// :149/:168).  Per source shard: every member copy of every row, in
// (row, route, rep) order, goes to device ptable[logical % k], gets its
// stable arrival rank within that device, and is written as
// `row ++ logical` to buf[src, dev, rank] when rank < cap; every other slot
// holds -1.  overflow[src] = sum_dev max(hist - cap, 0).
//
// Bound: writing the buffer (n_src * n_dev * cap * (w + 1) * 4 bytes,
// records and -1 fill) and reading the rows.  The TPU kernel walks every
// (row, copy) with a histogram carried across a sequential grid.  Here
// blocks run in no order, and most copies are not members (at the
// full-size cell 88-94 % are not), so the work follows rows and member
// copies.  A block of SCATTER_THREADS threads takes a tile of one source's
// rows and copies it into shared memory (one coalesced read): 1,024 rows,
// or as many as fit SCATTER_ROW_WORDS words (the wrapper's
// `scatter_tile_rows`; one row at the least).  The descriptor `desc` is
// route_desc's words wrapped to int32 (the values the routing truncates
// to), then each route's first copy, n_routes + 1 words (route r's copies
// are [first[r], first[r + 1])).  A descriptor of up to
// SCATTER_SHARED_DESC_WORDS words is copied into each block's shared memory
// (kSharedDesc): every thread reads the same words, and on an H100 (80GB
// HBM3, 700 W) at the full-size two_way cell the count kernel takes about
// 15 % and the rank kernel 10 % less time reading them from there than
// through the L1 cache.  Larger ones (a plan of thousands of routes, or an
// eq route of thousands of reps) are read in place.
//   1. count (scatter_count_kernel): a thread per row tests each route's
//      eq / not-in constraints once; only a member route is hashed, once
//      per row, and its reps folded through ptable and counted in shared
//      memory: n_dev counters, no sentinel bin.  The counts go bin-major
//      to th[src, dev, tile].
//   2. an exclusive scan of th over tiles per (source, device): each
//      tile's base per device; the totals are hist[src, dev].
//   3. rank and write (scatter_rank_kernel), the same tiles: a thread per
//      row counts its member copies; a block scan of the counts places the
//      tile's member copies in (row, copy) order.  A window of up to
//      SCATTER_STAGE of them at a time is routed (membership tested again)
//      into shared memory, ranked stably by device (each warp counts its share
//      of the window per device with warp_tile_walk, the (device, warp)
//      counts are scanned device-major, the warp walks again for each
//      copy's position in device order), and written device by device:
//      each device's run [base_d, base_d + n_d) is consecutive (w + 1)-word
//      records, consecutive threads on consecutive words; ranks >= cap are
//      skipped.  The device bases carry from one window to the next, so a
//      row with more member copies than a window holds spans several.
//   4. fill (scatter_fill_kernel): -1 into slots [min(hist, cap), cap) of
//      each (source, device), the only slots no record lands in;
//   5. overflow from hist (common.cuh's bins_overflow_kernel).
// A heavy-hitter route's many reps are spread over a warp's lanes
// (scatter_reps), so one heavy row does not hold its warp up.  Ranks are
// exactly the reference's, so overflow drops the same copies.
#include "common.cuh"

#include <stdint.h>

// The geometry (kernels/scatter_pack.py mirrors the first two): at most
// SCATTER_TILE_ROWS rows a tile, whose words both kernels copy into shared
// memory: at most SCATTER_ROW_WORDS, unless one row is wider (a tile of one
// row); SCATTER_STAGE member copies routed and ranked at a time (a row's
// index in its tile and a copy's in its window are 16-bit).
#define SCATTER_TILE_ROWS 1024
#define SCATTER_ROW_WORDS 8192
#define SCATTER_STAGE 2048
#define SCATTER_THREADS 256
#define SCATTER_WARPS (SCATTER_THREADS / 32)
#define SCATTER_FILL_THREADS 256
#define SCATTER_SHARED_DESC_WORDS 4096

// Stage 1: per-tile member copies per device, th[src, d, tile].
template <bool kSharedDesc>
static __global__ void __launch_bounds__(SCATTER_THREADS)
scatter_count_kernel(const int* rows, long long n_loc, int w,
                     const int* desc, int desc_len, int n_routes,
                     const int* ptable, int k, int n_dev, int tile_rows,
                     long long n_tiles, int* th) {
  extern __shared__ int smem[];
  int* row_words = smem;                         // tile_rows * w
  int* cnt = row_words + tile_rows * w;          // n_dev
  desc = scatter_desc<kSharedDesc>(desc, desc_len, cnt + n_dev);
  const long long src = blockIdx.x / n_tiles, t = blockIdx.x % n_tiles;
  const long long r0 = t * tile_rows;
  const int n_rows = (int)(n_loc - r0 < tile_rows ? n_loc - r0 : tile_rows);
  scatter_stage_rows(rows + (src * n_loc + r0) * w, n_rows * w, row_words);
  for (int d = threadIdx.x; d < n_dev; d += blockDim.x) cnt[d] = 0;
  const int* rfirst = desc + desc_len - (n_routes + 1);
  __syncthreads();
  const int F = desc[0];
  // Whole warps step over the rows (scatter_reps needs every lane).
  for (int rb = 0; rb < n_rows; rb += blockDim.x) {
    const int r = rb + threadIdx.x;
    const int* row = row_words + (r < n_rows ? r : 0) * w;
    const bool live = r < n_rows && row[0] != -1;
    for (int q = 0; q < n_routes; ++q) {
      const int j0 = rfirst[q], reps = rfirst[q + 1] - j0;
      if (!reps) continue;
      const int* rec = desc + desc[2 + 2 * F + q];
      scatter_reps(live && scatter_member(row, rec), row, rec,
                   desc + 3 + 2 * j0, reps, 0, reps, r, 0,
                   [&](int, int, int, int logical) {
        atomicAdd(&cnt[scatter_dev(ptable, k, logical)], 1);
      });
    }
  }
  __syncthreads();
  int* col = th + src * n_dev * n_tiles + t;  // th[src, d, t] = col[d * n_tiles]
  for (int d = threadIdx.x; d < n_dev; d += blockDim.x)
    col[(long long)d * n_tiles] = cnt[d];
}

// Stage 3: rank every member copy of the tile and write its record, a
// window of SCATTER_STAGE copies at a time.  The tile's rows are read once,
// coalesced, into shared memory, and every later read of a row
// (membership, routing, the records) is served from there.
template <bool kSharedDesc>
static __global__ void __launch_bounds__(SCATTER_THREADS)
scatter_rank_kernel(const int* rows, long long n_loc, int w,
                    const int* desc, int desc_len, int n_routes,
                    const int* ptable, int k, int n_dev, int cap,
                    int tile_rows, long long n_tiles, const int* th,
                    int* buf) {
  extern __shared__ int smem[];
  __shared__ int warp_sums[32];
  const int warp = threadIdx.x >> 5;
  const int n_warps = SCATTER_WARPS;
  int* row_words = smem;                         // tile_rows * w
  int* row_start = row_words + tile_rows * w;    // tile_rows + 1
  int* cnt = row_start + tile_rows + 1;          // n_dev x warps, device-major
  int* dev_start = cnt + n_dev * n_warps;        // n_dev: run starts in window
  int* run_base = dev_start + n_dev;             // n_dev: next rank per device
  int* st_log = run_base + n_dev;                // the window's copies ...
  uint16_t* st_d = (uint16_t*)(st_log + SCATTER_STAGE);
  uint16_t* st_row = st_d + SCATTER_STAGE;
  uint16_t* perm = st_row + SCATTER_STAGE;       // ... in device order
  desc = scatter_desc<kSharedDesc>(desc, desc_len,
                                   (int*)(perm + SCATTER_STAGE));

  const long long src = blockIdx.x / n_tiles, t = blockIdx.x % n_tiles;
  const int* tb = th + src * n_dev * n_tiles + t;
  for (int d = threadIdx.x; d < n_dev; d += blockDim.x)
    run_base[d] = tb[(long long)d * n_tiles];
  const long long r0 = t * tile_rows;
  const int n_rows = (int)(n_loc - r0 < tile_rows ? n_loc - r0 : tile_rows);
  scatter_stage_rows(rows + (src * n_loc + r0) * w, n_rows * w, row_words);
  const int* trows = row_words;
  const int* rfirst = desc + desc_len - (n_routes + 1);
  __syncthreads();
  const int F = desc[0];

  // Each row's member copies; the scan of the counts places the tile's
  // member copies in (row, copy) order.
  for (int r = threadIdx.x; r < n_rows; r += blockDim.x) {
    const int* row = trows + r * w;
    int m = 0;
    if (row[0] != -1)
      for (int q = 0; q < n_routes; ++q) {
        const int reps = rfirst[q + 1] - rfirst[q];
        if (reps && scatter_member(row, desc + desc[2 + 2 * F + q])) m += reps;
      }
    row_start[r] = m;
  }
  if (threadIdx.x == 0) row_start[n_rows] = 0;
  __syncthreads();
  const int n_members = scatter_block_scan(row_start, n_rows + 1, warp_sums);

  const int wp1 = w + 1;
  int* out = buf + src * n_dev * (long long)cap * wp1;
  auto bin = [&](long long e) { return (int)st_d[e]; };
  auto counter = [&](int d) -> int& { return cnt[d * n_warps + warp]; };
  for (int c0 = 0; c0 < n_members; c0 += SCATTER_STAGE) {
    const int n = n_members - c0 < SCATTER_STAGE ? n_members - c0
                                                 : SCATTER_STAGE;
    const int c1 = c0 + n;
    for (int i = threadIdx.x; i < n_dev * n_warps; i += blockDim.x)
      cnt[i] = 0;
    // Route the window's copies, a row per thread (whole warps step over
    // the rows): each member route is hashed once per row and its reps in
    // the window folded into their slots; `at` is the slot of the row's
    // next member copy.
    for (int rb = 0; rb < n_rows; rb += blockDim.x) {
      const int r = rb + threadIdx.x;
      int at = 0, end = 0;
      if (r < n_rows) {
        at = row_start[r];
        end = row_start[r + 1];
      }
      const bool live = at < end && end > c0 && at < c1;
      const int* row = trows + (r < n_rows ? r : 0) * w;
      for (int q = 0; q < n_routes; ++q) {
        const int j0 = rfirst[q], reps = rfirst[q + 1] - j0;
        if (!reps) continue;
        const int* rec = desc + desc[2 + 2 * F + q];
        const bool member = live && scatter_member(row, rec);
        const int j_lo = c0 - at > 0 ? c0 - at : 0;
        const int j_hi = c1 - at < reps ? c1 - at : reps;
        scatter_reps(member && j_lo < j_hi, row, rec, desc + 3 + 2 * j0, reps,
                     j_lo, j_hi, r, at,
                     [&](int rr, int aa, int j, int logical) {
          const int i = aa + j - c0;
          st_log[i] = logical;
          st_d[i] = (uint16_t)scatter_dev(ptable, k, logical);
          st_row[i] = (uint16_t)rr;
        });
        if (member) at += reps;
      }
    }
    __syncthreads();
    // Stable rank by device within the window: each warp counts its
    // contiguous share per device, the (device, warp) counts are scanned
    // device-major, and the warp's second walk gives each copy its
    // position in device order.
    const int share = (((n + n_warps - 1) / n_warps) + 31) & ~31;
    const long long e0 = (long long)warp * share;
    const long long e1 = e0 + share < n ? e0 + share : n;
    warp_tile_walk<false>(e0, e1, bin, counter, [](long long, int, int) {});
    __syncthreads();
    scatter_block_scan(cnt, n_dev * n_warps, warp_sums);
    for (int d = threadIdx.x; d < n_dev; d += blockDim.x)
      dev_start[d] = cnt[d * n_warps];
    __syncthreads();
    warp_tile_walk<true>(e0, e1, bin, counter,
                         [&](long long e, int, int pos) {
      perm[pos] = (uint16_t)e;
    });
    __syncthreads();
    // Write device by device: word i is column col of position q in device
    // order, copy perm[q] of device d at rank run_base[d] + q - dev_start[d];
    // (q, col) advance by the block's stride without a division.
    const int q_step = SCATTER_THREADS / wp1;
    const int col_step = SCATTER_THREADS % wp1;
    int q = threadIdx.x / wp1, col = threadIdx.x % wp1;
    for (int i = threadIdx.x; i < n * wp1; i += blockDim.x) {
      const int e = perm[q];
      const int d = st_d[e];
      const int rank = run_base[d] + q - dev_start[d];
      if (rank < cap)
        out[((long long)d * cap + rank) * wp1 + col] =
            col < w ? trows[st_row[e] * w + col] : st_log[e];
      q += q_step;
      col += col_step;
      if (col >= wp1) {
        col -= wp1;
        ++q;
      }
    }
    __syncthreads();
    for (int d = threadIdx.x; d < n_dev; d += blockDim.x)
      run_base[d] += (d + 1 < n_dev ? dev_start[d + 1] : n) - dev_start[d];
  }
}

extern "C" int scatter_pack_launch(const int* rows, int n_src, long long n_loc,
                                   int w, const int* desc, int desc_len,
                                   int n_routes, const int* ptable, int k,
                                   int n_dev, int cap, int tile_rows,
                                   long long n_tiles, int* th, int* hist,
                                   int* buf, int* overflow, void* stream) {
  // tile_rows is the wrapper's scatter_tile_rows(w).
  if (tile_rows < 1 || tile_rows > SCATTER_TILE_ROWS ||
      (tile_rows > 1 && (long long)tile_rows * w > SCATTER_ROW_WORDS) ||
      n_dev < 1 || n_dev > 65536)
    return (int)cudaErrorInvalidValue;
  if (n_src == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((long long)n_src * n_tiles);
  const bool shared_desc = desc_len <= SCATTER_SHARED_DESC_WORDS;
  auto count_kernel = shared_desc ? scatter_count_kernel<true>
                                  : scatter_count_kernel<false>;
  auto rank_kernel = shared_desc ? scatter_rank_kernel<true>
                                 : scatter_rank_kernel<false>;
  const size_t row_words = (size_t)tile_rows * w;
  const size_t desc_words = shared_desc ? (size_t)desc_len : 0;
  const size_t count_smem = sizeof(int) * (row_words + n_dev + desc_words);
  const size_t rank_smem =
      sizeof(int) * (row_words + (size_t)tile_rows + 1
                     + (size_t)n_dev * SCATTER_WARPS + 2 * (size_t)n_dev
                     + SCATTER_STAGE + desc_words)
      + sizeof(uint16_t) * 3 * SCATTER_STAGE;
  cudaError_t err;
  if ((err = scatter_allow_smem((const void*)count_kernel, count_smem))
      != cudaSuccess)
    return (int)err;
  if ((err = scatter_allow_smem((const void*)rank_kernel, rank_smem))
      != cudaSuccess)
    return (int)err;
  count_kernel<<<blocks, SCATTER_THREADS, count_smem, s>>>(
      rows, n_loc, w, desc, desc_len, n_routes, ptable, k, n_dev, tile_rows,
      n_tiles, th);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = launch_scan_rows(th, (long long)n_src * n_dev, n_tiles, n_dev,
                              n_dev, hist, s)) != cudaSuccess)
    return (int)err;
  rank_kernel<<<blocks, SCATTER_THREADS, rank_smem, s>>>(
      rows, n_loc, w, desc, desc_len, n_routes, ptable, k, n_dev, cap,
      tile_rows, n_tiles, th, buf);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long n_pairs = (long long)n_src * n_dev;
  const long long slab_vecs = ((long long)cap * (w + 1) + 3) / 4;
  long long chunks = (slab_vecs + 8LL * SCATTER_FILL_THREADS - 1)
                     / (8LL * SCATTER_FILL_THREADS);
  chunks = chunks < 1 ? 1 : (chunks > 64 ? 64 : chunks);
  if (cap > 0) {
    scatter_fill_kernel<<<(unsigned)(n_pairs * chunks), SCATTER_FILL_THREADS,
                          0, s>>>(hist, n_pairs, n_dev, n_dev, cap, w + 1,
                                  (int)chunks, buf);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  bins_overflow_kernel<<<blocks_for(n_src, 128), 128, 0, s>>>(
      hist, n_src, n_dev, n_dev, cap, overflow);
  return (int)cudaGetLastError();
}
