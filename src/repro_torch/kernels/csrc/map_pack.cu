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
// launched by `map_pack` at :225/:245) and the buffer assembly that follows
// it there.  The design keeps the reference's two stages.  Streams: per
// source shard, every (row, copy) in row-major order is routed and folded
// through the (k,) placement table: d = ptable[logical % k] for a member
// copy, the sentinel n_dev otherwise; tag = the unwrapped logical cell, -1
// on non-members; rank = the copy's stable arrival rank within d (the
// sentinel bin included).  They go to the planes d, tag, rank of a
// (3, n_src, n_loc * F) array and the (n_src, n_dev + 1) histogram to hist.
// Assembly: every member copy whose rank is below cap writes row ++ tag to
// buf[src, d, rank]; every other slot holds -1; overflow[src] = sum_dev
// max(hist - cap, 0).
//
// Bound: writing the streams (12 bytes a copy) and reading the rows; then
// writing the buffer.  The TPU kernel carries a
// histogram of every copy across a grid that runs in order.  Here blocks
// run in no order, and most copies are not members (94 % of R's at the
// full-size cell, 89 % of S's), so only member copies are counted and
// ranked, and each row is routed once:
//   1. count (pack_count_kernel): a block stages a tile of one source's
//      rows in shared memory (scatter_pack's tile geometry); a thread a row
//      tests each route's eq / not-in constraints once, hashes a member
//      route once (a heavy route's reps spread over the warp, common.cuh's
//      scatter_reps) and counts its member copies per device in shared
//      memory.  th[src, d, tile] gets them, and th[src, n_dev, tile] the
//      tile's copies minus its member copies: the sentinel's count, which
//      no counter ever sees.
//   2. an exclusive scan of th over tiles per (source, bin): each tile's
//      base per bin; the totals are hist.
//   3. rank (pack_rank_kernel), the same tiles, PACK_WINDOW copies at a
//      time: the window's three planes sit in shared memory.  A thread a
//      row writes its non-member copies' entries (the sentinel, -1 and the
//      rank (copies before it in its source - member copies before it): the
//      tile's sentinel base plus its index in the tile minus the member
//      copies before it there, from a scan of the rows' member counts) and
//      routes its member copies into the planes and into a list of the
//      window's members in order.  The members are ranked stably by device
//      (one warp walking them with the devices' running ranks while the
//      others write the d and tag planes out; past PACK_ONE_WARP_MEMBERS,
//      per-warp counts scanned device-major and a second walk), and the
//      rank plane is written out: consecutive threads on consecutive words.
//      With the assembly to follow, a member copy whose rank is below cap
//      also writes (its index in its source, its tag) to its buffer slot in
//      a (n_src, n_dev, cap) slot map: the reference assembly's inverse
//      permutation, scattered where the ranks are known.
//   4. assembly (pack_assemble_kernel): the records of the filled slots
//      [0, min(hist, cap)) of each (source, device), a thread a word, each
//      slab's records one run: the slot map's row, gathered from rows, and
//      its tag.
//   5. fill (common.cuh's scatter_fill_kernel) and overflow
//      (bins_overflow_kernel), both from hist, whose rows hold n_dev + 1
//      bins.
// Stages 1-3 are the streams (map_pack_streams_cuda: assemble = 0).
// What holds it above its bound: the rank kernel's phases (route, rank,
// write out) run in sequence within a block, a barrier between each, at two
// to three blocks an SM, so its stores do not stream all the time; and the
// count kernel reads and routes the rows a second time.

#define PACK_THREADS 256
#define PACK_WARPS (PACK_THREADS / 32)
#define PACK_TILE_ROWS 1024
#define PACK_ROW_WORDS 8192
#define PACK_WINDOW 4096
#define PACK_SHARED_DESC_WORDS 4096
#define PACK_MAX_DEVICES 1535
#define PACK_ONE_WARP_MEMBERS 512          // a window's members one warp ranks
#define PACK_ASSEMBLE_THREADS 256

// Stage 1: per-tile member copies per device, and the sentinel's count.
template <bool kSharedDesc>
static __global__ void __launch_bounds__(PACK_THREADS)
pack_count_kernel(const int* rows, long long n_loc, int w, const int* desc,
                  int desc_len, int n_routes, const int* ptable, int k,
                  int n_dev, int tile_rows, long long n_tiles, int* th) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int members;
  int* row_words = smem;                         // tile_rows * w
  int* cnt = row_words + tile_rows * w;          // n_dev
  desc = scatter_desc<kSharedDesc>(desc, desc_len, cnt + n_dev);
  const long long src = blockIdx.x / n_tiles, t = blockIdx.x % n_tiles;
  const long long r0 = t * tile_rows;
  const int n_rows = (int)(n_loc - r0 < tile_rows ? n_loc - r0 : tile_rows);
  scatter_stage_rows(rows + (src * n_loc + r0) * w, n_rows * w, row_words);
  for (int d = threadIdx.x; d < n_dev; d += blockDim.x) cnt[d] = 0;
  if (threadIdx.x == 0) members = 0;
  const int* rfirst = desc + desc_len - (n_routes + 1);
  __syncthreads();
  const int F = desc[0];
  int mine = 0;                                  // this thread's member copies
  // Whole warps step over the rows (scatter_reps needs every lane).
  for (int rb = 0; rb < n_rows; rb += blockDim.x) {
    const int r = rb + threadIdx.x;
    const int* row = row_words + (r < n_rows ? r : 0) * w;
    const bool live = r < n_rows && row[0] != -1;
    for (int q = 0; q < n_routes; ++q) {
      const int j0 = rfirst[q], reps = rfirst[q + 1] - j0;
      if (!reps) continue;
      const int* rec = desc + desc[2 + 2 * F + q];
      const bool member = live && scatter_member(row, rec);
      if (member) mine += reps;
      scatter_reps(member, row, rec, desc + 3 + 2 * j0, reps, 0, reps, r, 0,
                   [&](int, int, int, int logical) {
        atomicAdd(&cnt[scatter_dev(ptable, k, logical)], 1);
      });
    }
  }
  for (int o = 16; o; o >>= 1)
    mine += __shfl_xor_sync(REPRO_FULL_MASK, mine, o);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(&members, mine);
  __syncthreads();
  // th[src, d, t] = col[d * n_tiles]
  int* col = th + src * (n_dev + 1) * n_tiles + t;
  for (int d = threadIdx.x; d < n_dev; d += blockDim.x)
    col[(long long)d * n_tiles] = cnt[d];
  if (threadIdx.x == 0) col[(long long)n_dev * n_tiles] = n_rows * F - members;
}

// Stage 3: every copy's (d, tag, rank), a window at a time.  M(c) below is
// the number of member copies of the tile before its copy c.
template <bool kSharedDesc>
static __global__ void __launch_bounds__(PACK_THREADS)
pack_rank_kernel(const int* __restrict__ rows, int n_src, long long n_loc,
                 int w, const int* __restrict__ desc, int desc_len,
                 int n_routes, const int* __restrict__ ptable, int k,
                 int n_dev, int tile_rows, long long n_tiles,
                 const int* __restrict__ th, int* __restrict__ streams,
                 int cap, int2* __restrict__ slots) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int warp_sums[32];
  __shared__ int win_mem;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* st_d = smem;                              // the window's planes,
  int* st_tag = st_d + PACK_WINDOW;              // PACK_WINDOW words each
  int* st_rank = st_tag + PACK_WINDOW;
  int* row_words = st_rank + PACK_WINDOW;        // tile_rows * w (16-aligned)
  int* row_start = row_words + ((tile_rows * w + 3) & ~3);  // tile_rows + 1
  uint16_t* m_d = (uint16_t*)(row_start + tile_rows + 1);   // the window's
  uint16_t* m_e = m_d + PACK_WINDOW;             // member copies, in order
  int* cnt = (int*)(m_e + PACK_WINDOW);          // n_dev x warps
  int* dev_start = cnt + n_dev * PACK_WARPS;     // n_dev: run starts in window
  int* run_base = dev_start + n_dev;             // n_dev: next rank per device
  desc = scatter_desc<kSharedDesc>(desc, desc_len, run_base + n_dev);

  const long long src = blockIdx.x / n_tiles, t = blockIdx.x % n_tiles;
  const int* tb = th + src * (n_dev + 1) * n_tiles + t;
  for (int d = threadIdx.x; d < n_dev; d += blockDim.x)
    run_base[d] = tb[(long long)d * n_tiles];
  const int sent_base = tb[(long long)n_dev * n_tiles];
  const long long r0 = t * tile_rows;
  const int n_rows = (int)(n_loc - r0 < tile_rows ? n_loc - r0 : tile_rows);
  scatter_stage_rows(rows + (src * n_loc + r0) * w, n_rows * w, row_words);
  const int* rfirst = desc + desc_len - (n_routes + 1);
  __syncthreads();
  const int F = desc[0];
  // Each row's member copies; their scan gives M at each row's first copy.
  for (int r = threadIdx.x; r < n_rows; r += blockDim.x) {
    const int* row = row_words + r * w;
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
  scatter_block_scan(row_start, n_rows + 1, warp_sums);

  const long long plane = (long long)n_src * n_loc * F;
  const long long first = src * n_loc * F + r0 * F;  // the tile's first copy
  const int n_copies = n_rows * F;
  const unsigned lt = lanemask_lt();
  int members_before = 0;                        // M(c0)
  for (int c0 = 0; c0 < n_copies; c0 += PACK_WINDOW) {
    const int n = n_copies - c0 < PACK_WINDOW ? n_copies - c0 : PACK_WINDOW;
    if (threadIdx.x == 0) win_mem = 0;
    __syncthreads();
    // Route the window's rows [r_lo, r_hi), a row per thread (whole warps
    // step over them).  A member route is hashed once and its reps in the
    // window go to the planes and to the member list at slot M(c) - M(c0);
    // a non-member route's reps get the sentinel, tag -1 and rank
    // sent_base + c - M(c).  mq = M at the row's route q; `at` = the window
    // index of the route's rep 0.
    const int r_lo = c0 / F, r_hi = (c0 + n - 1) / F + 1;
    int mine = 0;                                // member copies written
    for (int rb = r_lo; rb < r_hi; rb += blockDim.x) {
      const int r = rb + threadIdx.x;
      const bool in = r < r_hi;
      const int* row = row_words + (in ? r : r_lo) * w;
      const bool live = in && row[0] != -1;
      int mq = in ? row_start[r] : 0;
      for (int q = 0; q < n_routes; ++q) {
        const int j0 = rfirst[q], reps = rfirst[q + 1] - j0;
        if (!reps) continue;
        const int* rec = desc + desc[2 + 2 * F + q];
        const int at = in ? r * F + j0 - c0 : 0;
        const int j_lo = at < 0 ? -at : 0;
        const int j_hi = n - at < reps ? n - at : reps;
        const bool run = in && j_lo < j_hi;
        const bool member = live && scatter_member(row, rec);
        scatter_reps(run && member, row, rec, desc + 3 + 2 * j0, reps, j_lo,
                     j_hi, mq - members_before, at,
                     [&](int slot0, int a, int j, int logical) {
          const int d = scatter_dev(ptable, k, logical);
          st_d[a + j] = d;
          st_tag[a + j] = logical;
          m_d[slot0 + j] = (uint16_t)d;
          m_e[slot0 + j] = (uint16_t)(a + j);
        });
        warp_runs(run && !member, j_lo, j_hi, reps, at,
                  sent_base + c0 - mq, 0, [&](int a, int rank0, int, int j) {
          st_d[a + j] = n_dev;
          st_tag[a + j] = -1;
          st_rank[a + j] = rank0 + a + j;
        });
        if (member) {
          mq += reps;
          if (run) mine += j_hi - j_lo;
        }
      }
    }
    for (int o = 16; o; o >>= 1)
      mine += __shfl_xor_sync(REPRO_FULL_MASK, mine, o);
    if (lane == 0 && mine) atomicAdd(&win_mem, mine);
    __syncthreads();
    // Stable rank of the window's member copies by device.  Few of them
    // (the cell's windows hold 6-11 % members): warp 0 walks them in order
    // with the devices' running ranks while the other warps write the d
    // and tag planes.  Many: each warp counts its contiguous share per
    // device, the (device, warp) counts are scanned device-major, and the
    // warp walks again for each copy's rank.  Then the planes are written
    // out: consecutive threads on consecutive words.
    const int n_mem = win_mem;
    const long long g = first + c0;
    int* od = streams + g;
    const bool vec = ((g | plane) & 3) == 0;
    auto put_plane = [&](int* to, const int* from, int t, int nt) {
      int e_vec = 0;
      if (vec) {
        const int n4 = n >> 2;
        for (int v = t; v < n4; v += nt)
          reinterpret_cast<int4*>(to)[v] =
              reinterpret_cast<const int4*>(from)[v];
        e_vec = 4 * n4;
      }
      for (int e = e_vec + t; e < n; e += nt) to[e] = from[e];
    };
    // A member copy's rank; with the assembly to follow, a kept copy's
    // (index in its source, tag) goes to its buffer slot in `slots`.
    auto keep = [&](int e, int d, int rank) {
      st_rank[e] = rank;
      if (slots != nullptr && rank < cap)
        slots[(src * n_dev + d) * cap + rank] =
            make_int2((int)(r0 * F) + c0 + e, st_tag[e]);
    };
    if (n_mem <= PACK_ONE_WARP_MEMBERS) {
      if (warp == 0) {
        for (int b = 0; b < n_mem; b += 32) {
          const int i = b + lane;
          const int d = i < n_mem ? (int)m_d[i] : -1;
          const unsigned same = __match_any_sync(REPRO_FULL_MASK, d);
          const int base = d >= 0 ? run_base[d] : 0;
          __syncwarp();
          if (d >= 0) {
            keep(m_e[i], d, base + __popc(same & lt));
            if (lane == __ffs(same) - 1) run_base[d] = base + __popc(same);
          }
          __syncwarp();
        }
      } else {
        put_plane(od, st_d, threadIdx.x - 32, blockDim.x - 32);
        put_plane(od + plane, st_tag, threadIdx.x - 32, blockDim.x - 32);
      }
      __syncthreads();
      put_plane(od + 2 * plane, st_rank, threadIdx.x, blockDim.x);
    } else {
      const int share = (((n_mem + PACK_WARPS - 1) / PACK_WARPS) + 31) & ~31;
      const int e0 = warp * share;
      const int e1 = e0 + share < n_mem ? e0 + share : n_mem;
      int* my_cnt = cnt + warp;             // device d: my_cnt[d * warps]
      for (int i = threadIdx.x; i < n_dev * PACK_WARPS; i += blockDim.x)
        cnt[i] = 0;
      __syncthreads();
      for (int b = e0; b < e1; b += 32) {
        const int i = b + lane;
        const int d = i < e1 ? (int)m_d[i] : -1;
        const unsigned same = __match_any_sync(REPRO_FULL_MASK, d);
        if (d >= 0 && lane == __ffs(same) - 1)
          my_cnt[d * PACK_WARPS] += __popc(same);
        __syncwarp();
      }
      __syncthreads();
      scatter_block_scan(cnt, n_dev * PACK_WARPS, warp_sums);
      for (int d = threadIdx.x; d < n_dev; d += blockDim.x)
        dev_start[d] = cnt[d * PACK_WARPS];
      __syncthreads();
      for (int b = e0; b < e1; b += 32) {
        const int i = b + lane;
        const int d = i < e1 ? (int)m_d[i] : -1;
        const unsigned same = __match_any_sync(REPRO_FULL_MASK, d);
        const int base = d >= 0 ? my_cnt[d * PACK_WARPS] : 0;
        __syncwarp();
        if (d >= 0) {
          keep(m_e[i], d, run_base[d] + base - dev_start[d]
                              + __popc(same & lt));
          if (lane == __ffs(same) - 1)
            my_cnt[d * PACK_WARPS] = base + __popc(same);
        }
        __syncwarp();
      }
      __syncthreads();
      put_plane(od, st_d, threadIdx.x, blockDim.x);
      put_plane(od + plane, st_tag, threadIdx.x, blockDim.x);
      put_plane(od + 2 * plane, st_rank, threadIdx.x, blockDim.x);
      for (int d = threadIdx.x; d < n_dev; d += blockDim.x)
        run_base[d] += (d + 1 < n_dev ? dev_start[d + 1] : n_mem)
                       - dev_start[d];
    }
    members_before += n_mem;
    __syncthreads();
  }
}

// Stage 4: the records.  Slot k < min(hist, cap) of each (source, device)
// holds the member copy of rank k: `slots` gives its index in its source
// and its tag (the reference assembly's inverse permutation, scattered by
// the rank kernel where the ranks are known), and its row is gathered from
// `rows`.  A thread a word, so each slab's records are written as one run;
// `chunks` blocks a (source, device) pair.
static __global__ void __launch_bounds__(PACK_ASSEMBLE_THREADS)
pack_assemble_kernel(const int* __restrict__ rows, long long n_loc, int w,
                     int F, const int* __restrict__ hist, int n_dev, int cap,
                     int chunks, const int2* __restrict__ slots,
                     int* __restrict__ buf) {
  const long long pair = blockIdx.x / chunks;
  const long long src = pair / n_dev;
  const int h0 = hist[src * (n_dev + 1) + pair % n_dev];
  const long long words = (long long)(h0 < cap ? h0 : cap) * (w + 1);
  const int2* sl = slots + pair * cap;
  int* out = buf + pair * cap * (long long)(w + 1);
  const int* srows = rows + src * n_loc * w;
  const long long step = (long long)chunks * blockDim.x;
  for (long long x = (long long)(blockIdx.x % chunks) * blockDim.x
                     + threadIdx.x;
       x < words; x += step) {
    const long long k = x / (w + 1);
    const int col = (int)(x - k * (w + 1));
    const int2 cp = sl[k];
    out[x] = col < w ? srows[(long long)(cp.x / F) * w + col] : cp.y;
  }
}

// rows (n_src, n_loc, w); desc: the int32 descriptor (desc_len words, n_routes
// routes, F copies a row); th: (n_src, n_dev + 1, n_tiles) scratch;
// hist: (n_src, n_dev + 1); streams: (3, n_src, n_loc * F).  With assemble,
// the buffer buf (n_src, n_dev, cap, w + 1) and overflow (n_src,) are
// written too (slots: the (n_src, n_dev, cap, 2) slot map); else only the
// streams.
extern "C" int map_pack_launch(const int* rows, int n_src, long long n_loc,
                               int w, const int* desc, int desc_len,
                               int n_routes, int F, const int* ptable, int k,
                               int n_dev, int tile_rows, long long n_tiles,
                               int* th, int* hist, int* streams,
                               int assemble, int cap, int* buf,
                               int* overflow, int* slots, void* stream) {
  // tile_rows is the wrapper's scatter_tile_rows(w); a source's copies and
  // a tile's rank are int32.
  if (tile_rows < 1 || tile_rows > PACK_TILE_ROWS ||
      (tile_rows > 1 && (long long)tile_rows * w > PACK_ROW_WORDS) ||
      n_dev < 1 || n_dev > PACK_MAX_DEVICES || F < 1 || w < 1 ||
      n_loc * F > 0x7fffffffLL ||
      n_tiles != (n_loc + tile_rows - 1) / tile_rows ||
      (assemble && (cap < 0 || overflow == nullptr ||
                    (cap > 0 && (buf == nullptr || slots == nullptr)))))
    return (int)cudaErrorInvalidValue;
  if (n_src == 0 || n_loc == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((long long)n_src * n_tiles);
  const int nb = n_dev + 1;
  const bool shared_desc = desc_len <= PACK_SHARED_DESC_WORDS;
  auto count_kernel = shared_desc ? pack_count_kernel<true>
                                  : pack_count_kernel<false>;
  auto rank_kernel = shared_desc ? pack_rank_kernel<true>
                                 : pack_rank_kernel<false>;
  const size_t row_words = (size_t)tile_rows * w;
  const size_t desc_words = shared_desc ? (size_t)desc_len : 0;
  const size_t count_smem = sizeof(int) * (row_words + n_dev + desc_words);
  const size_t rank_smem =
      sizeof(int) * (3 * (size_t)PACK_WINDOW + ((row_words + 3) & ~(size_t)3)
                     + (size_t)tile_rows + 1 + PACK_WINDOW
                     + (size_t)n_dev * (PACK_WARPS + 2) + desc_words);
  cudaError_t err;
  if ((err = scatter_allow_smem((const void*)count_kernel, count_smem))
      != cudaSuccess)
    return (int)err;
  if ((err = scatter_allow_smem((const void*)rank_kernel, rank_smem))
      != cudaSuccess)
    return (int)err;
  count_kernel<<<blocks, PACK_THREADS, count_smem, s>>>(
      rows, n_loc, w, desc, desc_len, n_routes, ptable, k, n_dev, tile_rows,
      n_tiles, th);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = launch_scan_rows(th, (long long)n_src * nb, n_tiles, nb, nb,
                              hist, s)) != cudaSuccess)
    return (int)err;
  rank_kernel<<<blocks, PACK_THREADS, rank_smem, s>>>(
      rows, n_src, n_loc, w, desc, desc_len, n_routes, ptable, k, n_dev,
      tile_rows, n_tiles, th, streams, cap,
      assemble && cap > 0 ? reinterpret_cast<int2*>(slots) : nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (!assemble) return 0;

  const long long n_pairs = (long long)n_src * n_dev;
  const long long slab_vecs = ((long long)cap * (w + 1) + 3) / 4;
  long long chunks = (slab_vecs + 8LL * PACK_THREADS - 1)
                     / (8LL * PACK_THREADS);
  chunks = chunks < 1 ? 1 : (chunks > 64 ? 64 : chunks);
  if (cap > 0) {
    pack_assemble_kernel<<<(unsigned)(n_pairs * chunks),
                           PACK_ASSEMBLE_THREADS, 0, s>>>(
        rows, n_loc, w, F, hist, n_dev, cap, (int)chunks,
        reinterpret_cast<const int2*>(slots), buf);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    scatter_fill_kernel<<<(unsigned)(n_pairs * chunks), PACK_THREADS, 0, s>>>(
        hist, n_pairs, n_dev, nb, cap, w + 1, (int)chunks, buf);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  bins_overflow_kernel<<<blocks_for(n_src, 128), 128, 0, s>>>(
      hist, n_src, n_dev, nb, cap, overflow);
  return (int)cudaGetLastError();
}
