// map_count (the prepare-time counting pass) and map_pack (the fused map's
// per-copy streams) on the card.
//
// Replaces the Pallas `_map_count_kernel` (src/repro/kernels/map_pack.py:192,
// launched by `map_count` at :298/:317).  Every row goes through every
// residual route of its relation (eq / not-in constraints against the heavy
// hitters, the -1 padding mask, multiply-shift hashes combined in mixed
// radix, replication offsets) and each member copy adds one to
// counts[source, logical % k], source = row / rows_per_src.
//
// Bound: reading the rows once (n * w * 4 bytes); the (n_src, k) output is
// tiny.  The TPU kernel carries the histogram across a sequential grid; here
// the counts do not depend on order, so each block owns a run of rows of ONE
// source, histograms its copies with shared-memory atomics (k words) and
// flushes the non-zero bins with one global atomic each.  Rows beyond
// n_src * rows_per_src count toward nothing, as in the reference.
#include "common.cuh"

#define MAP_COUNT_THREADS 256
#define MAP_COUNT_ROWS_PER_BLOCK 2048
#define MAP_COUNT_SHARED_BINS 8192

static __global__ void map_count_kernel(const int* rows, long long n, int w,
                                        const long long* desc, int k,
                                        long long rows_per_src,
                                        long long rows_per_block,
                                        int use_shared, int* counts) {
  extern __shared__ int hist[];
  const int src = blockIdx.y;
  const int F = (int)desc[0];
  const long long r0 = (long long)src * rows_per_src + blockIdx.x * rows_per_block;
  long long r1 = r0 + rows_per_block;
  const long long src_end = (long long)(src + 1) * rows_per_src;
  if (r1 > src_end) r1 = src_end;
  if (r1 > n) r1 = n;
  int* out = counts + (long long)src * k;
  if (use_shared) {
    for (int b = threadIdx.x; b < k; b += blockDim.x) hist[b] = 0;
    __syncthreads();
  }
  const long long n_copies = r1 > r0 ? (r1 - r0) * F : 0;
  for (long long c = threadIdx.x; c < n_copies; c += blockDim.x) {
    const long long row = r0 + c / F;
    const int j = (int)(c % F);
    int logical;
    if (route_copy(rows + row * w, desc, j, &logical)) {
      const int cell = logical % k;
      if (use_shared) atomicAdd(&hist[cell], 1);
      else atomicAdd(&out[cell], 1);
    }
  }
  if (use_shared) {
    __syncthreads();
    for (int b = threadIdx.x; b < k; b += blockDim.x)
      if (hist[b]) atomicAdd(&out[b], hist[b]);
  }
}

extern "C" int map_count_launch(const int* rows, long long n, int w,
                                const long long* desc, int F, int k, int n_src,
                                long long rows_per_src, int* counts,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)n_src * k, s);
  if (err != cudaSuccess) return (int)err;
  if (n == 0 || F == 0) return 0;
  const long long blocks_x =
      (rows_per_src + MAP_COUNT_ROWS_PER_BLOCK - 1) / MAP_COUNT_ROWS_PER_BLOCK;
  const int use_shared = k <= MAP_COUNT_SHARED_BINS;
  dim3 grid((unsigned)blocks_x, (unsigned)n_src);
  const size_t smem = use_shared ? sizeof(int) * (size_t)k : 0;
  map_count_kernel<<<grid, MAP_COUNT_THREADS, smem, s>>>(
      rows, n, w, desc, k, rows_per_src, MAP_COUNT_ROWS_PER_BLOCK, use_shared,
      counts);
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
