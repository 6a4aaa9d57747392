// scatter_pack (map phase); the reduce-side expansion is expand_rows.cu.
//
// scatter_pack replaces the Pallas `_scatter_pack_kernel`
// (src/repro/kernels/scatter_pack.py:94, launched by `scatter_pack` at
// :149/:168).  Per source shard: every (row, copy) in row-major order is
// routed (route_copy), folded to a device through the (k,) placement table
// (non-members go to the sentinel device n_dev), ranked stably within its
// device, and written as `row ++ logical cell` to buf[src, dev, rank] when
// rank < cap.  overflow[src] = sum_dev max(hist - cap, 0).
//
// Bound: the buffer write (n_src * n_dev * cap * (w + 1) * 4 bytes, -1
// fill included, by one memset) and one read of the rows.  The TPU kernel
// ranks with a histogram carried across a sequential grid; CUDA blocks run
// in no order, so the rank is three stages:
//   1. one warp per tile of rows counts its copies per device (shared
//      per-warp counters, __match_any_sync aggregation), written bin-major
//      to th[src, dev, tile] (common.cuh's pack_tile_kernel, rank_pass = 0;
//      map_pack shares it);
//   2. an exclusive scan of th over tiles per (src, dev) gives each tile's
//      base, the scan total is hist[src, dev];
//   3. the warp walks its tile again in order: rank = base + earlier equal
//      lanes (__popc(match & lanemask_lt)), counters advance per chunk
//      (pack_tile_kernel, rank_pass = 1).  Both walks are common.cuh's
//      warp_tile_walk, shared with map_pack and bucket_pack.
// Ranks are exactly the reference's, so overflow drops the same copies.
#include "common.cuh"

extern "C" int scatter_pack_launch(const int* rows, int n_src, long long n_loc,
                                   int w, const long long* desc, int F,
                                   const int* ptable, int k, int n_dev,
                                   int cap, long long tile_rows,
                                   long long n_tiles, int* th, int* hist,
                                   int* buf, int* overflow, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  // Every byte 0xFF: every int32 of the buffer is -1 (padding).
  cudaError_t err = cudaMemsetAsync(
      buf, 0xFF, sizeof(int) * (size_t)n_src * n_dev * cap * (w + 1), s);
  if (err != cudaSuccess) return (int)err;
  const int nb = n_dev + 1;
  const long long n_warps = (long long)n_src * n_tiles;
  const unsigned blocks = blocks_for(n_warps, REPRO_WARPS_PER_BLOCK);
  const size_t smem = sizeof(int) * (size_t)nb * REPRO_WARPS_PER_BLOCK;
  pack_tile_kernel<false><<<blocks, PACK_TILE_THREADS, smem, s>>>(
      rows, n_src, n_loc, w, desc, F, ptable, k, n_dev, cap, tile_rows,
      n_tiles, th, 0, buf);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = launch_scan_rows(th, (long long)n_src * nb, n_tiles, nb, n_dev,
                              hist, s)) != cudaSuccess)
    return (int)err;
  pack_tile_kernel<false><<<blocks, PACK_TILE_THREADS, smem, s>>>(
      rows, n_src, n_loc, w, desc, F, ptable, k, n_dev, cap, tile_rows,
      n_tiles, th, 1, buf);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bins_overflow_kernel<<<blocks_for(n_src, 128), 128, 0, s>>>(hist, n_src,
                                                               n_dev, cap,
                                                               overflow);
  return (int)cudaGetLastError();
}
