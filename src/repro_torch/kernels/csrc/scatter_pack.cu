// scatter_pack (map phase) and expand_rows (reduce-side expansion).
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
//      warp_tile_walk, shared with build_table and bucket_pack.
// Ranks are exactly the reference's, so overflow drops the same copies.
//
// expand_rows replaces the Pallas `_expand_rows_kernel`
// (src/repro/kernels/scatter_pack.py:217, launched by `expand_rows` at
// :246/:276).  Output slot t of batch b is left[li] ++ right[perm[lo[li] +
// t - off[li]]], li = (number of off entries <= t) - 1 clipped to
// [0, n_l), off the exclusive scan of counts; valid = t < sum(counts).  The
// TPU kernel's one-hot matrix products exist to avoid gathers there; here
// one thread per slot binary-searches off and gathers two rows.  Bound: the
// (B, cap, wl + wr) output write.
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

// ---------------------------------------------------------------------------
// expand_rows
// ---------------------------------------------------------------------------

static __global__ void expand_rows_kernel(const int* left, const int* right,
                                          const int* off, const int* lo,
                                          const int* perm, const int* total,
                                          long long n_l, int wl, long long n_r,
                                          int wr, long long cap, int* out,
                                          unsigned char* valid) {
  const int b = blockIdx.y;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= cap) return;
  const int* boff = off + b * n_l;
  // li = (number of off entries <= t) - 1, clipped: off is non-decreasing
  // and off[0] = 0 <= t, so the count is >= 1.
  long long lo_i = 0, hi_i = n_l;
  while (lo_i < hi_i) {
    const long long mid = (lo_i + hi_i) >> 1;
    if ((long long)boff[mid] <= t) lo_i = mid + 1;
    else hi_i = mid;
  }
  long long li = lo_i - 1;
  if (li < 0) li = 0;
  if (li > n_l - 1) li = n_l - 1;
  long long inner = (long long)lo[b * n_l + li] + t - (long long)boff[li];
  if (inner < 0) inner = 0;
  if (inner > n_r - 1) inner = n_r - 1;
  const long long ri = perm[b * n_r + inner];
  const int* lrow = left + (b * n_l + li) * wl;
  const int* rrow = right + (b * n_r + ri) * wr;
  int* o = out + (b * cap + t) * (wl + wr);
  for (int c = 0; c < wl; ++c) o[c] = lrow[c];
  for (int c = 0; c < wr; ++c) o[wl + c] = rrow[c];
  valid[b * cap + t] = t < (long long)total[b];
}

extern "C" int expand_rows_launch(const int* left, const int* right,
                                  const int* counts, const int* lo,
                                  const int* perm, int B, long long n_l,
                                  int wl, long long n_r, int wr, long long cap,
                                  int* off, int* total, int* out,
                                  unsigned char* valid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyAsync(off, counts, sizeof(int) * (size_t)B * n_l,
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  if ((err = launch_scan_rows(off, B, n_l, 1, 1, total, s)) != cudaSuccess)
    return (int)err;
  dim3 grid(blocks_for(cap, 256), (unsigned)B);
  expand_rows_kernel<<<grid, 256, 0, s>>>(left, right, off, lo, perm, total,
                                          n_l, wl, n_r, wr, cap, out, valid);
  return (int)cudaGetLastError();
}
