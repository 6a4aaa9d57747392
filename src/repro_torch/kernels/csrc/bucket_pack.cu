// bucket_rank / bucket_pack: the staged map's stable counting-sort pack.
//
// Replaces the Pallas `_bucket_rank_kernel` (src/repro/kernels/bucket_pack.py:57,
// launched by `bucket_rank` at :84/:97) and the assembly of `bucket_pack`
// (:141, called at :162).  Per batch row b (one source shard), item i of
// dest[b] falls in bin d = dest when dest is in [0, k), else in the sentinel
// bin k; rank[b, i] is its stable arrival rank within the bin and
// hist[b, d] (d < k) the bin's size.  With a buffer, rows[b, i] is written
// to buf[b, d, rank] for d < k and rank < cap, in a (B, k, cap, w) buffer
// filled with -1 by one memset, and overflow[b] = sum_d max(hist - cap, 0).
//
// The TPU kernel carries its histogram across a grid that runs in order;
// CUDA blocks do not, so the rank takes three stages: one warp
// per tile counts its bins in th[b, d, tile] (common.cuh's warp_tile_walk,
// counters in device memory so any k fits), an exclusive scan over tiles
// per (b, d) gives each tile's base (the totals are hist), and the warp
// walks its tile again to rank and write.  The ranks are exactly the
// reference's, so overflow drops the same rows.  Bound: reading dest and
// the kept rows, writing rank and the whole buffer.
#include "common.cuh"

static __global__ void bucket_tile_kernel(const int* dest, const int* rows,
                                          int B, long long m, int w, int k,
                                          int cap, long long tile_rows,
                                          long long n_tiles, int* th,
                                          int rank_pass, int* rank, int* buf) {
  const int warp = threadIdx.x >> 5;
  const long long gw = (long long)blockIdx.x * REPRO_WARPS_PER_BLOCK + warp;
  if (gw >= (long long)B * n_tiles) return;
  const long long b = gw / n_tiles;
  const long long t = gw % n_tiles;
  int* col = th + b * (k + 1) * n_tiles + t;  // th[b, d, t] = col[d * n_tiles]
  const int* bdest = dest + b * m;
  long long i1 = (t + 1) * tile_rows;
  if (i1 > m) i1 = m;
  auto bin = [&](long long i) {
    const int d = bdest[i];
    return d >= 0 && d < k ? d : k;
  };
  auto counter = [&](int d) -> int& { return col[(long long)d * n_tiles]; };
  if (rank_pass) {
    warp_tile_walk<true>(t * tile_rows, i1, bin, counter,
                         [&](long long i, int d, int r) {
      rank[b * m + i] = r;
      if (buf != nullptr && d < k && r < cap) {
        const int* src = rows + (b * m + i) * w;
        int* dst = buf + ((b * k + d) * (long long)cap + r) * w;
        for (int c = 0; c < w; ++c) dst[c] = src[c];
      }
    });
  } else {
    warp_tile_walk<false>(t * tile_rows, i1, bin, counter,
                          [](long long, int, int) {});
  }
}

// buf == nullptr: ranks and histogram only (bucket_rank); rows, cap and
// overflow are then unused.
extern "C" int bucket_pack_launch(const int* dest, const int* rows, int B,
                                  long long m, int w, int k, int cap,
                                  long long tile_rows, long long n_tiles,
                                  int* th, int* rank, int* hist, int* buf,
                                  int* overflow, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long nb = k + 1;
  cudaError_t err =
      cudaMemsetAsync(th, 0, sizeof(int) * (size_t)(B * nb * n_tiles), s);
  if (err != cudaSuccess) return (int)err;
  if (buf != nullptr) {
    // Every byte 0xFF: every int32 of the buffer is -1 (padding).
    err = cudaMemsetAsync(buf, 0xFF,
                          sizeof(int) * (size_t)B * k * cap * (size_t)w, s);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = blocks_for((long long)B * n_tiles, REPRO_WARPS_PER_BLOCK);
  bucket_tile_kernel<<<blocks, 32 * REPRO_WARPS_PER_BLOCK, 0, s>>>(
      dest, rows, B, m, w, k, cap, tile_rows, n_tiles, th, 0, rank, buf);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = launch_scan_rows(th, B * nb, n_tiles, (int)nb, k, hist, s)) !=
      cudaSuccess)
    return (int)err;
  bucket_tile_kernel<<<blocks, 32 * REPRO_WARPS_PER_BLOCK, 0, s>>>(
      dest, rows, B, m, w, k, cap, tile_rows, n_tiles, th, 1, rank, buf);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (buf == nullptr) return 0;
  bins_overflow_kernel<<<blocks_for(B, 128), 128, 0, s>>>(hist, B, k, cap,
                                                         overflow);
  return (int)cudaGetLastError();
}
