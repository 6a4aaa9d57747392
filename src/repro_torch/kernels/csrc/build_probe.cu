// segment_scan / run_lengths: the grouping pass of the sort-merge reduce.
//
// Replaces the Pallas `_seg_scan_kernel` (src/repro/kernels/build_probe.py:69,
// launched by `segment_scan` at :152/:167) and `run_lengths` (:190), which
// runs that scan a second time over the reversed keys.  Keys are (B, n, w)
// int32, sorted within each batch row; runs never cross a batch row.  Row i
// starts a run when i == 0 or any column differs from row i - 1.
// seg[b, i] is the number of runs started at or before i, minus one;
// start[b, i] the first row of i's run; len[b, i] its length.
//
// The TPU kernel carries (segment count, run start) across a grid that
// runs in order.  Here the carry crosses blocks in stages:
//   1. one block per (tile of SEG_TILE rows, b) counts its run starts
//      (seg_tile_kernel, pass 0) -> cnt[b, tile];
//   2. an exclusive scan of cnt over tiles per b (scan_rows); the totals
//      are the runs per b;
//   3. the block scans its flags again from the tile's base: seg, and
//      first[b, seg] = i at every run start (seg_tile_kernel, pass 1);
//   4. start = first[seg]; len = (the next run's first row, or n) - start
//      (seg_finish_kernel): the run's end comes from the next start, not
//      from a second, reversed scan.
// Bound: reading the keys once (each row is compared with the one before,
// which the neighbouring thread reads too) and writing seg, start (and len).
#include "common.cuh"

#define SEG_THREADS 256
#define SEG_ITEMS 8
#define SEG_TILE (SEG_THREADS * SEG_ITEMS)

static __device__ __forceinline__ bool starts_run(const int* keys, long long i,
                                                  int w) {
  if (i == 0) return true;
  const int* a = keys + i * w;
  for (int c = 0; c < w; ++c)
    if (a[c] != a[c - w]) return true;
  return false;
}

// Exclusive sum of v over the block; *total gets the block's sum.
static __device__ __forceinline__ int block_exclusive_sum(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(REPRO_FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
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
  return (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
}

static __global__ void seg_tile_kernel(const int* keys, long long n, int w,
                                       long long n_tiles, int* cnt, int pass,
                                       int* seg, int* first) {
  const long long b = blockIdx.y, t = blockIdx.x;
  const int* bk = keys + b * n * w;
  const long long i0 = t * SEG_TILE + (long long)threadIdx.x * SEG_ITEMS;
  unsigned flags = 0;
  int f = 0;
#pragma unroll
  for (int j = 0; j < SEG_ITEMS; ++j) {
    const long long i = i0 + j;
    if (i < n && starts_run(bk, i, w)) {
      flags |= 1u << j;
      ++f;
    }
  }
  int total;
  const int excl = block_exclusive_sum(f, &total);
  if (pass == 0) {
    if (threadIdx.x == 0) cnt[b * n_tiles + t] = total;
    return;
  }
  int s = cnt[b * n_tiles + t] + excl - 1;
  for (int j = 0; j < SEG_ITEMS; ++j) {
    const long long i = i0 + j;
    if (i >= n) break;
    if ((flags >> j) & 1u) first[b * n + ++s] = (int)i;
    seg[b * n + i] = s;
  }
}

static __global__ void seg_finish_kernel(const int* seg, const int* first,
                                         const int* runs, long long total,
                                         long long n, int* start, int* len) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const long long b = g / n;
  const int s = seg[g];
  const int st = first[b * n + s];
  start[g] = st;
  if (len != nullptr) {
    const int nxt = s + 1 < runs[b] ? first[b * n + s + 1] : (int)n;
    len[g] = nxt - st;
  }
}

// len == nullptr: segment_scan only.  cnt (B, n_tiles), runs (B,) and
// first (B, n) are scratch.
extern "C" int segment_scan_launch(const int* keys, int B, long long n, int w,
                                   long long n_tiles, int* cnt, int* runs,
                                   int* first, int* seg, int* start, int* len,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)n_tiles, (unsigned)B);
  seg_tile_kernel<<<grid, SEG_THREADS, 0, s>>>(keys, n, w, n_tiles, cnt, 0,
                                               seg, first);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if ((err = launch_scan_rows(cnt, B, n_tiles, 1, 1, runs, s)) != cudaSuccess)
    return (int)err;
  seg_tile_kernel<<<grid, SEG_THREADS, 0, s>>>(keys, n, w, n_tiles, cnt, 1,
                                               seg, first);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long total = (long long)B * n;
  seg_finish_kernel<<<blocks_for(total, 256), 256, 0, s>>>(
      seg, first, runs, total, n, start, len);
  return (int)cudaGetLastError();
}
