// segment_scan / run_lengths (the grouping pass of the sort-merge reduce)
// and match_counts / first_match (blocked nested-loop equality).
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

// ---------------------------------------------------------------------------
// match_counts / first_match
// ---------------------------------------------------------------------------
//
// Replace the Pallas `_match_counts_kernel` and `_first_match_kernel`
// (src/repro/kernels/build_probe.py:45 and :56, launched by `match_counts`
// at :99/:112 and `first_match` at :127/:136).  probe (n_p,) and build
// (n_b,) are int32; counts[i] = |{j : build[j] == probe[i]}|, first[i] =
// the least such j, or -1.  The TPU kernels pad both sides to their blocks
// (build with -1, probe with -2), so there a probe key of -1 also counts
// the pads; nothing is padded here, and every key is data.
//
// Bound: 2 * n_p * n_b integer operations (a compare and an add or a
// select per pair; first_match needs only the pairs up to each first
// match); the bytes are the two key arrays and the output.  Each block
// owns MATCH_PROBES probe keys, MATCH_PER_THREAD per thread in registers,
// and walks its share of the build side in tiles of MATCH_TILE keys staged
// in shared memory; each int4 read from a tile (a broadcast: every thread
// reads the same address) serves 4 * MATCH_PER_THREAD compares.  The
// TPU's grid runs the build blocks in order over one output tile; here the
// build side splits over blockIdx.y so that enough blocks fill the card,
// and the splits combine by atomics, which are exact for both: atomicAdd
// of counts, atomicMin of indices as unsigned on an output filled with
// 0xFFFFFFFF (-1 where nothing matches).  first_match's block stops when
// every key it owns has a match: later indices cannot be smaller.
#define MATCH_THREADS 256
#define MATCH_PER_THREAD 4
#define MATCH_PROBES (MATCH_THREADS * MATCH_PER_THREAD)
#define MATCH_TILE 2048
#define MATCH_TARGET_BLOCKS (132 * 4)

template <bool kFirst>
__device__ __forceinline__ void match_one(int key, int b, int j, int& acc) {
  if constexpr (kFirst) {
    if (acc < 0 && key == b) acc = j;
  } else {
    acc += key == b;
  }
}

template <bool kFirst>
static __global__ void match_kernel(const int* probe, long long n_p,
                                    const int* build, long long n_b,
                                    long long tiles_per_split, int* out) {
  __shared__ __align__(16) int tile[MATCH_TILE];
  int key[MATCH_PER_THREAD], acc[MATCH_PER_THREAD];
  bool live[MATCH_PER_THREAD];
  const long long p0 = (long long)blockIdx.x * MATCH_PROBES + threadIdx.x;
#pragma unroll
  for (int q = 0; q < MATCH_PER_THREAD; ++q) {
    const long long i = p0 + (long long)q * MATCH_THREADS;
    live[q] = i < n_p;
    key[q] = live[q] ? probe[i] : 0;
    acc[q] = kFirst ? -1 : 0;
  }
  const long long n_tiles = (n_b + MATCH_TILE - 1) / MATCH_TILE;
  const long long t0 = (long long)blockIdx.y * tiles_per_split;
  long long t1 = t0 + tiles_per_split;
  if (t1 > n_tiles) t1 = n_tiles;
  for (long long t = t0; t < t1; ++t) {
    // The barrier also keeps the previous tile until every thread read it.
    bool done = true;
    if constexpr (kFirst) {
#pragma unroll
      for (int q = 0; q < MATCH_PER_THREAD; ++q)
        done &= !live[q] || acc[q] >= 0;
    } else {
      done = false;
    }
    if (__syncthreads_and(done)) break;
    const long long base = t * MATCH_TILE;
    const int len = (int)(n_b - base < MATCH_TILE ? n_b - base : MATCH_TILE);
    for (int i = threadIdx.x; i < len; i += MATCH_THREADS)
      tile[i] = build[base + i];
    __syncthreads();
    int i = 0;
    for (; i + 4 <= len; i += 4) {
      const int4 b = *reinterpret_cast<const int4*>(&tile[i]);
      const int j = (int)base + i;
#pragma unroll
      for (int q = 0; q < MATCH_PER_THREAD; ++q) {
        match_one<kFirst>(key[q], b.x, j, acc[q]);
        match_one<kFirst>(key[q], b.y, j + 1, acc[q]);
        match_one<kFirst>(key[q], b.z, j + 2, acc[q]);
        match_one<kFirst>(key[q], b.w, j + 3, acc[q]);
      }
    }
    for (; i < len; ++i) {
#pragma unroll
      for (int q = 0; q < MATCH_PER_THREAD; ++q)
        match_one<kFirst>(key[q], tile[i], (int)base + i, acc[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < MATCH_PER_THREAD; ++q) {
    if (!live[q]) continue;
    int* o = out + p0 + (long long)q * MATCH_THREADS;
    if constexpr (kFirst) {
      if (acc[q] >= 0) atomicMin((unsigned*)o, (unsigned)acc[q]);
    } else {
      if (acc[q] > 0) atomicAdd(o, acc[q]);
    }
  }
}

template <bool kFirst>
static int match_launch(const int* probe, long long n_p, const int* build,
                        long long n_b, int* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  // counts start at 0; first indices at 0xFFFFFFFF (-1, the unsigned max).
  cudaError_t err = cudaMemsetAsync(out, kFirst ? 0xFF : 0,
                                    sizeof(int) * (size_t)n_p, s);
  if (err != cudaSuccess) return (int)err;
  const long long p_blocks = (n_p + MATCH_PROBES - 1) / MATCH_PROBES;
  const long long n_tiles = (n_b + MATCH_TILE - 1) / MATCH_TILE;
  long long splits = (MATCH_TARGET_BLOCKS + p_blocks - 1) / p_blocks;
  if (splits > n_tiles) splits = n_tiles;
  if (splits < 1) splits = 1;
  const long long per_split = (n_tiles + splits - 1) / splits;
  splits = (n_tiles + per_split - 1) / per_split;
  const dim3 grid((unsigned)p_blocks, (unsigned)splits);
  match_kernel<kFirst><<<grid, MATCH_THREADS, 0, s>>>(probe, n_p, build, n_b,
                                                      per_split, out);
  return (int)cudaGetLastError();
}

extern "C" int match_counts_launch(const int* probe, long long n_p,
                                   const int* build, long long n_b, int* out,
                                   void* stream) {
  return match_launch<false>(probe, n_p, build, n_b, out, stream);
}

extern "C" int first_match_launch(const int* probe, long long n_p,
                                  const int* build, long long n_b, int* out,
                                  void* stream) {
  return match_launch<true>(probe, n_p, build, n_b, out, stream);
}
