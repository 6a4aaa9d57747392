// join_hash and build_table: the hash legs of the reduce-phase hash join.
//
// join_hash replaces the Pallas `_join_hash_kernel`
// (src/repro/kernels/join_probe.py:115, launched by `join_hash` at
// :195/:210): h = (sum_c key_c * seed_c) * MULT over uint32 with
// seed_c = (0x9E3779B1 + 2c * 0x85EBCA77) | 1, bucket = top n_bits bits,
// invalid rows -> the sentinel bucket P = 2^n_bits.  One thread per row;
// bound: reading the keys and writing the buckets.
//
// build_table replaces `_build_table_kernel` and `_build_table_multi_kernel`
// (join_probe.py:122 and :149, launched by `build_table` at :234/:276; the
// two TPU arms are bit-identical, one kernel covers both): the same bucket,
// the row's stable arrival rank within its bucket (sentinel rows included)
// and the (P,) histogram of valid rows.  Bound: reading the keys and
// writing bucket and rank.  P + 1 bins reach 65,537 (262 KB), above the
// 227 KB of shared memory a block may use, so the TPU's single carried
// histogram has no Hopper counterpart.  The rank runs in three stages with
// the per-tile histograms in device memory:
//   1. one warp per tile of rows counts its buckets in th[b, bucket, tile]
//      (__match_any_sync groups, one leader update per group and chunk);
//   2. an exclusive scan of th over tiles per (b, bucket); totals -> hist;
//   3. the warp walks its tile again in order and reads rank = base +
//      earlier equal lanes, advancing the bucket's base per chunk
//      (stages 1 and 3 are common.cuh's warp_tile_walk).
// The wrapper sizes the tiles so th stays within a fixed memory budget.
#include "common.cuh"

#define JOIN_SEED0 0x9E3779B1u
#define JOIN_SEED_STEP 0x85EBCA77u

static __device__ __forceinline__ int join_bucket(const int* key, int w,
                                                  bool valid, int n_bits) {
  if (!valid) return 1 << n_bits;
  uint32_t h = 0;
  for (int c = 0; c < w; ++c) {
    const uint32_t seed = (JOIN_SEED0 + 2u * (uint32_t)c * JOIN_SEED_STEP) | 1u;
    h += (uint32_t)key[c] * seed;
  }
  h *= REPRO_MULT;
  return (int)(h >> (32 - n_bits));
}

static __global__ void join_hash_kernel(const int* keys,
                                        const unsigned char* valid,
                                        long long n, int w, int n_bits,
                                        int* out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = join_bucket(keys + i * w, w, valid[i] != 0, n_bits);
}

extern "C" int join_hash_launch(const int* keys, const unsigned char* valid,
                                long long n, int w, int n_bits, int* out,
                                void* stream) {
  if (n == 0) return 0;
  join_hash_kernel<<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
      keys, valid, n, w, n_bits, out);
  return (int)cudaGetLastError();
}

// Stage 1 (count) and stage 3 (rank) share one walk (warp_tile_walk);
// `rank_pass` selects.  The warp's counters are its column of th.
static __global__ void build_tile_kernel(const int* keys,
                                         const unsigned char* valid, int B,
                                         long long n, int w, int n_bits,
                                         long long tile_rows,
                                         long long n_tiles, int* th,
                                         int rank_pass, int* bkt, int* rank) {
  const int warp = threadIdx.x >> 5;
  const long long gw = (long long)blockIdx.x * REPRO_WARPS_PER_BLOCK + warp;
  if (gw >= (long long)B * n_tiles) return;
  const long long b = gw / n_tiles;
  const long long t = gw % n_tiles;
  const long long nb = (1LL << n_bits) + 1;
  int* col = th + b * nb * n_tiles + t;  // th[b, bucket, t] = col[bucket * n_tiles]
  long long i1 = (t + 1) * tile_rows;
  if (i1 > n) i1 = n;
  auto bin = [&](long long i) {
    const long long gi = b * n + i;
    return join_bucket(keys + gi * w, w, valid[gi] != 0, n_bits);
  };
  auto counter = [&](int d) -> int& { return col[(long long)d * n_tiles]; };
  if (rank_pass) {
    warp_tile_walk<true>(t * tile_rows, i1, bin, counter,
                         [&](long long i, int d, int r) {
      bkt[b * n + i] = d;
      rank[b * n + i] = r;
    });
  } else {
    warp_tile_walk<false>(t * tile_rows, i1, bin, counter,
                          [](long long, int, int) {});
  }
}

extern "C" int build_table_launch(const int* keys, const unsigned char* valid,
                                  int B, long long n, int w, int n_bits,
                                  long long tile_rows, long long n_tiles,
                                  int* th, int* bkt, int* rank, int* hist,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long P = 1LL << n_bits;
  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(int) * (size_t)B * P, s);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const long long nb = P + 1;
  err = cudaMemsetAsync(th, 0, sizeof(int) * (size_t)(B * nb * n_tiles), s);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = blocks_for((long long)B * n_tiles, REPRO_WARPS_PER_BLOCK);
  build_tile_kernel<<<blocks, 32 * REPRO_WARPS_PER_BLOCK, 0, s>>>(
      keys, valid, B, n, w, n_bits, tile_rows, n_tiles, th, 0, bkt, rank);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = launch_scan_rows(th, B * nb, n_tiles, (int)nb, (int)P, hist, s)) !=
      cudaSuccess)
    return (int)err;
  build_tile_kernel<<<blocks, 32 * REPRO_WARPS_PER_BLOCK, 0, s>>>(
      keys, valid, B, n, w, n_bits, tile_rows, n_tiles, th, 1, bkt, rank);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
