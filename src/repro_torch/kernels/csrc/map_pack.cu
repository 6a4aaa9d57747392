// map_count: the prepare-time counting pass on the card.
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
