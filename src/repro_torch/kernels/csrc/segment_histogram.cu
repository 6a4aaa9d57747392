// segment_histogram: the int32 (n_bins,) count of values in [0, n_bins).
//
// Replaces the Pallas `_segment_histogram_kernel` (launched by
// `segment_histogram`, src/repro/kernels/segment_histogram.py:36, its
// pallas_call at :42): the per-layer expert loads of the MoE FFN
// (src/repro/models/moe.py:86).  Values outside [0, n_bins) are dropped.
//
// Bound: reading the values (4 bytes each); the histogram is small.  The TPU
// kernel compares each block of 1,024 values with every bin (a one-hot sum)
// and carries the histogram across a grid that runs in order.  Counts do not
// depend on order, so here each block walks a grid-stride share of the
// values and counts with atomics: into per-block counters in shared memory
// when the bins fit in 48 KB (12,288 bins; flushed once per non-zero bin
// with a device atomic), else straight into device memory.  The output is
// zeroed with cudaMemsetAsync on the same stream.
#include "common.cuh"

#define SH_THREADS 256
#define SH_SHARED_BINS 12288      // 48 KB of per-block counters
#define SH_MAX_BLOCKS (132 * 8)

static __global__ void segment_histogram_kernel(const int* vals, long long n,
                                                int n_bins, int use_shared,
                                                int* hist) {
  extern __shared__ int counts[];
  if (use_shared) {
    for (int b = threadIdx.x; b < n_bins; b += blockDim.x) counts[b] = 0;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int v = vals[i];
    // One unsigned compare drops both v < 0 and v >= n_bins.
    if ((unsigned)v >= (unsigned)n_bins) continue;
    if (use_shared)
      atomicAdd(&counts[v], 1);
    else
      atomicAdd(&hist[v], 1);
  }
  if (use_shared) {
    __syncthreads();
    for (int b = threadIdx.x; b < n_bins; b += blockDim.x)
      if (counts[b]) atomicAdd(&hist[b], counts[b]);
  }
}

// vals: n int32 values (n >= 1); hist: n_bins int32 (n_bins >= 1), zeroed
// here before the count.
extern "C" int segment_histogram_launch(const int* vals, long long n,
                                        int n_bins, int* hist, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(int) * (size_t)n_bins, s);
  if (err != cudaSuccess) return (int)err;
  const int use_shared = n_bins <= SH_SHARED_BINS;
  // Enough values per block that zeroing and flushing its counters stays
  // small beside counting them.
  long long per_block = use_shared ? 4LL * n_bins : 0;
  if (per_block < 8LL * SH_THREADS) per_block = 8LL * SH_THREADS;
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > SH_MAX_BLOCKS) blocks = SH_MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  const size_t smem = use_shared ? sizeof(int) * (size_t)n_bins : 0;
  segment_histogram_kernel<<<(unsigned)blocks, SH_THREADS, smem, s>>>(
      vals, n, n_bins, use_shared, hist);
  return (int)cudaGetLastError();
}
