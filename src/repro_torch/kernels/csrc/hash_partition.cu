// hash_partition: multiply-shift bucket ids and their histogram.
//
// Replaces the Pallas `_hash_partition_kernel` and, past 2^14 buckets,
// `_hash_partition_multi_kernel` (src/repro/kernels/hash_partition.py:35 and
// :57, launched by `hash_partition` at :90/:122).  Key i (int32 bits, read as
// uint32) goes to bucket id = top `bits` bits of key * seed * MULT over
// uint32 (0 when bits = 0: no shift by 32), written to ids[i], and hist[id]
// grows by one.  The two Pallas arms differ only in how a TPU tile holds its
// one-hot histogram; they give the same bits, and this one kernel covers
// both.
//
// Bound: reading the keys and writing the ids (8 bytes a key); the
// histogram is small.  The TPU kernel carries its histogram across a grid
// that runs in order.  Counts do not depend on order, so here each block
// walks a grid-stride share of the keys and counts with atomics: into
// per-block counters in shared memory when the bins fit (flushed once per
// non-zero bin with a global atomic), else straight into device memory.
// No key is padded, so no bucket needs a correction.
#include "common.cuh"

#define HP_THREADS 256
#define HP_SHARED_BINS 8192       // 32 KB of per-block counters
#define HP_MAX_BLOCKS (132 * 8)

static __global__ void hash_partition_kernel(const int* keys, long long n,
                                             unsigned seed, int bits,
                                             int use_shared, int* ids,
                                             int* hist) {
  extern __shared__ int counts[];
  const int nb = 1 << bits;
  if (use_shared) {
    for (int b = threadIdx.x; b < nb; b += blockDim.x) counts[b] = 0;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t h = ((uint32_t)keys[i] * seed) * REPRO_MULT;
    const int id = bits == 0 ? 0 : (int)(h >> (32 - bits));
    ids[i] = id;
    atomicAdd(use_shared ? &counts[id] : &hist[id], 1);
  }
  if (use_shared) {
    __syncthreads();
    for (int b = threadIdx.x; b < nb; b += blockDim.x)
      if (counts[b]) atomicAdd(&hist[b], counts[b]);
  }
}

// hist must hold zeros on entry.
extern "C" int hash_partition_launch(const int* keys, long long n,
                                     long long seed, int bits, int* ids,
                                     int* hist, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long nb = 1LL << bits;
  const int use_shared = nb <= HP_SHARED_BINS;
  // Enough keys per block that zeroing and flushing its counters stays
  // small beside counting them.
  long long per_block = use_shared ? 4 * nb : 0;
  if (per_block < 8LL * HP_THREADS) per_block = 8LL * HP_THREADS;
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > HP_MAX_BLOCKS) blocks = HP_MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  const size_t smem = use_shared ? sizeof(int) * (size_t)nb : 0;
  hash_partition_kernel<<<(unsigned)blocks, HP_THREADS, smem, s>>>(
      keys, n, (unsigned)seed, bits, use_shared, ids, hist);
  return (int)cudaGetLastError();
}
