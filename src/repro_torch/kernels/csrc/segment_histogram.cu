// segment_histogram: the int32 (n_bins,) count of values in [0, n_bins).
//
// Replaces the Pallas `_segment_histogram_kernel` (launched by
// `segment_histogram`, src/repro/kernels/segment_histogram.py:36, its
// pallas_call at :42): the per-layer expert loads of the MoE FFN
// (src/repro/models/moe.py:86).  Values outside [0, n_bins) are dropped.
//
// Bound: reading the values (4 bytes each) and writing the bins.  The TPU
// kernel compares each block of 1,024 values with every bin (a one-hot sum)
// and carries the histogram across a grid that runs in order.  Counts do not
// depend on order, so here blocks count with atomics.  The MoE layer calls
// it once a layer with a handful of values (decode: 16 values in 8 bins), so
// a call's fixed cost matters as much as its rate.  The wrapper
// (kernels/segment_histogram.py::histogram_plan) picks one of four arms:
//   SH_ONE     n up to its threshold, bins in one block's shared memory: one
//              block counts (up to 8 bins in registers, summed over the warp;
//              else in shared memory) and writes every bin, zeros included.
//              One launch, no memset, no device atomic.
//   SH_GRID    more values, bins in one block's shared memory: blocks take
//              grid-stride shares and count in shared memory; each flushes
//              its non-zero bins with a device atomic into the output,
//              zeroed with cudaMemsetAsync first.
//   SH_CLUSTER bins past one block but within a thread-block cluster's
//              shared memory (SH_CLUSTER_BLOCKS blocks of up to
//              SH_CLUSTER_BLOCK_BINS bins, a power of two each): the bins
//              are split over the cluster's blocks; each block sorts its
//              share of the values by owner block in shared memory, and
//              each owner pulls its values from the cluster's blocks through
//              distributed shared memory (cluster.map_shared_rank) into its
//              counters.  One cluster stores every bin; several (sized by
//              the wrapper to n / n_bins) store partial counts that a second
//              kernel sums: no memset, no device atomic.
//   SH_GLOBAL  past a cluster's memory: device atomics into the zeroed
//              output.
// Every launch checks cudaGetLastError().  The cluster arm needs sm_90.
// What holds the cluster arm above its bound: a cluster barrier a round
// and four shared-memory operations a value (rank, stage, pull, add).
// Adding each value straight to its owner's counter with a remote atomic
// (cluster.map_shared_rank(cnt, owner)) was slower than device atomics on
// an H100 (80GB HBM3, 700 W; PERF.md), so values move in bulk.
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

#define SH_ONE 0
#define SH_GRID 1
#define SH_CLUSTER 2
#define SH_GLOBAL 3
#define SH_SHARED_BINS 12288       // 48 KB of one block's counters
#define SH_CLUSTER_BLOCKS 8        // the portable cluster size
#define SH_CLUSTER_BLOCK_BINS 32768  // 128 KB a cluster block (opt-in)
#define SH_ONE_PER 16              // values a thread of the one-block arm
#define SH_STAGE 8192              // values a cluster block sorts a round
#define SH_CLUSTER_THREADS 512     // a cluster block's threads (two an SM)
#define SH_CLUSTER_VALS 16         // values a thread of a cluster block

// SH_ONE: one block; writes every bin.  A thread takes up to SH_ONE_PER / 4
// groups of four values (16-byte loads where aligned, consecutive threads
// on consecutive groups), all loaded before any is counted.  kPacked
// (n_bins <= 8, the MoE layer's usual expert count): a thread counts its
// values in one register, 8 bits a bin; the warp sums them with shuffles
// (widened to 16 bits a bin past 8 lanes) and adds each bin once.  Else
// each value is one shared-memory add.
template <bool kPacked>
static __global__ void __launch_bounds__(1024)
sh_one_kernel(const int* __restrict__ vals, int n, int n_bins,
              int* __restrict__ hist) {
  extern __shared__ int cnt[];
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) cnt[b] = 0;
  const bool vec = (((uintptr_t)vals) & 15) == 0;
  int v[SH_ONE_PER];
#pragma unroll
  for (int u = 0; u < SH_ONE_PER / 4; ++u) {
    const int g = 4 * (threadIdx.x + u * blockDim.x);   // first value
    if (vec && g + 3 < n) {
      const int4 x = *reinterpret_cast<const int4*>(vals + g);
      v[4 * u] = x.x;
      v[4 * u + 1] = x.y;
      v[4 * u + 2] = x.z;
      v[4 * u + 3] = x.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[4 * u + c] = g + c < n ? vals[g + c] : -1;
    }
  }
  __syncthreads();
  if constexpr (kPacked) {
    unsigned long long acc = 0;                // <= 16 values a bin
#pragma unroll
    for (int u = 0; u < SH_ONE_PER; ++u)
      if ((unsigned)v[u] < (unsigned)n_bins) acc += 1ull << (v[u] << 3);
    for (int o = 1; o < 8; o <<= 1)            // 8 lanes: <= 128 a bin
      acc += __shfl_xor_sync(REPRO_FULL_MASK, acc, o);
    // Bins 0-3 and 4-7 widened to 16 bits a bin.
    auto widen = [](unsigned long long x) {
      x = (x | (x << 16)) & 0x0000ffff0000ffffull;
      return (x | (x << 8)) & 0x00ff00ff00ff00ffull;
    };
    unsigned long long lo = widen(acc & 0xffffffffull), hi = widen(acc >> 32);
    for (int o = 8; o < 32; o <<= 1) {         // a warp: <= 512 a bin
      lo += __shfl_xor_sync(REPRO_FULL_MASK, lo, o);
      hi += __shfl_xor_sync(REPRO_FULL_MASK, hi, o);
    }
    const int lane = threadIdx.x & 31;
    if (lane < n_bins) {
      const int c = (int)(((lane < 4 ? lo : hi) >> ((lane & 3) * 16)) & 0xffff);
      if (c) atomicAdd(&cnt[lane], c);
    }
  } else {
#pragma unroll
    for (int u = 0; u < SH_ONE_PER; ++u)
      if ((unsigned)v[u] < (unsigned)n_bins) atomicAdd(&cnt[v[u]], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) hist[b] = cnt[b];
}

// SH_GRID (use_shared) and SH_GLOBAL: grid-stride shares, counted in shared
// memory and flushed with device atomics, or counted in device memory.
static __global__ void sh_grid_kernel(const int* vals, long long n,
                                      int n_bins, int use_shared, int* hist) {
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

// SH_CLUSTER: block r of a cluster owns bins [r << shift, (r + 1) << shift).
// The cluster takes SH_CLUSTER_BLOCKS x SH_STAGE values a round, each block
// SH_STAGE (SH_CLUSTER_VALS a thread, 16-byte loads where aligned).  A
// block sorts its values by owner into a shared-memory stage (a rank
// within (warp, owner) from a shared counter, the counts scanned
// owner-major); once every block has arrived at the cluster barrier, each
// block pulls its own values from every block's stage through
// cluster.map_shared_rank (a value of each stage a step, all loads in
// flight) and adds them to its counters.  Stage and counters are
// double-buffered, so one cluster barrier a round keeps a block from
// overwriting a stage its peers still read, and the next round's values
// are requested between its arrive and its wait.  One cluster stores every
// bin.  Several (partial != nullptr) each store their counts to
// partial[cluster], which sh_sum_kernel then sums into hist: plain stores
// and one pass over clusters x n_bins words in place of as many device
// atomics (and of a memset).
static __global__ void __launch_bounds__(SH_CLUSTER_THREADS, 2)
sh_cluster_kernel(const int* __restrict__ vals, long long n, int n_bins,
                  int shift, int* __restrict__ partial,
                  int* __restrict__ hist) {
  constexpr int kThreads = SH_CLUSTER_THREADS, kVals = SH_CLUSTER_VALS;
  static_assert(kThreads * kVals == SH_STAGE, "a block stages SH_STAGE");
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) int smem[];
  constexpr int kOwners = SH_CLUSTER_BLOCKS;
  const int per = 1 << shift;
  int* cnt = smem;                               // per: the owned bins
  int* stage = cnt + per;                        // 2 x SH_STAGE
  int* ostart = stage + 2 * SH_STAGE;            // 2 x (kOwners + 1)
  // Rank counters a (warp, group of 8 lanes, owner), two rounds' worth:
  // lanes that share a counter seldom collide.
  constexpr int kSub = 4, kCounters = kWarps * kSub * kOwners;
  int* wcnt = ostart + 2 * (kOwners + 1);        // 2 x kCounters
  cg::cluster_group cluster = cg::this_cluster();
  const int me = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = threadIdx.x; b < per; b += blockDim.x) cnt[b] = 0;
  for (int i = threadIdx.x; i < 2 * kCounters; i += blockDim.x) wcnt[i] = 0;
  __syncthreads();
  const long long round = (long long)kOwners * SH_STAGE;
  const long long n_clusters = gridDim.x / kOwners;
  const bool vec = (((uintptr_t)vals) & 15) == 0;
  // This block's eight values of the round at `base` (-1 past n).
  auto load = [&](long long base, int* v) {
#pragma unroll
    for (int u = 0; u < kVals / 4; ++u) {
      const long long g = base + (long long)me * SH_STAGE
                          + 4 * (threadIdx.x + u * kThreads);
      if (vec && g + 3 < n) {
        const int4 x = *reinterpret_cast<const int4*>(vals + g);
        v[4 * u] = x.x;
        v[4 * u + 1] = x.y;
        v[4 * u + 2] = x.z;
        v[4 * u + 3] = x.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[4 * u + c] = g + c < n ? vals[g + c] : -1;
      }
    }
  };
  int v[kVals];
  long long base = (blockIdx.x / kOwners) * round;
  load(base, v);
  for (int buf = 0; base < n; base += n_clusters * round, buf ^= 1) {
    int* st = stage + buf * SH_STAGE;
    int* os = ostart + buf * (kOwners + 1);
    int* wc = wcnt + buf * kCounters;
    int* my_wc = wc + (warp * kSub + (lane >> 3)) * kOwners;
    int pos[kVals];
#pragma unroll
    for (int i = 0; i < kVals; ++i)
      pos[i] = (unsigned)v[i] < (unsigned)n_bins
                   ? atomicAdd(&my_wc[v[i] >> shift], 1) : 0;
    // The other round's counters were last read before the last barrier.
    int* wc_next = wcnt + (buf ^ 1) * kCounters;
    for (int i = threadIdx.x; i < kCounters; i += blockDim.x) wc_next[i] = 0;
    __syncthreads();
    // Owner-major exclusive scan of the counts, in place: lane l takes
    // owner l / 4 of counter groups kE (l % 4) .. kE (l % 4) + kE - 1.
    constexpr int kE = kWarps * kSub / 4;
    if (warp == 0) {
      int* mine = wc + (lane & 3) * kE * kOwners + (lane >> 2);
      int x[kE], sum = 0;
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        x[j] = mine[j * kOwners];
        sum += x[j];
      }
      int incl = sum;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(REPRO_FULL_MASK, incl, o);
        if (lane >= o) incl += y;
      }
      int run = incl - sum;
      if ((lane & 3) == 0) os[lane >> 2] = run;
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        mine[j * kOwners] = run;
        run += x[j];
      }
      if (lane == 31) os[kOwners] = run;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kVals; ++i)
      if ((unsigned)v[i] < (unsigned)n_bins)
        st[my_wc[v[i] >> shift] + pos[i]] = v[i];
    // Every block's stage of this round is in once all have arrived; the
    // next round's values are requested in between.
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    load(base + n_clusters * round, v);
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    // Pull this block's values from every stage: the eight segments'
    // bounds, then a value of each segment a step, all loads in flight.
    // (Cluster shared-memory addresses: block p's word at a local address.)
    const unsigned os_s = (unsigned)__cvta_generic_to_shared(os + me);
    const unsigned st_s = (unsigned)__cvta_generic_to_shared(st);
    unsigned at[kOwners];
    int len[kOwners], most = 0;
#pragma unroll
    for (int p = 0; p < kOwners; ++p) {
      unsigned a, b0, b1;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(a) : "r"(os_s), "r"(p));
      asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(b0) : "r"(a));
      asm volatile("ld.shared::cluster.u32 %0, [%1];"
                   : "=r"(b1) : "r"(a + 4));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(a) : "r"(st_s), "r"(p));
      at[p] = a + 4 * b0;
      len[p] = (int)(b1 - b0);
      most = len[p] > most ? len[p] : most;
    }
    for (int k = threadIdx.x; k < most; k += blockDim.x) {
      int x[kOwners];
#pragma unroll
      for (int p = 0; p < kOwners; ++p) {
        x[p] = -1;
        if (k < len[p])
          asm volatile("ld.shared::cluster.u32 %0, [%1];"
                       : "=r"(x[p]) : "r"(at[p] + 4 * k));
      }
#pragma unroll
      for (int p = 0; p < kOwners; ++p)
        if (x[p] >= 0) atomicAdd(&cnt[x[p] & (per - 1)], 1);
    }
  }
  cluster.sync();                // no block still reads another's stage
  const int lo = me << shift;
  const int hi = lo + per < n_bins ? lo + per : n_bins;
  if (partial == nullptr) {
    for (int b = lo + threadIdx.x; b < hi; b += blockDim.x)
      hist[b] = cnt[b - lo];
    return;
  }
  int* mine = partial + (blockIdx.x / kOwners) * (long long)n_bins;
  for (int b = lo + threadIdx.x; b < hi; b += blockDim.x)
    mine[b] = cnt[b - lo];
}

// hist[b] = sum over the n_clusters rows of partial (n_clusters, n_bins): a
// thread sums four bins with 16-byte loads when n_bins is a multiple of 4
// (the cluster arm's widths mostly are), else one bin.
static __global__ void sh_sum_kernel(const int* __restrict__ partial,
                                     int n_clusters, int n_bins,
                                     int* __restrict__ hist) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if ((n_bins & 3) == 0) {
    if (q >= n_bins / 4) return;
    int4 sum = make_int4(0, 0, 0, 0);
#pragma unroll 4
    for (int c = 0; c < n_clusters; ++c) {
      const int4 x =
          reinterpret_cast<const int4*>(partial + (long long)c * n_bins)[q];
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    reinterpret_cast<int4*>(hist)[q] = sum;
    return;
  }
  if (q >= n_bins) return;
  int sum = 0;
  for (int c = 0; c < n_clusters; ++c)
    sum += partial[(long long)c * n_bins + q];
  hist[q] = sum;
}

// vals: n int32 values (n >= 1); hist: n_bins int32 (n_bins >= 1).  arm,
// blocks and threads come from the wrapper's histogram_plan; a plan the
// arm does not take is refused (cudaErrorInvalidValue).  The cluster arm
// with several clusters takes partial (clusters x n_bins scratch).
extern "C" int segment_histogram_launch(const int* vals, long long n,
                                        int n_bins, int arm, int blocks,
                                        int threads, int* hist, int* partial,
                                        void* stream) {
  if (n < 1 || n_bins < 1 || blocks < 1 || threads < 32 || threads > 1024 ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (arm == SH_ONE) {
    if (blocks != 1 || n_bins > SH_SHARED_BINS ||
        n > (long long)SH_ONE_PER * threads)
      return (int)cudaErrorInvalidValue;
    auto kernel = n_bins <= 8 ? sh_one_kernel<true> : sh_one_kernel<false>;
    kernel<<<1, threads, sizeof(int) * (size_t)n_bins, s>>>(vals, (int)n,
                                                          n_bins, hist);
    return (int)cudaGetLastError();
  }
  if (arm == SH_GRID || arm == SH_GLOBAL) {
    const int use_shared = arm == SH_GRID;
    if (use_shared && n_bins > SH_SHARED_BINS)
      return (int)cudaErrorInvalidValue;
    err = cudaMemsetAsync(hist, 0, sizeof(int) * (size_t)n_bins, s);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = use_shared ? sizeof(int) * (size_t)n_bins : 0;
    sh_grid_kernel<<<blocks, threads, smem, s>>>(vals, n, n_bins, use_shared,
                                                 hist);
    return (int)cudaGetLastError();
  }
  if (arm != SH_CLUSTER || blocks % SH_CLUSTER_BLOCKS != 0 ||
      threads != SH_CLUSTER_THREADS ||
      (blocks > SH_CLUSTER_BLOCKS && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const int per = (n_bins + SH_CLUSTER_BLOCKS - 1) / SH_CLUSTER_BLOCKS;
  int shift = 0;
  while ((1 << shift) < per) ++shift;
  if ((1 << shift) > SH_CLUSTER_BLOCK_BINS) return (int)cudaErrorInvalidValue;
  if (blocks == SH_CLUSTER_BLOCKS) partial = nullptr;
  const size_t smem = sizeof(int) * (((size_t)1 << shift) + 2 * SH_STAGE
                                     + 2 * (SH_CLUSTER_BLOCKS + 1)
                                     + 2 * SH_CLUSTER_BLOCKS
                                           * (SH_CLUSTER_THREADS / 32) * 4);
  if ((err = scatter_allow_smem((const void*)sh_cluster_kernel, smem)) !=
      cudaSuccess)
    return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SH_CLUSTER_BLOCKS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sh_cluster_kernel, vals, n, n_bins, shift,
                           partial, hist);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  if ((err = cudaGetLastError()) != cudaSuccess || partial == nullptr)
    return (int)err;
  sh_sum_kernel<<<blocks_for((n_bins & 3) == 0 ? n_bins / 4 : n_bins, 256),
                  256, 0, s>>>(
      partial, blocks / SH_CLUSTER_BLOCKS, n_bins, hist);
  return (int)cudaGetLastError();
}
