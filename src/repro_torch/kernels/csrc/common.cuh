// Shared device helpers of the main-path kernels (sm_90a).
//
// Data plane: int32 values >= 0, -1 marks padding.  Hashes are
// multiply-shift over uint32 (the reference's MULT and seeds).  Every launch
// function returns the cudaError_t of its launches (0 = success); the
// Python wrapper raises on anything else.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_MULT 2654435769u
#define REPRO_FULL_MASK 0xffffffffu
#define REPRO_WARPS_PER_BLOCK 8

// Route descriptor, built by kernels/map_pack.py::route_desc (int64 words;
// the kernels read it wrapped to int32, scatter_desc below):
//   [0] F (copies per row)      [1] n_routes
//   [2 + 2j], [3 + 2j]          copy j: route index, rep + offset
//   [2 + 2F + r]                word index of route r's record
//   record: n_hashed, n_eq, n_ne,
//           n_hashed x (col, seed, bits, stride)   (share-1 axes dropped)
//           n_eq x (col, value)                    (row[col] must equal)
//           n_ne x (col, value)                    (row[col] must differ)
// Copy j of a row is a member of its route when the row is not padding and
// meets the route's eq / not-in constraints; its unwrapped logical cell is
// sum_i (top bits_i of row[col_i]*seed_i*MULT) * stride_i + rep + offset.
// Hypercube base cell of a row over uint32: sum over the nh records
// (col, seed, bits, stride) at p of (top bits of row[col]*seed*MULT) * stride.
__device__ __forceinline__ uint32_t hashed_cell(const int* row,
                                                const long long* p, int nh) {
  uint32_t base = 0;
  for (int i = 0; i < nh; ++i, p += 4) {
    const uint32_t h = ((uint32_t)row[p[0]] * (uint32_t)p[1]) * REPRO_MULT;
    base += (h >> (32 - (int)p[2])) * (uint32_t)p[3];
  }
  return base;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The stable-rank walk of map_pack's and bucket_pack's tiles and of
// scatter_pack's staged windows.
// One warp walks items [i0, i1) of its tile in order, 32 at a time, with
// one counter per bin (`counter(d)` is a reference to bin d's).  bin(i) is
// item i's bin, or -1 for an item that counts nowhere.  Count pass
// (kRank false): each bin's counter grows by its items.  Rank pass: each
// item's rank is its bin's counter plus the earlier lanes of its chunk in
// the same bin (`emit(i, d, rank)`), and the counter then advances by the
// bin's group.  Started at each tile's exclusive prefix over the earlier
// tiles (a scan of the count pass's counters), the ranks are the items'
// stable arrival ranks within their bins.
template <bool kRank, class Bin, class Counter, class Emit>
__device__ __forceinline__ void warp_tile_walk(long long i0, long long i1,
                                               Bin bin, Counter counter,
                                               Emit emit) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = lanemask_lt();
  for (long long c0 = i0; c0 < i1; c0 += 32) {
    const long long i = c0 + lane;
    const int d = i < i1 ? bin(i) : -1;
    const unsigned same = __match_any_sync(REPRO_FULL_MASK, d);
    const bool leader = d >= 0 && lane == __ffs(same) - 1;
    if constexpr (kRank) {
      const int base = d >= 0 ? counter(d) : 0;
      __syncwarp();
      if (d >= 0) emit(i, d, base + __popc(same & lt));
      if (leader) counter(d) = base + __popc(same);
    } else {
      if (leader) counter(d) += __popc(same);
    }
    __syncwarp();
  }
}

// The routing of scatter_pack's and map_count's kernels reads the int32
// descriptor (kernels/map_pack.py::scatter_desc_tensor): route_desc's words
// above wrapped to int32 (the values the routing truncates to), then each
// route's first copy (n_routes + 1 words).
//
// Whether a (non-padding) row meets the eq / not-in constraints of the route
// record `rec`.
static __device__ __forceinline__ bool scatter_member(const int* row,
                                                      const int* rec) {
  const int ne = rec[1], nn = rec[2];
  const int* p = rec + 3 + 4 * rec[0];
  for (int i = 0; i < ne; ++i, p += 2)
    if (row[p[0]] != p[1]) return false;
  for (int i = 0; i < nn; ++i, p += 2)
    if (row[p[0]] == p[1]) return false;
  return true;
}

// The route's hashed base cell of a row (hashed_cell on int32 words).
static __device__ __forceinline__ uint32_t scatter_base(const int* row,
                                                       const int* rec) {
  const int nh = rec[0];
  const int* p = rec + 3;
  uint32_t base = 0;
  for (int i = 0; i < nh; ++i, p += 4) {
    const uint32_t h = ((uint32_t)row[p[0]] * (uint32_t)p[1]) * REPRO_MULT;
    base += (h >> (32 - p[2])) * (uint32_t)p[3];
  }
  return base;
}

// The device of an unwrapped cell: ptable[logical % k] (the division only
// for a cell past k).
static __device__ __forceinline__ int scatter_dev(const int* ptable, int k,
                                                  int logical) {
  return ptable[(unsigned)logical < (unsigned)k ? logical : logical % k];
}

// Copies a tile's n_words row words into shared memory (16-byte loads where
// both ends allow); the caller's next barrier makes them visible.
static __device__ __forceinline__ void scatter_stage_rows(const int* from,
                                                          int n_words,
                                                          int* to) {
  if ((((uintptr_t)from) & 15) == 0 && (n_words & 3) == 0) {
    const int4* f = reinterpret_cast<const int4*>(from);
    int4* t = reinterpret_cast<int4*>(to);
    for (int i = threadIdx.x; i < n_words / 4; i += blockDim.x) t[i] = f[i];
  } else {
    for (int i = threadIdx.x; i < n_words; i += blockDim.x) to[i] = from[i];
  }
}

// Copies the descriptor into shared memory at `to` when kSharedDesc (the
// caller's next barrier makes it visible) and returns where to read it.
template <bool kSharedDesc>
static __device__ __forceinline__ const int* scatter_desc(const int* desc,
                                                          int desc_len,
                                                          int* to) {
  if constexpr (!kSharedDesc) return desc;
  for (int i = threadIdx.x; i < desc_len; i += blockDim.x) to[i] = desc[i];
  return to;
}

// Calls emit(a, b, c, j) for j in [lo, hi) of every lane of the warp with
// `mine` (its tokens a, b, c); all 32 lanes call it.  When the warp's runs
// are few and long (a heavy-hitter route's reps), each lane's run is spread
// over the lanes instead of one lane looping over it while the others wait.
template <class Emit>
__device__ __forceinline__ void warp_runs(bool mine, int lo, int hi, int reps,
                                          int a, int b, int c, Emit emit) {
  const unsigned lanes = __ballot_sync(REPRO_FULL_MASK, mine);
  if (!lanes) return;
  if (__popc(lanes) * ((reps + 31) / 32) >= reps) {
    if (mine)
      for (int j = lo; j < hi; ++j) emit(a, b, c, j);
    return;
  }
  const int lane = threadIdx.x & 31;
  for (unsigned m = lanes; m; m &= m - 1) {
    const int from = __ffs(m) - 1;
    const int l = __shfl_sync(REPRO_FULL_MASK, lo, from);
    const int h = __shfl_sync(REPRO_FULL_MASK, hi, from);
    const int aa = __shfl_sync(REPRO_FULL_MASK, a, from);
    const int bb = __shfl_sync(REPRO_FULL_MASK, b, from);
    const int cc = __shfl_sync(REPRO_FULL_MASK, c, from);
    for (int j = l + lane; j < h; j += 32) emit(aa, bb, cc, j);
  }
}

// Calls emit(r, at, j, logical) for reps j in [j_lo, j_hi) of one route for
// every lane of the warp with `mine` (its row `row`, its tokens r and at);
// logical = the route's hashed base of the row + adds[2 * j].  All 32 lanes
// call it with the same route; a member row is hashed once.
template <class Emit>
__device__ __forceinline__ void scatter_reps(bool mine, const int* row,
                                             const int* rec, const int* adds,
                                             int reps, int j_lo, int j_hi,
                                             int r, int at, Emit emit) {
  const int base = mine ? (int)scatter_base(row, rec) : 0;
  warp_runs(mine, j_lo, j_hi, reps, r, at, base,
            [&](int rr, int aa, int b, int j) {
    emit(rr, aa, j, (int)((uint32_t)b + (uint32_t)adds[2 * j]));
  });
}

// In-place exclusive scan of a[0, len) in shared memory by the whole block
// (each thread a contiguous run); returns the total.  Starts and ends with
// the block in step (barriers inside).
__device__ __forceinline__ int scatter_block_scan(int* a, int len,
                                                  int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int per = (len + blockDim.x - 1) / blockDim.x;
  const int b = threadIdx.x * per;
  const int e = b + per < len ? b + per : len;
  int s = 0;
  for (int i = b; i < e; ++i) s += a[i];
  int x = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(REPRO_FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(REPRO_FULL_MASK, v, o);
      if (lane >= o) v += y;
    }
    if (lane < n_warps) warp_sums[lane] = v;
  }
  __syncthreads();
  int run = (warp > 0 ? warp_sums[warp - 1] : 0) + x - s;
  for (int i = b; i < e; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  const int total = warp_sums[n_warps - 1];
  __syncthreads();
  return total;
}

// Lets `fn` take `bytes` of dynamic shared memory; a refusal (past the
// card's limit) is returned and cleared, so it does not surface at the next
// launch of another kernel.
static inline cudaError_t scatter_allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// Adds one warp's 32 bins to their counters (-1 counts nowhere), one add a
// distinct bin.  Every lane calls it.
static __device__ __forceinline__ void bucket_count_warp(int d, int* cnt) {
  if (!__ballot_sync(REPRO_FULL_MASK, d >= 0)) return;
  const unsigned same = __match_any_sync(REPRO_FULL_MASK, d);
  if (d >= 0 && (threadIdx.x & 31) == __ffs(same) - 1)
    atomicAdd(&cnt[d], __popc(same));
}

// overflow[r] = sum over the first n_bins bins of row r of hist (rows
// `hist_stride` ints apart) of max(hist - cap, 0).
static __global__ void bins_overflow_kernel(const int* hist, int n_rows,
                                            int n_bins, int hist_stride,
                                            int cap, int* overflow) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  int o = 0;
  for (int d = 0; d < n_bins; ++d) {
    const int h = hist[(long long)r * hist_stride + d];
    if (h > cap) o += h - cap;
  }
  overflow[r] = o;
}

// -1 into words [min(hist, cap) * wp1, cap * wp1) of each of the n_pairs
// slabs of cap records of wp1 words (scatter_pack's and map_pack's (source,
// device) pairs, bucket_pack's (batch row, bin) pairs): the only slots no
// record lands in.  Pair p's count is bin p % bins of hist's row p / bins
// (rows `hist_stride` ints apart: map_pack's hold the sentinel bin too).
// `chunks` blocks per pair, 16-byte stores in the aligned middle.
static __global__ void scatter_fill_kernel(const int* hist, long long n_pairs,
                                           int bins, int hist_stride,
                                           int cap, int wp1, int chunks,
                                           int* buf) {
  const long long pair = blockIdx.x / chunks;
  if (pair >= n_pairs) return;
  const int hp = hist[(pair / bins) * hist_stride + pair % bins];
  const int h = hp < cap ? hp : cap;
  const long long slab = pair * cap * (long long)wp1;
  const long long gb = slab + (long long)h * wp1;
  const long long ge = slab + (long long)cap * wp1;
  long long a = (gb + 3) & ~3LL;
  if (a > ge) a = ge;
  long long z = ge & ~3LL;
  if (z < a) z = a;
  const long long stride = (long long)chunks * blockDim.x;
  const long long tid = (long long)(blockIdx.x % chunks) * blockDim.x
                        + threadIdx.x;
  for (long long i = gb + tid; i < a; i += stride) buf[i] = -1;
  for (long long i = z + tid; i < ge; i += stride) buf[i] = -1;
  int4* v = reinterpret_cast<int4*>(buf);
  const int4 pad = make_int4(-1, -1, -1, -1);
  for (long long i = a / 4 + tid; i < z / 4; i += stride) v[i] = pad;
}

// In-place exclusive scan of each row of a (n_rows, len) int32 matrix, one
// block per row, 4 items per thread.  The row total goes to
// totals[(row / nb) * nb_out + row % nb] when row % nb < nb_out (nb = 1,
// nb_out = 1 gives one total per row); totals may be null.
static __global__ void scan_rows_kernel(int* data, long long len, int nb, int nb_out,
                                 int* totals) {
  __shared__ int warp_sums[32];
  const long long row = blockIdx.x;
  int* p = data + row * len;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int carry = 0;
  for (long long base = 0; base < len; base += 4LL * blockDim.x) {
    int v[4];
    int s = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long idx = base + 4LL * threadIdx.x + i;
      v[i] = idx < len ? p[idx] : 0;
      s += v[i];
    }
    int x = s;  // inclusive scan of s across the warp
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
    int run = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + x - s;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long idx = base + 4LL * threadIdx.x + i;
      if (idx < len) p[idx] = run;
      run += v[i];
    }
    carry += warp_sums[n_warps - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0 && totals != nullptr) {
    const long long g = row / nb;
    const int d = (int)(row % nb);
    if (d < nb_out) totals[g * nb_out + d] = carry;
  }
}

static inline cudaError_t launch_scan_rows(int* data, long long n_rows,
                                           long long len, int nb, int nb_out,
                                           int* totals, cudaStream_t s) {
  if (n_rows == 0) return cudaSuccess;
  int threads = 32;
  while (threads < 1024 && 4LL * threads < len) threads <<= 1;
  scan_rows_kernel<<<(unsigned)n_rows, threads, 0, s>>>(data, len, nb, nb_out,
                                                         totals);
  return cudaGetLastError();
}

static inline unsigned blocks_for(long long n, int threads) {
  long long b = (n + threads - 1) / threads;
  return (unsigned)(b < 1 ? 1 : b);
}
