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

// Route descriptor, built by kernels/map_pack.py::route_desc (int64 words):
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
__device__ __forceinline__ bool route_copy(const int* row, const long long* desc,
                                           int j, int* logical) {
  const int F = (int)desc[0];
  const int r = (int)desc[2 + 2 * j];
  const uint32_t add = (uint32_t)desc[3 + 2 * j];
  const long long* rec = desc + desc[2 + 2 * F + r];
  const int nh = (int)rec[0], ne = (int)rec[1], nn = (int)rec[2];
  const long long* p = rec + 3;
  uint32_t base = 0;
  for (int i = 0; i < nh; ++i, p += 4) {
    const uint32_t h = ((uint32_t)row[p[0]] * (uint32_t)p[1]) * REPRO_MULT;
    base += (h >> (32 - (int)p[2])) * (uint32_t)p[3];
  }
  *logical = (int)(base + add);
  bool member = row[0] != -1;
  for (int i = 0; i < ne; ++i, p += 2) member &= row[p[0]] == (int)p[1];
  for (int i = 0; i < nn; ++i, p += 2) member &= row[p[0]] != (int)p[1];
  return member;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
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
