// probe_tables: the chained probe, third stage of the reduce phase's hash
// join (after join_hash and build_table, csrc/join_probe.cu).
//
// Replaces what the reference leaves to XLA, with no pallas_call:
// `probe_tables` (src/repro/kernels/join_probe.py:426) and its
// `_chain_probe` (:328), a lax.while_loop of one round per distinct key of
// the fullest bucket, each round two prefix sums and a searchsorted over
// the whole table.  The output is bit for bit that of the plain version
// (kernels/join_probe.py::probe_tables_host).  Inputs: lk (B, n_l, w) and
// l_bkt (B, n_l) from join_hash; rk (B, n_r, w), r_bkt, rank (B, n_r) and
// hist (B, P) from build_table, P = 2^n_bits.
//   * Packed table: starts = the exclusive scan of (hist, n_r - sum hist),
//     so the sentinel bucket P comes last.  Right row i sits at packed slot
//     q = starts[r_bkt_i] + rank_i; within a bucket, packed order is
//     arrival order.
//   * Groups: in each bucket b < P the distinct keys are numbered r = 0,
//     1, ... in order of first appearance in packed order.  Group (r, b) is
//     the bucket's rows with key number r; r is the round of the
//     reference's loop in which the group resolves.
//   * perm: groups take final slots in order of r, then b, each group's
//     rows in arrival order, from 0 up to the count of valid right rows.
//     Rows of the sentinel bucket keep their packed slot.  perm[slot] = the
//     right row.
//   * counts and lo: for a left row, the size and first slot of the group
//     in its bucket whose key equals its key (all w columns compared, never
//     a hash).  Both are 0 when the row is invalid (l_bkt >= P), its bucket
//     is empty, or no key equals its key.
// All outputs are int32.
//
// One launch function, no host read (the plain version syncs once a
// round), stages in order on the stream:
//   1. starts: probe_starts_kernel copies hist into a (B, P + 1) scratch,
//      each row then scanned (scan_long_rows, a block per 4,096 bins);
//   2. probe_place_kernel, a thread per right row: its packed slot's row
//      (perm1) and bucket (pb); a sentinel row writes perm at its slot;
//   3. probe_walk_kernel, a warp per tile of WALK_TILE packed slots of the
//      valid region, 32 slots a step: lanes of equal (bucket, key) find each
//      other with one __match_any_sync a column, and one leader a key looks
//      its key up among the tile's groups of that bucket so far (only the
//      bucket still open from the last step can have any).  A key of no
//      group opens one, numbered in lane order.  Each tile's piece of a
//      bucket keeps its groups at its own first slot + r (rep = the first
//      packed slot of the key, size) and their count at its first slot: a
//      piece has at least as many slots as keys, so this is O(B n_r).  A
//      hot bucket is one run of pieces that warps walk at once;
//   4. probe_merge_kernel, a warp per bucket that crosses a tile edge (the
//      warp of the tile where it starts): each later piece's groups are
//      looked up among the first piece's, a lane a piece, and their sizes
//      added; only if a key was missing does a second pass, in order,
//      append the keys that no earlier piece has (in place: a bucket's
//      groups never outnumber its slots before them) and map each piece's
//      groups to the bucket's numbers;
//   5. probe_round_kernel: each valid slot's r, each sentinel slot the bin
//      2^rbits;
//   6. a stable counting rank of the slots by r: build_table's digit passes
//      on these given bins (repro_rank_buckets).  A slot's rank counts the
//      rows of its round in earlier buckets and before it in its group; the
//      rank's histogram, scanned likewise, counts the rows of earlier
//      rounds; their sum is the row's final slot.  rbits covers n_r - 1,
//      since no bucket has more keys than rows, so the number of rounds is
//      never read;
//   7. probe_final_kernel: perm[final] = row, and final kept at the packed
//      slot;
//   8. probe_left_kernel, a thread per left row: walks its bucket's groups,
//      comparing keys, and writes counts and lo = the final slot of the
//      group's rep.
// Scratch: (B, P + 1) starts, eight (B, n_r) arrays, the rank's (B, n_r)
// pairs and (B, 2^rbits + 1) histogram, the scans' chunk sums:
// O(B (n_l + n_r + P)), never rounds x P.
// Bound: reading r_bkt, rank, the valid right keys, l_bkt and the valid
// left keys, and writing perm, counts and lo.  What this first version
// spends above it: perm1 and pb written at random slots, the digit passes
// over every slot, the walk's key gathers through perm1, and a lookup that
// is linear in a bucket's keys (deep rounds at small n_bits are quadratic,
// as the reference's rounds are).
#include "common.cuh"

#define WALK_TILE 512   // packed slots a warp walks, 16 steps of 32
#define PROBE_THREADS 256

static __device__ __forceinline__ bool same_key(const int* a, const int* b,
                                                int w) {
  for (int c = 0; c < w; ++c)
    if (a[c] != b[c]) return false;
  return true;
}

// In-place exclusive scans of long rows (starts; the rank's histogram of
// 2^rbits + 1 bins, a million at the cell), a block per SCAN_CHUNK items of
// a row rather than a block per row: each chunk's sum, the sums scanned per
// row, then each chunk scanned from its base.
#define SCAN_CHUNK 4096
#define SCAN_THREADS 1024   // 4 items a thread

static __device__ __forceinline__ int warp_inclusive_sum(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(REPRO_FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

static __global__ void __launch_bounds__(SCAN_THREADS)
chunk_sum_kernel(const int* data, long long len, int n_chunks, int* sums) {
  __shared__ int warp_sums[32];
  const int* p = data + blockIdx.y * len;
  const long long c0 = (long long)blockIdx.x * SCAN_CHUNK;
  int s = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long idx = c0 + 4LL * threadIdx.x + i;
    s += idx < len ? p[idx] : 0;
  }
  s = warp_inclusive_sum(s);
  if ((threadIdx.x & 31) == 31) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int t = warp_inclusive_sum(warp_sums[threadIdx.x]);
    if (threadIdx.x == 31)
      sums[(long long)blockIdx.y * n_chunks + blockIdx.x] = t;
  }
}

static __global__ void __launch_bounds__(SCAN_THREADS)
chunk_scan_kernel(int* data, long long len, int n_chunks, const int* bases) {
  __shared__ int warp_sums[32];
  int* p = data + blockIdx.y * len;
  const long long c0 = (long long)blockIdx.x * SCAN_CHUNK;
  const int warp = threadIdx.x >> 5;
  int v[4], s = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long idx = c0 + 4LL * threadIdx.x + i;
    v[i] = idx < len ? p[idx] : 0;
    s += v[i];
  }
  const int x = warp_inclusive_sum(s);
  if ((threadIdx.x & 31) == 31) warp_sums[warp] = x;
  __syncthreads();
  if (threadIdx.x < 32)
    warp_sums[threadIdx.x] = warp_inclusive_sum(warp_sums[threadIdx.x]);
  __syncthreads();
  int run = bases[(long long)blockIdx.y * n_chunks + blockIdx.x] +
            (warp > 0 ? warp_sums[warp - 1] : 0) + x - s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long idx = c0 + 4LL * threadIdx.x + i;
    if (idx < len) p[idx] = run;
    run += v[i];
  }
}

// sums: rows * ceil(len / SCAN_CHUNK) ints.
static cudaError_t scan_long_rows(int* data, int rows, long long len,
                                  int* sums, cudaStream_t s) {
  const int n_chunks = (int)((len + SCAN_CHUNK - 1) / SCAN_CHUNK);
  const dim3 grid(n_chunks, rows);
  chunk_sum_kernel<<<grid, SCAN_THREADS, 0, s>>>(data, len, n_chunks, sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess ||
      (err = launch_scan_rows(sums, rows, n_chunks, 1, 1, nullptr, s)) !=
          cudaSuccess)
    return err;
  chunk_scan_kernel<<<grid, SCAN_THREADS, 0, s>>>(data, len, n_chunks, sums);
  return cudaGetLastError();
}

// 1. hist (rows hist_pitch ints apart), and a 0 past each row's last
// bucket, to be scanned into starts.
static __global__ void probe_starts_kernel(const int* hist, long long pitch,
                                           int B, int P, int* st) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= B * (P + 1LL)) return;
  const long long b = g / (P + 1LL);
  const int j = (int)(g - b * (P + 1LL));
  st[g] = j < P ? hist[b * pitch + j] : 0;
}

// 2. The packed slot of each right row.
static __global__ void probe_place_kernel(const int* r_bkt, const int* rank,
                                          const int* st, int B, int n_r,
                                          int P, int* perm1, int* pb,
                                          int* perm) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)B * n_r) return;
  const long long b = g / n_r;
  const int i = (int)(g - b * n_r);
  const int bk = r_bkt[g];
  if (bk < 0 || bk > P) return;
  const int q = st[b * (P + 1LL) + bk] + rank[g];
  if (q < 0 || q >= n_r) return;
  perm1[b * n_r + q] = i;
  pb[b * n_r + q] = bk;
  if (bk == P) perm[b * n_r + q] = i;
}

// 3. A warp per tile of WALK_TILE packed slots of batch row blockIdx.y:
// each slot's key number within its bucket's piece of the tile (rloc), and
// each piece's groups: grep / gsize at the piece's first slot + r, their
// count at gcount[first slot].
static __global__ void __launch_bounds__(PROBE_THREADS)
probe_walk_kernel(const int* rk, int w, int n_r, int P, const int* st,
                  const int* perm1, const int* pb, int n_tiles, int* rloc,
                  int* grep, int* gsize, int* gcount) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * (PROBE_THREADS / 32) + (threadIdx.x >> 5);
  const long long row0 = (long long)blockIdx.y * n_r;
  const int* st_b = st + blockIdx.y * (P + 1LL);
  const int n_valid = st_b[P];
  const int q0 = t * WALK_TILE;
  if (t >= n_tiles || q0 >= n_valid) return;   // the whole warp
  const int q1 = min(q0 + WALK_TILE, n_valid);
  const int* rk_b = rk + row0 * w;
  const unsigned lt = lanemask_lt();
  int open_b = -1, open_first = 0, open_n = 0;   // the piece still open
  for (int c0 = q0; c0 < q1; c0 += 32) {
    const int q = c0 + lane;
    const bool act = q < q1;
    const int bk = act ? pb[row0 + q] : -1;
    const int* key = rk_b + (long long)(act ? perm1[row0 + q] : 0) * w;
    const int first = act ? max(st_b[bk], q0) : 0;
    const unsigned seg = __match_any_sync(REPRO_FULL_MASK, bk);
    unsigned same = seg;
    for (int c = 0; c < w; ++c)
      same &= __match_any_sync(REPRO_FULL_MASK, act ? key[c] : 0);
    const int leader = __ffs(same) - 1;
    const bool lead = act && lane == leader;
    const bool in_open = act && bk == open_b;
    int found = -1;
    if (lead && in_open) {
      for (int e = 0; e < open_n && found < 0; ++e) {
        const int rep = grep[row0 + open_first + e];
        if (same_key(key, rk_b + (long long)perm1[row0 + rep] * w, w))
          found = e;
      }
    }
    const unsigned fresh = __ballot_sync(REPRO_FULL_MASK, lead && found < 0);
    const int base = in_open ? open_n : 0;
    int r = found >= 0 ? found : base + __popc(fresh & seg & lt);
    if (lead) {
      const long long at = row0 + first + r;
      if (found >= 0) {
        gsize[at] += __popc(same);
      } else {
        grep[at] = q;
        gsize[at] = __popc(same);
      }
    }
    r = __shfl_sync(REPRO_FULL_MASK, r, leader);
    const int n_after = base + __popc(fresh & seg);
    if (act) {
      rloc[row0 + q] = r;
      // The piece's last slot of this step ends it if its bucket or the
      // tile ends there.
      if (lane == 31 - __clz(seg) && (q + 1 == q1 || pb[row0 + q + 1] != bk))
        gcount[row0 + first] = n_after;
    }
    const int last = 31 - __clz(__ballot_sync(REPRO_FULL_MASK, act));
    open_b = __shfl_sync(REPRO_FULL_MASK, bk, last);
    open_first = __shfl_sync(REPRO_FULL_MASK, first, last);
    open_n = __shfl_sync(REPRO_FULL_MASK, n_after, last);
    __syncwarp();
  }
}

// 4. A warp per tile: the bucket that starts in the tile and crosses its
// end gets the bucket's group numbers: the first piece's groups are the
// first ones; gmap[slot of a later piece's group] = the bucket's number.
static __global__ void __launch_bounds__(PROBE_THREADS)
probe_merge_kernel(const int* rk, int w, int n_r, int P, const int* st,
                   const int* perm1, const int* pb, int n_tiles, int* grep,
                   int* gsize, int* gcount, int* gmap) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * (PROBE_THREADS / 32) + (threadIdx.x >> 5);
  const long long row0 = (long long)blockIdx.y * n_r;
  const int* st_b = st + blockIdx.y * (P + 1LL);
  const int n_valid = st_b[P];
  const long long edge = (long long)(t + 1) * WALK_TILE;
  if (t >= n_tiles || edge >= n_valid) return;   // the whole warp
  const int bk = pb[row0 + edge - 1];
  const int s = st_b[bk];
  if (pb[row0 + edge] != bk || s < (long long)t * WALK_TILE) return;
  const int end = st_b[bk + 1];
  const int* rk_b = rk + row0 * w;
  int* rep_b = grep + row0;
  int* size_b = gsize + row0;
  int* map_b = gmap + row0;
  auto key_at = [&](int slot) {
    return rk_b + (long long)perm1[row0 + slot] * w;
  };
  const int n0 = gcount[row0 + s];
  bool pending = false;
  for (long long first = edge + (long long)lane * WALK_TILE; first < end;
       first += 32LL * WALK_TILE) {
    const int nk = gcount[row0 + first];
    for (int u = 0; u < nk; ++u) {
      const int* key = key_at(rep_b[first + u]);
      int found = -1;
      for (int e = 0; e < n0 && found < 0; ++e)
        if (same_key(key, key_at(rep_b[s + e]), w)) found = e;
      if (found >= 0) atomicAdd(size_b + s + found, size_b[first + u]);
      pending |= found < 0;
      map_b[first + u] = found;
    }
  }
  if (!__any_sync(REPRO_FULL_MASK, pending)) return;
  __syncwarp();
  // Keys of no earlier piece, in order: appended after the bucket's groups
  // so far.  Slot s + g never passes the group being read, so it is read
  // before anything lands on it.
  const unsigned lt = lanemask_lt();
  int g = n0;
  for (long long first = edge; first < end; first += WALK_TILE) {
    const int nk = gcount[row0 + first];
    for (int u0 = 0; u0 < nk; u0 += 32) {
      const int u = u0 + lane;
      const bool pend = u < nk && map_b[first + u] < 0;
      int rep = 0, size = 0, found = -1;
      if (pend) {
        rep = rep_b[first + u];
        size = size_b[first + u];
        const int* key = key_at(rep);
        for (int e = n0; e < g && found < 0; ++e)
          if (same_key(key, key_at(rep_b[s + e]), w)) found = e;
      }
      const unsigned fresh = __ballot_sync(REPRO_FULL_MASK, pend && found < 0);
      __syncwarp();
      if (pend && found >= 0) {
        size_b[s + found] += size;
        map_b[first + u] = found;
      } else if (pend) {
        const int at = g + __popc(fresh & lt);
        rep_b[s + at] = rep;
        size_b[s + at] = size;
        map_b[first + u] = at;
      }
      g += __popc(fresh);
      __syncwarp();
    }
  }
  if (lane == 0) gcount[row0 + s] = g;
}

// 5. Each slot's round: its bucket's number for its key; 2^rbits for the
// sentinel's slots.
static __global__ void probe_round_kernel(int B, int n_r, int P, int rbits,
                                          const int* st, const int* pb,
                                          const int* rloc, const int* gmap,
                                          int* rr) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)B * n_r) return;
  const long long b = g / n_r;
  const int q = (int)(g - b * n_r);
  const int* st_b = st + b * (P + 1LL);
  if (q >= st_b[P]) {
    rr[g] = 1 << rbits;
    return;
  }
  const int s = st_b[pb[g]];
  const int first = max(s, q / WALK_TILE * WALK_TILE);
  const int r = rloc[g];
  rr[g] = first == s ? r : gmap[b * n_r + first + r];
}

// 7. fin holds each slot's rank among the slots of its round; it becomes
// the final slot, and perm gets the row there.
static __global__ void probe_final_kernel(int B, int n_r, int P, int rbits,
                                          const int* st, const int* rr,
                                          const int* rtab, const int* perm1,
                                          int* fin, int* perm) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)B * n_r) return;
  const long long b = g / n_r;
  const int q = (int)(g - b * n_r);
  if (q >= st[b * (P + 1LL) + P]) return;
  const int f = rtab[b * ((1LL << rbits) + 1) + rr[g]] + fin[g];
  fin[g] = f;
  perm[b * n_r + f] = perm1[g];
}

// 8. A thread per left row: the group of its bucket with its key.
static __global__ void probe_left_kernel(const int* lk, const int* l_bkt,
                                         int B, int n_l, int w, const int* rk,
                                         int n_r, int P, const int* st,
                                         const int* perm1, const int* grep,
                                         const int* gsize, const int* gcount,
                                         const int* fin, int* counts,
                                         int* lo) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)B * n_l) return;
  const long long b = g / n_l;
  const int bk = max(l_bkt[g], 0);
  int c = 0, l = 0;
  if (bk < P) {
    const int* st_b = st + b * (P + 1LL);
    const int s = st_b[bk];
    if (st_b[bk + 1] > s) {
      const long long row0 = b * n_r;
      const int* key = lk + g * w;
      const int nd = gcount[row0 + s];
      for (int e = 0; e < nd; ++e) {
        const int rep = grep[row0 + s + e];
        if (same_key(key, rk + (row0 + perm1[row0 + rep]) * w, w)) {
          c = gsize[row0 + s + e];
          l = fin[row0 + rep];
          break;
        }
      }
    }
  }
  counts[g] = c;
  lo[g] = l;
}

// hist: B rows hist_pitch ints apart; st: B * (P + 1); slots: 8 arrays of
// B * n_r (perm1, pb, rloc / fin, grep, gsize, gcount, gmap, rr); th, tot,
// key_a .. idx_b and rtab ((B, 2^rbits + 1)): the digit passes' scratch at
// n_bits = rbits, as build_table_launch takes it; csum: B * ceil(max(P + 1,
// 2^rbits + 1) / SCAN_CHUNK) (kernels/join_probe.py::probe_tables_cuda).
extern "C" int probe_tables_launch(const int* lk, const int* l_bkt, int B,
                                   int n_l, const int* rk, const int* r_bkt,
                                   const int* rank, const int* hist,
                                   long long hist_pitch, int n_r, int w,
                                   int n_bits, int rbits, int digit_bits,
                                   int n_tiles, int* st, int* slots, int* th,
                                   int* tot, int* key_a, int* idx_a,
                                   int* key_b, int* idx_b, int* rtab,
                                   int* csum, int* counts, int* lo, int* perm,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || n_r == 0) return 0;
  const int P = 1 << n_bits;
  const long long n = (long long)B * n_r;
  int* perm1 = slots;
  int* pb = slots + n;
  int* fin = slots + 2 * n;   // rloc until the rank
  int* grep = slots + 3 * n;
  int* gsize = slots + 4 * n;
  int* gcount = slots + 5 * n;
  int* gmap = slots + 6 * n;
  int* rr = slots + 7 * n;
  probe_starts_kernel<<<blocks_for(B * (P + 1LL), PROBE_THREADS),
                        PROBE_THREADS, 0, s>>>(hist, hist_pitch, B, P, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess ||
      (err = scan_long_rows(st, B, P + 1LL, csum, s)) != cudaSuccess)
    return (int)err;
  probe_place_kernel<<<blocks_for(n, PROBE_THREADS), PROBE_THREADS, 0, s>>>(
      r_bkt, rank, st, B, n_r, P, perm1, pb, perm);
  const int walk_tiles = (n_r + WALK_TILE - 1) / WALK_TILE;
  const dim3 walk_grid(blocks_for(walk_tiles, PROBE_THREADS / 32), B);
  probe_walk_kernel<<<walk_grid, PROBE_THREADS, 0, s>>>(
      rk, w, n_r, P, st, perm1, pb, walk_tiles, fin, grep, gsize, gcount);
  probe_merge_kernel<<<walk_grid, PROBE_THREADS, 0, s>>>(
      rk, w, n_r, P, st, perm1, pb, walk_tiles, grep, gsize, gcount, gmap);
  probe_round_kernel<<<blocks_for(n, PROBE_THREADS), PROBE_THREADS, 0, s>>>(
      B, n_r, P, rbits, st, pb, fin, gmap, rr);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = repro_rank_buckets(nullptr, nullptr, B, n_r, 1, rbits,
                                digit_bits, n_tiles, th, tot, key_a, idx_a,
                                key_b, idx_b, rr, fin, rtab, s)) !=
          cudaSuccess ||
      (err = scan_long_rows(rtab, B, (1LL << rbits) + 1, csum, s)) !=
          cudaSuccess)
    return (int)err;
  probe_final_kernel<<<blocks_for(n, PROBE_THREADS), PROBE_THREADS, 0, s>>>(
      B, n_r, P, rbits, st, rr, rtab, perm1, fin, perm);
  if (n_l > 0)
    probe_left_kernel<<<blocks_for((long long)B * n_l, PROBE_THREADS),
                        PROBE_THREADS, 0, s>>>(lk, l_bkt, B, n_l, w, rk, n_r,
                                               P, st, perm1, grep, gsize,
                                               gcount, fin, counts, lo);
  return (int)cudaGetLastError();
}
