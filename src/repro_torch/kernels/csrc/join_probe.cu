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
// writing bucket and rank.  The TPU carries one histogram of P + 1 bins
// across a sequential grid; at 16 bits that is 65,537 bins, more than a
// block's 227 KB of shared memory, so here the rank is a stable radix
// ranking of the buckets, low digit first, as the TPU's multi-pass arm
// factors a bucket into (hi, lo).  Digits have at most 10 bits (the
// wrapper picks them); the top digit keeps every bit above its shift, so
// the sentinel P = 2^n_bits is 0 in every lower digit and the top digit's
// one extra bin 2^top_bits, which no valid row reaches.  Each digit pass
// but the last:
//   1. one block of 8 warps per tile of 4,096 rows (each warp 512 rows in
//      registers) counts its digits into counters in shared memory (the
//      first pass hashes and writes the bucket) and stores them to
//      th[b, digit, tile];
//   2. scans: th over tiles per (b, digit), then the digit totals per b;
//   3. the block loads its tile again and counts per warp; a row's place
//      is its digit's start + its tile's base + the earlier warps', chunks'
//      and lanes' rows of that digit.  The tile's (bucket, row index)
//      pairs are first sorted by digit in shared memory, so that each
//      digit's rows leave as one contiguous run into a (B, n) pair of
//      buffers (two pairs, ping-pong, for three digits).
// The last digit's input is sorted by the lower digits, so a tile's rows
// of one bucket are one run once the tile is sorted by the last digit in
// shared memory: the rank is the row's place in that run, written back in
// arrival order.  Only the tile's first lower-digit value can have rows in
// earlier tiles; their count (the carry) comes from a count of each tile's
// last lower-digit run and a segmented scan over tiles.  A bucket's count
// goes to hist from the tile where its run ends.  One digit
// (n_bits <= 10) needs no pairs: its step-3 places within the bucket are
// the ranks and its totals the histogram.  Scratch: th (at most 1,025
// words per 4,096-row tile), the totals and, from two digits on, two or
// four (B, n) buffers: O(B n) whatever P is.  The stage is what keeps the
// writes coalesced: a row written where it lands would send a warp's 32
// stores to up to 32 runs.  The carry spares a full sort of the last digit
// and three passes over the sorted pairs to find the runs.  What holds it
// above its bound on the H100 (PERF.md): the last digit's rank stores back
// in arrival order, which land at random, and each block's load, count,
// stage sequence at three to four blocks an SM.
#include "common.cuh"

#define JOIN_SEED0 0x9E3779B1u
#define JOIN_SEED_STEP 0x85EBCA77u

static __device__ __forceinline__ uint32_t join_seed(int c) {
  return (JOIN_SEED0 + 2u * (uint32_t)c * JOIN_SEED_STEP) | 1u;
}

static __device__ __forceinline__ int join_bucket(const int* key, int w,
                                                  bool valid, int n_bits) {
  if (!valid) return 1 << n_bits;
  uint32_t h = 0;
  for (int c = 0; c < w; ++c) h += (uint32_t)key[c] * join_seed(c);
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

// A block ranks a tile of DIGIT_TILE rows: warp w holds rows
// [w * 512, (w + 1) * 512) of it in registers, DIGIT_CHUNKS chunks of 32.
// Register caps: 3 blocks an SM for the rank kernels, 4 for the counts (on
// one H100 at 8 x 2^20 rows, 2,048-row tiles and higher occupancy were no
// faster).
#define DIGIT_CHUNKS 16
#define DIGIT_THREADS (32 * REPRO_WARPS_PER_BLOCK)
#define DIGIT_TILE (DIGIT_CHUNKS * DIGIT_THREADS)

// The digit of bucket d in [shift, shift + bits); the top digit keeps
// every bit above shift (the sentinel's bin is 1 << bits).
static __device__ __forceinline__ int bucket_digit(int d, int shift, int bits,
                                                   int top) {
  return top ? d >> shift : (d >> shift) & ((1 << bits) - 1);
}

static __host__ __device__ __forceinline__ int digit_bins(int bits, int top) {
  return top ? (1 << bits) + 1 : 1 << bits;
}

// In-place exclusive scan of a[0, len) in shared memory by the block.
static __device__ void block_exclusive_scan(int* a, int len, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (len + DIGIT_THREADS - 1) / DIGIT_THREADS;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, len);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  int x = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(REPRO_FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int run = x - s;
  for (int v = 0; v < warp; ++v) run += warp_sums[v];
  for (int i = lo; i < hi; ++i) {
    const int c = a[i];
    a[i] = run;
    run += c;
  }
  __syncthreads();
}

// The lanes of the warp whose digit equals this lane's, over the digit's
// low `match_bits` bits, one ballot a bit; lanes with digit -1 are in no
// lane's set (their own set is meaningless).
static __device__ __forceinline__ unsigned match_digit(int d, int match_bits) {
  unsigned same = __ballot_sync(REPRO_FULL_MASK, d >= 0);
  for (int k = 0; k < match_bits; ++k) {
    const unsigned ones = __ballot_sync(REPRO_FULL_MASK, (d >> k) & 1);
    same &= (d >> k) & 1 ? ones : ~ones;
  }
  return same;
}

// The kernels of a digit pass, one block per (tile t, batch b) =
// (blockIdx.x, blockIdx.y).  Counts per tile go to th[b, digit, t]:
//   kHashCount  hashes the keys, writes bkt and counts the digit;
//   kCount      counts the digit of key_in;
//   kCountLast  (last of two or more digits) counts the digit of key_in's
//               rows in the tile's last run of equal lower digits.
// Ranks (th scanned over tiles first, except for kRankLast):
//   kRankOnly   (one digit) rank = the tile's base + earlier equal rows;
//   kScatter    each row's (key, idx_in or the row itself) goes to place
//               tot[b, digit] + the tile's base + earlier equal rows of
//               key_out / idx_out, through a copy of the tile sorted by
//               digit in shared memory (the stage), so that each digit's
//               rows leave as one contiguous run;
//   kRankLast   the stage of the last digit is sorted by the whole bucket
//               (key_in is sorted by the lower digits), so a row's rank
//               is its place in its bucket's run of the stage, plus, for
//               the tile's first lower-digit value, th's carry (that
//               bucket's rows in earlier tiles, tile_carry_kernel); runs
//               that end their bucket write its count to tab.
// A warp's chunk leaders add their group to the warp's counter with a
// shared-memory atomic in chunk order; the old value is the group's count
// in the warp's earlier chunks, so a row's rank within its warp needs no
// second walk.
enum DigitKernel { kHashCount, kCount, kCountLast, kRankOnly, kScatter,
                   kRankLast };

template <int kKind>
static __global__ void __launch_bounds__(DIGIT_THREADS,
                                         kKind < kRankOnly ? 4 : 3)
digit_tile_kernel(const int* keys, const unsigned char* valid, int w,
                  int n_bits, int n, int n_tiles, int shift, int bits,
                  int top, int* th, const int* tot, const int* key_in,
                  const int* idx_in, int* key_out, int* idx_out, int* rank,
                  int* tab) {
  extern __shared__ int smem[];
  constexpr bool kRanks =
      kKind == kRankOnly || kKind == kScatter || kKind == kRankLast;
  constexpr bool kStage = kKind == kScatter || kKind == kRankLast;
  const int nb = digit_bins(bits, top);
  const int match_bits = bits + top;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x;
  const long long row0 = (long long)blockIdx.y * n;
  int* th_b = th + (long long)blockIdx.y * nb * n_tiles + t;  // [d * n_tiles]
  // Counters: one array for the block's count, one per warp to rank.
  int* cw = smem;
  int* delta = cw + (kRanks ? REPRO_WARPS_PER_BLOCK : 1) * nb;
  int* first_run = delta + nb;
  int* warp_sums = first_run + nb;
  int* stage_key = warp_sums + 32;
  int* stage_idx = stage_key + DIGIT_TILE;
  for (int i = threadIdx.x; i < (kRanks ? REPRO_WARPS_PER_BLOCK : 1) * nb;
       i += DIGIT_THREADS)
    cw[i] = 0;
  for (int i = threadIdx.x; i < nb; i += DIGIT_THREADS) first_run[i] = 0;

  // Lower digits of the tile's first and last rows, and whether the next
  // tile starts with the same lower digits (the last digit's kernels).
  const int lo_mask = (1 << shift) - 1;
  const int tile_end = min(n, (t + 1) * DIGIT_TILE);
  int lo_first = 0, lo_last = 0;
  bool cont_next = false;
  if constexpr (kKind == kCountLast || kKind == kRankLast) {
    lo_first = key_in[row0 + t * DIGIT_TILE] & lo_mask;
    lo_last = key_in[row0 + tile_end - 1] & lo_mask;
    cont_next = tile_end < n && (key_in[row0 + tile_end] & lo_mask) == lo_last;
  }

  // Load the warp's rows, every load issued before any is used: rows past
  // n read row n - 1 and get key -1 (buckets are >= 0).
  const int first = t * DIGIT_TILE + warp * 32 * DIGIT_CHUNKS;
  int key[DIGIT_CHUNKS], idx[DIGIT_CHUNKS], wrank[DIGIT_CHUNKS];
  if constexpr (kKind == kHashCount) {
    // An invalid row's keys are not read (its bucket is the sentinel).
    uint32_t h[DIGIT_CHUNKS];
    bool ok[DIGIT_CHUNKS];
#pragma unroll
    for (int j = 0; j < DIGIT_CHUNKS; ++j) {
      h[j] = 0;
      ok[j] = valid[row0 + min(first + 32 * j + lane, n - 1)] != 0;
    }
    for (int c = 0; c < w; ++c) {
      const uint32_t seed = join_seed(c);
#pragma unroll
      for (int j = 0; j < DIGIT_CHUNKS; ++j) {
        const int i = min(first + 32 * j + lane, n - 1);
        const int k = ok[j] ? keys[(row0 + i) * w + c] : 0;
        h[j] += (uint32_t)k * seed;
      }
    }
#pragma unroll
    for (int j = 0; j < DIGIT_CHUNKS; ++j) {
      const int i = first + 32 * j + lane;
      key[j] = ok[j] ? (int)((h[j] * REPRO_MULT) >> (32 - n_bits))
                     : 1 << n_bits;
      if (i < n) key_out[row0 + i] = key[j];
      else key[j] = -1;
    }
  } else {
#pragma unroll
    for (int j = 0; j < DIGIT_CHUNKS; ++j) {
      const int i = first + 32 * j + lane;
      key[j] = key_in[row0 + min(i, n - 1)];
      if constexpr (kStage) idx[j] = idx_in ? idx_in[row0 + min(i, n - 1)] : i;
    }
#pragma unroll
    for (int j = 0; j < DIGIT_CHUNKS; ++j)
      if (first + 32 * j + lane >= n) key[j] = -1;
  }
  __syncthreads();

  // Count; for the ranks also each row's place among its warp's rows of
  // its digit, and for kRankLast each digit's rows of the tile's first
  // lower digits.
  int* mine = cw + (kRanks ? warp * nb : 0);
  const unsigned lt = lanemask_lt();
#pragma unroll
  for (int j = 0; j < DIGIT_CHUNKS; ++j) {
    int d = key[j] < 0 ? -1 : bucket_digit(key[j], shift, bits, top);
    if constexpr (kKind == kCountLast)
      if ((key[j] & lo_mask) != lo_last) d = -1;
    const unsigned same = match_digit(d, match_bits);
    const int leader = d >= 0 ? __ffs(same) - 1 : lane;
    int old = 0;
    if (d >= 0 && lane == leader) old = atomicAdd(mine + d, __popc(same));
    if constexpr (kRanks)
      wrank[j] = __shfl_sync(REPRO_FULL_MASK, old, leader) + __popc(same & lt);
    if constexpr (kKind == kRankLast) {
      const unsigned in_first =
          same & __ballot_sync(REPRO_FULL_MASK,
                               d >= 0 && (key[j] & lo_mask) == lo_first);
      if (in_first && lane == __ffs(in_first) - 1)
        atomicAdd(first_run + d, __popc(in_first));
    }
  }
  __syncthreads();
  if constexpr (!kRanks) {
    for (int d = threadIdx.x; d < nb; d += DIGIT_THREADS)
      th_b[(long long)d * n_tiles] = cw[d];
    return;
  }

  // Each warp's first place per digit: the tile's base (kRankOnly) or the
  // digit's start in the stage, plus the earlier warps' rows of that digit.
  for (int d = threadIdx.x; d < nb; d += DIGIT_THREADS) {
    int run = kKind == kRankOnly ? th_b[(long long)d * n_tiles] : 0;
    for (int v = 0; v < REPRO_WARPS_PER_BLOCK; ++v) {
      const int c = cw[v * nb + d];
      cw[v * nb + d] = run;
      run += c;
    }
    delta[d] = run;   // the tile's count of digit d
  }
  __syncthreads();
  if constexpr (kStage) {
    block_exclusive_scan(delta, nb, warp_sums);   // delta = stage starts
    for (int d = threadIdx.x; d < nb; d += DIGIT_THREADS) {
      const int start = delta[d];
      for (int v = 0; v < REPRO_WARPS_PER_BLOCK; ++v) cw[v * nb + d] += start;
      // kScatter: stage place -> place in key_out; kRankLast: the carry.
      delta[d] = kKind == kScatter
                     ? tot[blockIdx.y * nb + d] + th_b[(long long)d * n_tiles] - start
                     : th_b[(long long)d * n_tiles];
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < DIGIT_CHUNKS; ++j) {
    if (key[j] < 0) continue;
    const int r = mine[bucket_digit(key[j], shift, bits, top)] + wrank[j];
    if constexpr (kKind == kRankOnly) {
      rank[row0 + first + 32 * j + lane] = r;
    } else {
      stage_key[r] = key[j];
      stage_idx[r] = idx[j];
    }
  }
  if constexpr (!kStage) return;
  __syncthreads();
  const int len = tile_end - t * DIGIT_TILE;
  if constexpr (kKind == kScatter) {
    for (int r = threadIdx.x; r < len; r += DIGIT_THREADS) {
      const int k = stage_key[r];
      const long long at = row0 + r + delta[bucket_digit(k, shift, bits, top)];
      key_out[at] = k;
      idx_out[at] = stage_idx[r];
    }
    return;
  }

  // kRankLast: warp w takes stage places [w * 512, (w + 1) * 512) in
  // chunks; a place starts a run when its bucket differs from the one
  // before.  First the last run start of each warp's span, then the walk
  // with the run start carried across chunks and warps.
  const int span0 = warp * 32 * DIGIT_CHUNKS;
  int* last_start = warp_sums;   // free again after the scan
  auto starts_at = [&](int r) {
    return r < len && (r == 0 || stage_key[r - 1] != stage_key[r]);
  };
  int run_start = -1;
#pragma unroll
  for (int j = 0; j < DIGIT_CHUNKS; ++j) {
    const unsigned bal = __ballot_sync(REPRO_FULL_MASK,
                                       starts_at(span0 + 32 * j + lane));
    if (bal) run_start = span0 + 32 * j + 31 - __clz(bal);
  }
  if (lane == 0) last_start[warp] = run_start;
  __syncthreads();
  run_start = -1;
  for (int v = 0; v < warp; ++v) run_start = max(run_start, last_start[v]);
  int* tab_b = tab + blockIdx.y * ((1LL << n_bits) + 1);
  const unsigned le = lt | (1u << lane);
#pragma unroll
  for (int j = 0; j < DIGIT_CHUNKS; ++j) {
    const int r = span0 + 32 * j + lane;
    const unsigned bal = __ballot_sync(REPRO_FULL_MASK, starts_at(r));
    const unsigned upto = bal & le;
    const int start = upto ? span0 + 32 * j + 31 - __clz(upto) : run_start;
    if (bal) run_start = span0 + 32 * j + 31 - __clz(bal);
    if (r >= len) continue;
    const int k = stage_key[r];
    const int lo = k & lo_mask;
    const int carry = lo == lo_first ? delta[k >> shift] : 0;
    rank[row0 + stage_idx[r]] = carry + r - start;
    const bool run_end = r == len - 1 || stage_key[r + 1] != k;
    if (run_end && lo != lo_first && !(lo == lo_last && cont_next))
      tab_b[k] = r + 1 - start;
  }
  // The tile's first lower digits end here unless the whole tile is one
  // lower-digit run that the next tile continues: their counts are the
  // carry plus this tile's rows.
  if (!(lo_first == lo_last && cont_next)) {
    for (int d = threadIdx.x; d < nb; d += DIGIT_THREADS) {
      const int c = delta[d] + first_run[d];
      if (c > 0) tab_b[((long long)d << shift) | lo_first] = c;
    }
  }
}

template <int kKind>
static cudaError_t launch_digit(const int* keys, const unsigned char* valid,
                                int w, int n_bits, int B, int n, int n_tiles,
                                int shift, int bits, int top, int* th,
                                const int* tot, const int* key_in,
                                const int* idx_in, int* key_out, int* idx_out,
                                int* rank, int* tab, cudaStream_t s) {
  const bool ranks =
      kKind == kRankOnly || kKind == kScatter || kKind == kRankLast;
  const bool stage = kKind == kScatter || kKind == kRankLast;
  const int nb = digit_bins(bits, top);
  const size_t smem =
      sizeof(int) * ((ranks ? REPRO_WARPS_PER_BLOCK : 1) * nb + 2 * nb + 32 +
                     (stage ? 2 * DIGIT_TILE : 0));
  cudaError_t err = cudaFuncSetAttribute(
      digit_tile_kernel<kKind>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  digit_tile_kernel<kKind><<<dim3(n_tiles, B), DIGIT_THREADS, smem, s>>>(
      keys, valid, w, n_bits, n, n_tiles, shift, bits, top, th, tot, key_in,
      idx_in, key_out, idx_out, rank, tab);
  return cudaGetLastError();
}

// The last digit's carries, in place over th's kCountLast counts: one
// warp per (b, digit) row over the tiles.  carry[t] is that digit's rows
// with tile t's first lower digits L in tiles before t: 0 unless tile t
// continues the last lower-digit run of tile t - 1 (which is then L), else
// last[t - 1] + (tile t - 1 is all L ? carry[t - 1] : 0).  That affine
// recurrence is composed per lane over a span of tiles, scanned across
// the warp, then applied.
static __global__ void tile_carry_kernel(const int* skey, int B, int n,
                                         int n_tiles, int nb, int shift,
                                         int* th) {
  const long long row = (long long)blockIdx.x * REPRO_WARPS_PER_BLOCK +
                        (threadIdx.x >> 5);   // b * nb + digit
  if (row >= (long long)B * nb) return;
  const int lane = threadIdx.x & 31;
  const int* X = skey + (row / nb) * n;
  int* c = th + row * n_tiles;
  const int lo_mask = (1 << shift) - 1;
  const int per = (n_tiles + 31) / 32;
  const int t0 = min(lane * per, n_tiles), t1 = min(t0 + per, n_tiles);
  // (m, a) of tile t: carry[t] = m * carry[t - 1] + a.  Loads do not
  // depend on the recurrence, so they are issued ahead of it.
  auto step = [&](int tt, int prev_last, int* m, int* a) {
    const int u = tt * DIGIT_TILE;   // < n; tile 0 reads row 0 only
    const int end_lo = X[max(u - 1, 0)] & lo_mask;
    const bool cont = tt > 0 && (X[u] & lo_mask) == end_lo;
    *a = cont ? prev_last : 0;
    *m = cont && (X[max(u - DIGIT_TILE, 0)] & lo_mask) == end_lo;
  };
  const int before = t0 > 0 && t0 < t1 ? c[t0 - 1] : 0;
  int M = 1, A = 0, prev_last = before;
#pragma unroll 4
  for (int tt = t0; tt < t1; ++tt) {
    int m, a;
    step(tt, prev_last, &m, &a);
    M *= m;
    A = m * A + a;
    prev_last = c[tt];
  }
  for (int o = 1; o < 32; o <<= 1) {   // inclusive scan of the maps
    const int uM = __shfl_up_sync(REPRO_FULL_MASK, M, o);
    const int uA = __shfl_up_sync(REPRO_FULL_MASK, A, o);
    if (lane >= o) {
      A = M * uA + A;
      M = M * uM;
    }
  }
  int carry = __shfl_up_sync(REPRO_FULL_MASK, A, 1);
  if (lane == 0) carry = 0;
  __syncwarp();
  prev_last = before;
#pragma unroll 4
  for (int tt = t0; tt < t1; ++tt) {
    int m, a;
    step(tt, prev_last, &m, &a);
    prev_last = c[tt];
    carry = m * carry + a;
    c[tt] = carry;
  }
}

// th: B * (2^digit_bits + 1) * n_tiles ints, n_tiles = ceil(n / DIGIT_TILE);
// tot: B * (2^digit_bits + 1); key_a, idx_a: B * n each (unused for one
// digit), key_b, idx_b: the same from three digits on; tab: the
// (B, 2^n_bits + 1) histogram table (its last column the sentinel's count).
extern "C" int build_table_launch(const int* keys, const unsigned char* valid,
                                  int B, int n, int w, int n_bits,
                                  int digit_bits, int n_tiles, int* th,
                                  int* tot, int* key_a, int* idx_a,
                                  int* key_b, int* idx_b, int* bkt, int* rank,
                                  int* tab, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || n == 0) return 0;
  if (n_tiles != (n + DIGIT_TILE - 1) / DIGIT_TILE)
    return (int)cudaErrorInvalidValue;
  const int passes = (n_bits + digit_bits - 1) / digit_bits;
  const long long nt = (1LL << n_bits) + 1;
  cudaError_t err;
  const int* key_in = bkt;
  const int* idx_in = nullptr;
  for (int j = 0; j < passes; ++j) {
    const int shift = j * digit_bits;
    const int top = j == passes - 1;
    const int bits = top ? n_bits - shift : digit_bits;
    const int nb = digit_bins(bits, top);
    if (j == 0)
      err = launch_digit<kHashCount>(keys, valid, w, n_bits, B, n, n_tiles,
                                     shift, bits, top, th, nullptr, nullptr,
                                     nullptr, bkt, nullptr, nullptr, nullptr,
                                     s);
    else if (!top)
      err = launch_digit<kCount>(keys, valid, w, n_bits, B, n, n_tiles,
                                 shift, bits, top, th, nullptr, key_in,
                                 nullptr, nullptr, nullptr, nullptr, nullptr,
                                 s);
    else
      err = launch_digit<kCountLast>(keys, valid, w, n_bits, B, n, n_tiles,
                                     shift, bits, top, th, nullptr, key_in,
                                     nullptr, nullptr, nullptr, nullptr,
                                     nullptr, s);
    if (err != cudaSuccess) return (int)err;
    if (passes == 1) {   // one digit: the totals are the histogram
      if ((err = launch_scan_rows(th, (long long)B * nb, n_tiles, nb, nb, tab,
                                  s)) != cudaSuccess)
        return (int)err;
      return (int)launch_digit<kRankOnly>(keys, valid, w, n_bits, B, n,
                                          n_tiles, shift, bits, top, th,
                                          nullptr, bkt, nullptr, nullptr,
                                          nullptr, rank, nullptr, s);
    }
    if (top) {
      tile_carry_kernel<<<blocks_for((long long)B * nb, REPRO_WARPS_PER_BLOCK),
                          32 * REPRO_WARPS_PER_BLOCK, 0, s>>>(
          key_in, B, n, n_tiles, nb, shift, th);
      if ((err = cudaGetLastError()) != cudaSuccess ||
          (err = cudaMemsetAsync(tab, 0, sizeof(int) * (size_t)(B * nt), s)) !=
              cudaSuccess)
        return (int)err;
      return (int)launch_digit<kRankLast>(keys, valid, w, n_bits, B, n,
                                          n_tiles, shift, bits, top, th,
                                          nullptr, key_in, idx_in, nullptr,
                                          nullptr, rank, tab, s);
    }
    if ((err = launch_scan_rows(th, (long long)B * nb, n_tiles, nb, nb, tot,
                                s)) != cudaSuccess ||
        (err = launch_scan_rows(tot, B, nb, 1, 1, nullptr, s)) != cudaSuccess)
      return (int)err;
    int* key_out = j % 2 == 0 ? key_a : key_b;
    int* idx_out = j % 2 == 0 ? idx_a : idx_b;
    if ((err = launch_digit<kScatter>(keys, valid, w, n_bits, B, n, n_tiles,
                                      shift, bits, top, th, tot, key_in,
                                      idx_in, key_out, idx_out, nullptr,
                                      nullptr, s)) != cudaSuccess)
      return (int)err;
    key_in = key_out;
    idx_in = idx_out;
  }
  return 0;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
