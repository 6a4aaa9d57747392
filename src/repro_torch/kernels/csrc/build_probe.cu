// segment_scan / run_lengths (the grouping pass of the sort-merge reduce)
// and match_counts / first_match (a hash table of the build side).
//
// Replaces the Pallas `_seg_scan_kernel` (src/repro/kernels/build_probe.py:69,
// launched by `segment_scan` at :152/:167) and `run_lengths` (:190), which
// runs that scan a second time over the reversed keys.  Keys are (B, n, w)
// int32, sorted within each batch row; runs never cross a batch row.  Row i
// starts a run when i == 0 or any column differs from row i - 1.
// seg[b, i] is the number of runs started at or before i, minus one;
// start[b, i] the first row of i's run; len[b, i] its length.
//
// Bound: reading the keys once and writing seg and start (and len).  The
// TPU kernel carries (run starts so far, last run start) across a grid that
// runs in order; here one pass over the keys carries it across tiles by a
// decoupled look-back:
//   1. seg_scan_kernel: a block takes the next tile of `tile_rows` rows
//      from an atomic ticket (so every earlier tile's block has started),
//      copies the tile's words and the row before it into shared memory,
//      consecutive threads on consecutive words, 16 bytes a load where the
//      address allows (a tile too wide for SEG_SMEM_BYTES is read in
//      place), and flags each row that differs from the row before it.
//      Warp v owns the tile's v-th eighth, 32 consecutive rows a round: one
//      ballot a round gives each row its count, last start and next start
//      within the warp, and the eight warps' aggregates in shared memory
//      give them within the tile.
//   2. The block publishes its aggregate (run starts, last start) as one
//      64-bit status word (2 flag bits, 31 bits of count, 31 of start + 1);
//      its first warp then reads back over the earlier tiles' words, 32 at
//      a time, until it meets an inclusive prefix, and publishes its own.
//      The carry's operator is (c1, r1) + (c2, r2) = (c1 + c2, r2 >= 0 ?
//      r2 : r1).  seg = the carried count + the row's count in the tile - 1;
//      start = the row's last start in the tile, else the carried start.
//   3. run_lengths: a row whose run ends inside its tile gets len in step
//      1's pass.  Each tile also publishes its first run start, and
//      seg_tail_kernel, in the same call, gives the rows of each tile's
//      trailing run the first start of the later tiles (or n) as their end;
//      for keys all equal that is every row, one more write of len.
// Scratch is (B, tiles): the status words, the ticket and the first starts.
// segment_scan leaves out step 3 and the first starts.
#include "common.cuh"

#define SEG_THREADS 256
#define SEG_WARPS (SEG_THREADS / 32)
// A warp's rows in a tile are at most SEG_MAX_ROUNDS rounds of 32: a tile
// holds a multiple of SEG_THREADS rows, at most SEG_THREADS *
// SEG_MAX_ROUNDS (build_probe.py::seg_tile_rows chooses it from w).
#define SEG_MAX_ROUNDS 8
// Shared memory that may stage a tile's words; a tile that needs more is
// compared in place in device memory.
#define SEG_SMEM_BYTES (40 * 1024)
#define SEG_TAIL_THREADS 128
#define SEG_AGGREGATE 1ull
#define SEG_PREFIX 2ull

static __device__ __forceinline__ unsigned long long seg_word(
    unsigned long long flag, int count, int start) {
  return (flag << 62) | ((unsigned long long)count << 31) |
         (unsigned long long)(start + 1);
}

static __device__ __forceinline__ int seg_count(unsigned long long v) {
  return (int)((v >> 31) & 0x7fffffffull);
}

static __device__ __forceinline__ int seg_start(unsigned long long v) {
  return (int)(v & 0x7fffffffull) - 1;
}

static __device__ __forceinline__ unsigned long long seg_load(
    const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}

// Whether the row at `row` (w words) differs from the row before it.
static __device__ __forceinline__ bool seg_differs(const int* row, int w) {
  for (int c = 0; c < w; ++c)
    if (row[c] != row[c - w]) return true;
  return false;
}

template <bool kLength>
static __global__ void __launch_bounds__(SEG_THREADS)
seg_scan_kernel(const int* keys, long long n, int w, int tile_rows,
                long long n_tiles, bool staged, unsigned long long* status,
                int* tile_first, int* seg, int* start, int* len) {
  extern __shared__ __align__(16) int smem[];
  __shared__ long long s_ticket;
  __shared__ int s_cnt[SEG_WARPS], s_first[SEG_WARPS], s_last[SEG_WARPS];
  __shared__ int s_carry[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // The ticket is the word after the (B, n_tiles) status words.
  if (tid == 0) s_ticket = (long long)atomicAdd(status + gridDim.x, 1ull);
  __syncthreads();
  const long long b = s_ticket / n_tiles, T = s_ticket % n_tiles;
  const long long r0 = T * tile_rows;
  const int n_rows = (int)(n - r0 < tile_rows ? n - r0 : tile_rows);
  const int* g = keys + (b * n + r0) * w;          // row r0
  const int* rows = g;
  if (staged) {
    // Word k of the tile (k in [-w, n_rows * w), -w the row before it) goes
    // to smem[sh + w + k], sh chosen so that 16-byte aligned words of g
    // land on 16-byte aligned shared words.
    const int sh = (int)((((unsigned long long)(uintptr_t)g >> 2) -
                          (unsigned long long)w) & 3ull);
    int* dst = smem + sh + w;
    const int k_lo = r0 > 0 ? -w : 0, k_hi = n_rows * w;
    int v_lo = k_lo + ((4 - ((sh + w + k_lo) & 3)) & 3);
    int v_hi = k_hi - ((sh + w + k_hi) & 3);
    if (v_lo > v_hi) v_lo = v_hi = k_hi;
    for (int k = k_lo + tid; k < v_lo; k += SEG_THREADS) dst[k] = g[k];
#pragma unroll 4
    for (int k = v_lo + 4 * tid; k < v_hi; k += 4 * SEG_THREADS)
      *reinterpret_cast<int4*>(dst + k) =
          *reinterpret_cast<const int4*>(g + k);
    for (int k = v_hi + tid; k < k_hi; k += SEG_THREADS) dst[k] = g[k];
    rows = dst;
    __syncthreads();
  }

  // Run starts, one ballot per round of 32 consecutive rows.
  const int rpw = tile_rows / SEG_WARPS, rounds = rpw / 32;
  const int w0 = warp * rpw;                        // the warp's first row
  const unsigned le = lanemask_lt() | (1u << lane);
  unsigned ball[SEG_MAX_ROUNDS];
  int wc = 0, wf = -1, wl = -1;
#pragma unroll
  for (int j = 0; j < SEG_MAX_ROUNDS; ++j) {
    ball[j] = 0;
    if (j < rounds) {
      const int li = w0 + j * 32 + lane;
      const bool f = li < n_rows &&
                     (r0 + li == 0 || seg_differs(rows + (long long)li * w, w));
      ball[j] = __ballot_sync(REPRO_FULL_MASK, f);
      if (ball[j]) {
        wc += __popc(ball[j]);
        if (wf < 0) wf = w0 + j * 32 + __ffs(ball[j]) - 1;
        wl = w0 + j * 32 + 31 - __clz(ball[j]);
      }
    }
  }
  if (lane == 0) {
    s_cnt[warp] = wc;
    s_first[warp] = wf;
    s_last[warp] = wl;
  }
  __syncthreads();

  // The tile's aggregate, published; then the look-back for its carry.
  if (warp == 0) {
    const bool mine = lane < SEG_WARPS;
    const int count = __reduce_add_sync(REPRO_FULL_MASK, mine ? s_cnt[lane] : 0);
    const unsigned fmin = __reduce_min_sync(
        REPRO_FULL_MASK, mine ? (unsigned)s_first[lane] : 0xffffffffu);
    const int lmax = __reduce_max_sync(REPRO_FULL_MASK,
                                       mine ? s_last[lane] : -1);
    const int last = lmax < 0 ? -1 : (int)r0 + lmax;
    unsigned long long* st = status + b * n_tiles;
    if (lane == 0) {
      if (kLength)
        tile_first[b * n_tiles + T] =
            fmin == 0xffffffffu ? -1 : (int)r0 + (int)fmin;
      *(volatile unsigned long long*)(st + T) =
          seg_word(T == 0 ? SEG_PREFIX : SEG_AGGREGATE, count, last);
    }
    int ecnt = 0, est = -1;
    for (long long pos = T - 1; pos >= 0; pos -= 32) {
      // Lane l reads tile pos - l; a lane before tile 0 reads an empty
      // prefix.  Only the tiles up to the nearest prefix count.
      const long long j = pos - lane;
      unsigned long long v = j >= 0 ? seg_load(st + j)
                                    : seg_word(SEG_PREFIX, 0, -1);
      while (!__all_sync(REPRO_FULL_MASK, (v >> 62) != 0))
        if ((v >> 62) == 0) v = seg_load(st + j);
      const unsigned p = __ballot_sync(REPRO_FULL_MASK, (v >> 62) == SEG_PREFIX);
      const bool inc = lane <= (p ? __ffs(p) - 1 : 31);
      ecnt += __reduce_add_sync(REPRO_FULL_MASK, inc ? seg_count(v) : 0);
      const int sv = inc ? seg_start(v) : -1;
      const unsigned has = __ballot_sync(REPRO_FULL_MASK, sv >= 0);
      if (est < 0 && has) est = __shfl_sync(REPRO_FULL_MASK, sv, __ffs(has) - 1);
      if (p) break;
    }
    if (lane == 0) {
      if (T > 0)
        *(volatile unsigned long long*)(st + T) =
            seg_word(SEG_PREFIX, ecnt + count, last >= 0 ? last : est);
      s_carry[0] = ecnt;
      s_carry[1] = est;
    }
  }
  __syncthreads();

  // The carry into the warp's rows, and the first start after them.
  int cnt = s_carry[0], run = s_carry[1], after = -1;
  for (int v = 0; v < SEG_WARPS; ++v) {
    if (v < warp) {
      cnt += s_cnt[v];
      if (s_last[v] >= 0) run = (int)r0 + s_last[v];
    } else if (v > warp && after < 0 && s_first[v] >= 0) {
      after = (int)r0 + s_first[v];
    }
  }
  // nxt[j]: the first start after round j within the tile, or -1 (the
  // tile's trailing run, written by seg_tail_kernel).
  int nxt[SEG_MAX_ROUNDS];
  if (kLength) {
#pragma unroll
    for (int j = SEG_MAX_ROUNDS - 1; j >= 0; --j) {
      nxt[j] = after;
      if (ball[j]) after = (int)r0 + w0 + j * 32 + __ffs(ball[j]) - 1;
    }
  }
  const long long out0 = b * n + r0;
#pragma unroll
  for (int j = 0; j < SEG_MAX_ROUNDS; ++j) {
    if (j < rounds) {
      const int base = (int)r0 + w0 + j * 32;
      const int li = w0 + j * 32 + lane;
      const unsigned m = ball[j] & le;
      const int s_i = m ? base + 31 - __clz(m) : run;
      if (li < n_rows) {
        seg[out0 + li] = cnt + __popc(m) - 1;
        start[out0 + li] = s_i;
        if (kLength) {
          const unsigned a = ball[j] & ~le;
          const int e = a ? base + __ffs(a) - 1 : nxt[j];
          if (e >= 0) len[out0 + li] = e - s_i;
        }
      }
      cnt += __popc(ball[j]);
      if (ball[j]) run = base + 31 - __clz(ball[j]);
    }
  }
}

// One block a tile: its trailing run [max(last start, r0), tile end) ends
// at the first run start of the later tiles of its batch row, else at n.
static __global__ void __launch_bounds__(SEG_TAIL_THREADS)
seg_tail_kernel(long long n, int tile_rows, long long n_tiles,
                const unsigned long long* status, const int* tile_first,
                int* len) {
  __shared__ unsigned s_min[SEG_TAIL_THREADS / 32];
  const long long b = blockIdx.x / n_tiles, T = blockIdx.x % n_tiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = seg_start(status[blockIdx.x]);
  const int* tf = tile_first + b * n_tiles;
  unsigned end = (unsigned)n;
  for (long long j0 = T + 1; j0 < n_tiles; j0 += SEG_TAIL_THREADS) {
    const long long j = j0 + tid;
    // -1 (no start) reads as the largest unsigned.
    const unsigned f = j < n_tiles ? (unsigned)tf[j] : 0xffffffffu;
    const unsigned m = __reduce_min_sync(REPRO_FULL_MASK, f);
    if (lane == 0) s_min[warp] = m;
    __syncthreads();
    unsigned blk = s_min[0];
    for (int v = 1; v < SEG_TAIL_THREADS / 32; ++v)
      blk = s_min[v] < blk ? s_min[v] : blk;
    __syncthreads();
    if (blk != 0xffffffffu) {
      end = blk;
      break;
    }
  }
  const long long r0 = T * tile_rows;
  const long long r1 = r0 + tile_rows < n ? r0 + tile_rows : n;
  int* out = len + b * n;
  for (long long i = (s > r0 ? s : r0) + tid; i < r1; i += SEG_TAIL_THREADS)
    out[i] = (int)end - s;
}

// status: B * n_tiles + 1 words (the last is the tile ticket), cleared
// here; tile_first: B * n_tiles ints.  len == nullptr: segment_scan only
// (tile_first unused).  tile_rows is a multiple of SEG_THREADS up to
// SEG_THREADS * SEG_MAX_ROUNDS, n_tiles = ceil(n / tile_rows), n < 2^31.
extern "C" int segment_scan_launch(const int* keys, int B, long long n, int w,
                                   int tile_rows, long long n_tiles,
                                   unsigned long long* status, int* tile_first,
                                   int* seg, int* start, int* len,
                                   void* stream) {
  if (tile_rows <= 0 || tile_rows % SEG_THREADS != 0 ||
      tile_rows > SEG_THREADS * SEG_MAX_ROUNDS || w < 0 || n <= 0 ||
      n >= (1LL << 31) || n_tiles != (n + tile_rows - 1) / tile_rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = (long long)B * n_tiles;
  cudaError_t err = cudaMemsetAsync(
      status, 0, sizeof(unsigned long long) * (size_t)(total + 1), s);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(int) * ((size_t)(tile_rows + 1) * w + 3);
  const bool staged = smem <= SEG_SMEM_BYTES;
  const size_t dyn = staged ? smem : 0;
  if (len == nullptr) {
    seg_scan_kernel<false><<<(unsigned)total, SEG_THREADS, dyn, s>>>(
        keys, n, w, tile_rows, n_tiles, staged, status, tile_first, seg,
        start, len);
    return (int)cudaGetLastError();
  }
  seg_scan_kernel<true><<<(unsigned)total, SEG_THREADS, dyn, s>>>(
      keys, n, w, tile_rows, n_tiles, staged, status, tile_first, seg, start,
      len);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  seg_tail_kernel<<<(unsigned)total, SEG_TAIL_THREADS, 0, s>>>(
      n, tile_rows, n_tiles, status, tile_first, len);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// match_counts / first_match
// ---------------------------------------------------------------------------
//
// Replace the Pallas `_match_counts_kernel` and `_first_match_kernel`
// (src/repro/kernels/build_probe.py:45 and :56, launched by `match_counts`
// at :99/:112 and `first_match` at :127/:136), a grid of (probe block x
// build block) equality tiles that suits the TPU's vector unit.  probe
// (n_p,) and build (n_b,) are int32; counts[i] = |{j : build[j] ==
// probe[i]}|, first[i] = the least such j, or -1.  The TPU kernels pad both
// sides (build with -1, probe with -2); nothing is padded here, and every
// key value is data.
//
// Bound: bytes, each key read once and each output written once (4 (2 n_p
// + n_b)).  The nested loop's 2 n_p n_b compares, on the SM's 64 INT32
// lanes, go: a hash table of the build side takes their place.
//   - Slot word: (uint32(key) << 32) | value, value = the key's count
//     (match_counts) or its least j + 1 (first_match).  An occupied word is
//     never 0, so 0 marks an empty slot and no key is reserved.
//   - A key's hash is uint32(key) * MULT; its partition the top pbits bits,
//     its home slot the fast range of the bits below them over the table's
//     S slots (kernels/build_probe.py::match_slot / match_partition).  A
//     collision probes linearly and wraps at S > n_b, so a probe ends at its
//     key or at an empty slot.
//   - Inserts commute: a 64-bit CAS from 0 claims a slot, a slot's key never
//     changes after, and a key's later inserts add their count or take the
//     min of the values with a 32-bit atomic on the word's low half, which
//     never carries into the key (n_b < 2^31).  So the table does not depend
//     on the order of the atomics.
// Two arms; the wrapper's match_plan picks the arm, S, pbits and the grid:
//   shared (a table of load <= 0.7 fits MATCH_SHARED_BYTES; S up to 4 n_b
//     while it fits): one launch, no memset.  Block b takes partition b % P (P = 2^pbits) and probe slice
//     b / P: it clears its table in shared memory, scans the whole build side
//     (16-byte loads where the address allows) and inserts its partition's
//     keys, then looks up its slice's probe keys of its partition.  The
//     partitions cut each block's inserts to n_b / P and its table's load to
//     a P-th; the slices spread a long probe side over the card.  A
//     partition's table still holds every build key, so keys that all share
//     one partition stay correct (one block then does the work).
//   device: one table of S = 10 n_b / 7 + 1 words in the wrapper's scratch
//     (resident in the 50 MB L2 up to a few million slots): a memset clears
//     it, one kernel inserts and one probes, all behind one C entry point.
//     A warp merges its equal keys before the L2 atomics (__match_any_sync:
//     the group's popcount, or its first lane's j, the least of a round), so
//     a heavy key costs an atomic a warp and not one a copy.
// Tried on an H100 (scripts/time_match_plans.py times the plans around the
// kept one): the first version of this kernel had every block build the
// whole table (P = 1) at load 0.7, with a warp merge and 64-bit atomics for
// the values.  __match_any_sync issues slowly on Hopper, 64-bit atomicAdd /
// atomicMin on shared memory compile to CAS loops (ATOMS.CAST.SPIN), and at
// load 0.7 one slow lane's probe run holds its warp.  The shared arm keeps
// no merge: a heavy key's copies are native 32-bit shared atomics on one
// word.
#define MATCH_SHARED 0
#define MATCH_DEVICE 1
#define MATCH_SHARED_THREADS 1024
#define MATCH_DEVICE_THREADS 256
#define MATCH_SHARED_BYTES (200 * 1024)
#define MATCH_MAX_PART_BITS 7

typedef unsigned long long match_word;

// A key's multiply-shift hash; its partition is the top `pbits` bits and
// its home slot the fast range of the bits below them.
__device__ __forceinline__ uint32_t match_hash(int key) {
  return (uint32_t)key * REPRO_MULT;
}

__device__ __forceinline__ uint32_t match_home(uint32_t h, int pbits,
                                               uint32_t slots) {
  return (uint32_t)(((uint64_t)(h << pbits) * slots) >> 32);
}

__device__ __forceinline__ uint32_t match_part(uint32_t h, int pbits) {
  return pbits ? h >> (32 - pbits) : 0;
}

// Inserts `value` (a count, or a build index + 1) for `key` from its home
// slot.  The claim is one 64-bit CAS from 0; a claimed word's key never
// changes, and its value is updated by a 32-bit atomic on the word's low
// half (little-endian), which never carries into the key.  A stale read
// shows an older word: 0 (the CAS then returns the slot's word) or the
// same key with a larger first index.
template <bool kFirst>
__device__ __forceinline__ void match_insert(match_word* table,
                                             uint32_t slots, uint32_t home,
                                             int key, uint32_t value) {
  const match_word word = ((match_word)(uint32_t)key << 32) | value;
  for (uint32_t h = home;; h = h + 1 == slots ? 0 : h + 1) {
    match_word cur = *(volatile match_word*)&table[h];
    if (cur == 0) {
      cur = atomicCAS(&table[h], (match_word)0, word);
      if (cur == 0) return;
    }
    if ((uint32_t)(cur >> 32) != (uint32_t)key) continue;
    unsigned* low = reinterpret_cast<unsigned*>(&table[h]);
    if constexpr (kFirst) {
      if (value < (uint32_t)cur) atomicMin(low, value);
    } else {
      atomicAdd(low, value);
    }
    return;
  }
}

// counts: the key's count (0 if absent); first: its least j, or -1.
template <bool kFirst>
__device__ __forceinline__ int match_lookup(const match_word* table,
                                            uint32_t slots, uint32_t home,
                                            int key) {
  for (uint32_t h = home;; h = h + 1 == slots ? 0 : h + 1) {
    const match_word w = table[h];
    if (w == 0) return kFirst ? -1 : 0;
    if ((uint32_t)(w >> 32) == (uint32_t)key)
      return (int)(uint32_t)w - (kFirst ? 1 : 0);
  }
}

// Calls fn(j, key) for every build key j of [0, n_b) that thread `t` of
// `n_t` owns: 16-byte loads where the address allows.
template <class Fn>
__device__ __forceinline__ void match_each_build(const int* build,
                                                 long long n_b, long long t,
                                                 long long n_t, Fn fn) {
  long long body = 0;
  if ((((uintptr_t)build) & 15) == 0) {
    body = n_b & ~3LL;
    for (long long q = t; q < body / 4; q += n_t) {
      const int4 v = reinterpret_cast<const int4*>(build)[q];
      fn(4 * q, v.x);
      fn(4 * q + 1, v.y);
      fn(4 * q + 2, v.z);
      fn(4 * q + 3, v.w);
    }
  }
  for (long long j = body + t; j < n_b; j += n_t) fn(j, build[j]);
}

// Shared arm.  Block b owns partition b % P (P = 2^pbits) of the keys and
// slice b / P of the probe side: it clears its table, inserts the build
// keys of its partition, and looks up the probe keys of its slice that fall
// in its partition.
template <bool kFirst>
static __global__ void __launch_bounds__(MATCH_SHARED_THREADS)
match_shared_kernel(const int* probe, long long n_p, const int* build,
                    long long n_b, uint32_t slots, int pbits, int* out) {
  extern __shared__ match_word match_table[];
  for (uint32_t i = threadIdx.x; i < slots; i += blockDim.x)
    match_table[i] = 0;
  __syncthreads();
  const uint32_t part = blockIdx.x & ((1u << pbits) - 1);
  match_each_build(build, n_b, threadIdx.x, blockDim.x,
                   [&](long long j, int key) {
    const uint32_t h = match_hash(key);
    if (match_part(h, pbits) == part)
      match_insert<kFirst>(match_table, slots, match_home(h, pbits, slots),
                           key, kFirst ? (uint32_t)(j + 1) : 1u);
  });
  __syncthreads();
  const long long stride = (long long)(gridDim.x >> pbits) * blockDim.x;
  for (long long i = (long long)(blockIdx.x >> pbits) * blockDim.x
                     + threadIdx.x; i < n_p; i += stride) {
    const int key = probe[i];
    const uint32_t h = match_hash(key);
    if (match_part(h, pbits) == part)
      out[i] = match_lookup<kFirst>(match_table, slots,
                                    match_home(h, pbits, slots), key);
  }
}

// Device arm: one table of `slots` words in device memory.  A warp merges
// its equal keys before the atomics (__match_any_sync: the group's
// popcount, or its first lane's j, the least of the round), so a heavy key
// costs an L2 atomic a warp and not one a copy.
template <bool kFirst>
static __global__ void match_insert_kernel(const int* build, long long n_b,
                                           match_word* table,
                                           uint32_t slots) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_t = (long long)gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  for (long long c = t - lane; c < n_b; c += n_t) {   // warp-uniform
    const long long j = c + lane;
    const bool live = j < n_b;
    const int key = live ? build[j] : 0;
    const unsigned same = __match_any_sync(REPRO_FULL_MASK, key)
                          & __ballot_sync(REPRO_FULL_MASK, live);
    if (live && lane == __ffs(same) - 1)
      match_insert<kFirst>(table, slots, match_home(match_hash(key), 0, slots),
                           key, kFirst ? (uint32_t)(j + 1) : __popc(same));
  }
}

template <bool kFirst>
static __global__ void match_probe_kernel(const int* probe, long long n_p,
                                          const match_word* table,
                                          uint32_t slots, int* out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_p; i += stride) {
    const int key = probe[i];
    out[i] = match_lookup<kFirst>(table, slots,
                                  match_home(match_hash(key), 0, slots), key);
  }
}

// (arm, slots, pbits, blocks) come from the wrapper's match_plan; `table`
// is its scratch of `slots` words for the device arm (null for the shared
// arm).  A plan the arms cannot run is refused with cudaErrorInvalidValue.
template <bool kFirst>
static int match_launch(const int* probe, long long n_p, const int* build,
                        long long n_b, int arm, long long slots, int pbits,
                        int blocks, match_word* table, int* out,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_p < 1 || n_b < 1 || slots <= n_b || slots >= (1LL << 31)
      || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (arm == MATCH_SHARED) {
    const size_t bytes = sizeof(match_word) * (size_t)slots;
    if (bytes > MATCH_SHARED_BYTES || table != nullptr || pbits < 0
        || pbits > MATCH_MAX_PART_BITS || blocks % (1 << pbits) != 0)
      return (int)cudaErrorInvalidValue;
    const cudaError_t err = scatter_allow_smem(
        (const void*)match_shared_kernel<kFirst>, bytes);
    if (err != cudaSuccess) return (int)err;
    match_shared_kernel<kFirst><<<blocks, MATCH_SHARED_THREADS, bytes, s>>>(
        probe, n_p, build, n_b, (uint32_t)slots, pbits, out);
    return (int)cudaGetLastError();
  }
  if (arm != MATCH_DEVICE || table == nullptr || pbits != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(table, 0, sizeof(match_word) * slots, s);
  if (err != cudaSuccess) return (int)err;
  match_insert_kernel<kFirst><<<blocks, MATCH_DEVICE_THREADS, 0, s>>>(
      build, n_b, table, (uint32_t)slots);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  match_probe_kernel<kFirst><<<blocks, MATCH_DEVICE_THREADS, 0, s>>>(
      probe, n_p, table, (uint32_t)slots, out);
  return (int)cudaGetLastError();
}

extern "C" int match_counts_launch(const int* probe, long long n_p,
                                   const int* build, long long n_b, int arm,
                                   long long slots, int pbits, int blocks,
                                   void* table, int* out, void* stream) {
  return match_launch<false>(probe, n_p, build, n_b, arm, slots, pbits,
                             blocks, (match_word*)table, out, stream);
}

extern "C" int first_match_launch(const int* probe, long long n_p,
                                  const int* build, long long n_b, int arm,
                                  long long slots, int pbits, int blocks,
                                  void* table, int* out, void* stream) {
  return match_launch<true>(probe, n_p, build, n_b, arm, slots, pbits,
                            blocks, (match_word*)table, out, stream);
}
