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
//      each row then scanned (a block per 4,096 bins);
//   2. probe_place_kernel, a thread per right row: a valid row stores
//      (row, bucket) at its packed slot as one 8-byte word (pr), which is
//      all the walk reads; a sentinel row stores only perm at its slot;
//   3. probe_walk_kernel, a warp per tile of WALK_TILE packed slots of the
//      valid region, 32 slots a step: lanes of equal (bucket, key) find each
//      other (a bucket's lanes are contiguous; one __match_any_sync on a hash
//      of the key, checked column by column), and one leader a key looks its
//      key up among the groups of its bucket's piece of the tile so far (only
//      the bucket still open from the last step can have any).  A key of no
//      group opens one, numbered in lane order.  Each piece of a bucket keeps
//      its groups ("entries") at its own first slot + u: the rep's right row
//      (erow) and the piece's rows of the key (esize); a piece has at least as
//      many slots as keys, so this is O(B n_r).  Each slot gets its entry's u
//      and its offset within the entry (the entry's size before the step plus
//      its earlier lanes), and every slot's gr is -1 but an entry's, which
//      holds its round.  A bucket's first piece also writes the left probe's
//      records (below) for its groups;
//   4. probe_merge_kernel, a warp per bucket that crosses a tile edge (the warp
//      of the tile where it starts): each later piece's entries are looked up
//      among the first piece's groups, a lane an entry (the entries of 32
//      pieces numbered together), and their sizes added to the groups' totals;
//      only if a key was missing does a second pass, in order, append the keys
//      that no earlier piece has (records in place: a bucket's groups never
//      outnumber its slots) and give each piece's entries the bucket's round
//      numbers.  The number of rounds R, the most groups of any bucket, is an
//      atomicMax of the walk's and the merge's group counts, read on the card;
//   5. the rank of the entries, not of the slots: an entry's final base
//      is the rows of all earlier rounds, plus the rows of its round in
//      earlier buckets, plus the rows of its group in earlier pieces, i.e.
//      the exclusive sum of the entries' sizes in (round, slot) order.  A
//      stable counting sort by round, low 8-bit digit first:
//      probe_rank_kernel<false> counts a warp's 1,024 items per digit
//      (shared-memory counters), the counts are scanned over (digit, tile)
//      per batch row, and probe_rank_kernel<true> places each item (a
//      ballot a bit of the digit for a chunk of 32).  The last digit pass
//      counts the entries' rows instead of the entries (a lane's earlier
//      same-digit rows from a ballot a bit of the weight), and its
//      places are the entries' final bases (written over esize; a group's
//      first entry also writes its record's lo).  The passes before it
//      write the entries' slots in digit order (erow's scratch and perm's
//      valid region, both free by then).  The host launches the passes
//      that n_r could need; each reads R and exits at once when it is not
//      needed, so below 257 rounds (the cell has about 10) one pass runs,
//      over the valid slots only, with R digit bins;
//   6. probe_perm_kernel, a thread per valid slot: perm[its entry's base +
//      its offset] = its row;
//   7. probe_left_kernel, a thread per left row: reads st[bk] and
//      st[bk + 1], then one 16-byte record a group of its bucket (the rep's
//      right row, the group's size, its first final slot; the first record
//      also holds the bucket's group count) and one key, and writes counts
//      and lo from the record whose key equals its own.
// Scratch: (B, P + 1) starts; (row, bucket) pairs, 16-byte records and
// four int32 arrays a (B, n_r) slot (ten words a slot); (B, 256, n_r /
// 1,024) digit counts; the scans' chunk sums: O(B (n_l + n_r + P)), never
// rounds x P.
// Bound: reading r_bkt, rank, the valid right keys, l_bkt and the valid
// left keys, and writing perm, counts and lo.  What it spends above it,
// largest first at the full-size cell (PERF.md): the left probe's
// dependent loads (bucket start, record, key) beside its streamed rows;
// the walk's key gathers through the packed rows; the place and perm
// kernels' stores at random slots; the rank's stores of bases and lo at
// scattered entries.  Lookups are linear in a bucket's keys, so deep
// rounds at small n_bits stay quadratic, as the reference's rounds are.
#include "common.cuh"

#define WALK_TILE 512   // packed slots a warp walks, 16 steps of 32
#define PROBE_THREADS 256
#define PROBE_WARPS (PROBE_THREADS / 32)
#define RANK_TILE 1024  // items a warp counts and places per digit pass
#define RANK_DIGIT 8
#define RANK_BINS (1 << RANK_DIGIT)
#define PROBE_MAX_PASSES 4
// gr of an entry: its round; PROBE_FIRST when it is its group's first
// entry, and PROBE_FAR too when the merge appended it, so that its group's
// record is not at its own slot (rounds stay below n_r <= 2^29).
#define PROBE_FIRST (1 << 30)
#define PROBE_FAR (1 << 29)
#define PROBE_ROUND_MASK (PROBE_FAR - 1)

static __device__ __forceinline__ bool same_key(const int* a, const int* b,
                                                int w) {
  for (int c = 0; c < w; ++c)
    if (a[c] != b[c]) return false;
  return true;
}

// Digit passes that R rounds need (rounds 0 .. R - 1), at least one.
static __device__ __forceinline__ int rank_digits(int R) {
  const int m = (R > 1 ? R : 1) - 1;
  int nd = 1;
  while (nd < PROBE_MAX_PASSES && (m >> (RANK_DIGIT * nd)) != 0) ++nd;
  return nd;
}

// Digit bins pass `pass` can see: none past the last needed pass, the
// top digit's values in the last, all of them before it.
static __device__ __forceinline__ int rank_bins(int R, int pass) {
  const int nd = rank_digits(R);
  if (pass >= nd) return 0;
  if (pass < nd - 1) return RANK_BINS;
  return (((R > 1 ? R : 1) - 1) >> (RANK_DIGIT * pass)) + 1;
}

// In-place exclusive scans of long rows (starts; the digit counts), a
// block per SCAN_CHUNK items of a row rather than a block per row: each
// chunk's sum, the sums scanned per row, then each chunk scanned from its
// base.  With rmax, only a row's first rank_bins(*rmax, pass) * n_tiles
// items are live: the counts of the digits that pass can see.
#define SCAN_CHUNK 4096
#define SCAN_THREADS 1024   // 4 items a thread

static __device__ __forceinline__ long long live_len(long long len,
                                                     const int* rmax,
                                                     int pass, int n_tiles) {
  if (rmax == nullptr) return len;
  const long long l = (long long)rank_bins(*rmax, pass) * n_tiles;
  return l < len ? l : len;
}

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
chunk_sum_kernel(const int* data, long long len, int n_chunks, int* sums,
                 const int* rmax, int pass, int n_tiles) {
  __shared__ int warp_sums[32];
  const int* p = data + blockIdx.y * len;
  const long long c0 = (long long)blockIdx.x * SCAN_CHUNK;
  const long long live = live_len(len, rmax, pass, n_tiles);
  int* out = sums + (long long)blockIdx.y * n_chunks + blockIdx.x;
  if (c0 >= live) {
    if (threadIdx.x == 0) *out = 0;
    return;
  }
  int s = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long idx = c0 + 4LL * threadIdx.x + i;
    s += idx < live ? p[idx] : 0;
  }
  s = warp_inclusive_sum(s);
  if ((threadIdx.x & 31) == 31) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int t = warp_inclusive_sum(warp_sums[threadIdx.x]);
    if (threadIdx.x == 31) *out = t;
  }
}

static __global__ void __launch_bounds__(SCAN_THREADS)
chunk_scan_kernel(int* data, long long len, int n_chunks, const int* bases,
                  const int* rmax, int pass, int n_tiles) {
  __shared__ int warp_sums[32];
  int* p = data + blockIdx.y * len;
  const long long c0 = (long long)blockIdx.x * SCAN_CHUNK;
  const long long live = live_len(len, rmax, pass, n_tiles);
  if (c0 >= live) return;
  const int warp = threadIdx.x >> 5;
  int v[4], s = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long idx = c0 + 4LL * threadIdx.x + i;
    v[i] = idx < live ? p[idx] : 0;
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
    if (idx < live) p[idx] = run;
    run += v[i];
  }
}

// sums: rows * ceil(len / SCAN_CHUNK) ints; totals (may be null): each
// row's sum.
static cudaError_t scan_long_rows(int* data, int rows, long long len,
                                  int* sums, int* totals, const int* rmax,
                                  int pass, int n_tiles, cudaStream_t s) {
  const int n_chunks = (int)((len + SCAN_CHUNK - 1) / SCAN_CHUNK);
  const dim3 grid(n_chunks, rows);
  chunk_sum_kernel<<<grid, SCAN_THREADS, 0, s>>>(data, len, n_chunks, sums,
                                                 rmax, pass, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess ||
      (err = launch_scan_rows(sums, rows, n_chunks, 1, 1, totals, s)) !=
          cudaSuccess)
    return err;
  chunk_scan_kernel<<<grid, SCAN_THREADS, 0, s>>>(data, len, n_chunks, sums,
                                                  rmax, pass, n_tiles);
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

// 2. The packed slot of each right row: (row, bucket) for a valid row,
// perm for a sentinel row.
static __global__ void probe_place_kernel(const int* r_bkt, const int* rank,
                                          const int* st, int B, int n_r,
                                          int P, int2* pr, int* perm) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)B * n_r) return;
  const long long b = g / n_r;
  const int i = (int)(g - b * n_r);
  const int bk = r_bkt[g];
  if (bk < 0 || bk > P) return;
  const int q = st[b * (P + 1LL) + bk] + rank[g];
  if (q < 0 || q >= n_r) return;
  if (bk == P)
    perm[b * n_r + q] = i;
  else
    pr[b * n_r + q] = make_int2(i, bk);
}

// 3. A warp per tile of WALK_TILE packed slots of batch row blockIdx.y:
// each piece's entries (erow, esize at its first slot + u; the count at
// rec[first slot].w), each slot's entry and offset in it (loc), gr, and the
// records of a bucket's first piece.
static __global__ void __launch_bounds__(PROBE_THREADS)
probe_walk_kernel(const int* rk, int w, int n_r, int P, const int* st,
                  const int2* pr, int n_tiles, int* loc, int* erow,
                  int* esize, int* gr, int4* rec, int* rmax) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * PROBE_WARPS + (threadIdx.x >> 5);
  const long long row0 = (long long)blockIdx.y * n_r;
  const int* st_b = st + blockIdx.y * (P + 1LL);
  const int n_valid = st_b[P];
  const int q0 = t * WALK_TILE;
  if (t >= n_tiles || q0 >= n_valid) return;   // the whole warp
  const int q1 = min(q0 + WALK_TILE, n_valid);
  const int* rk_b = rk + row0 * w;
  const int2* pr_b = pr + row0;
  int* loc_b = loc + row0;
  int* erow_b = erow + row0;
  int* esize_b = esize + row0;
  int* gr_b = gr + row0;
  int4* rec_b = rec + row0;
  const unsigned lt = lanemask_lt();
  int open_b = -1, open_first = 0, open_n = 0;   // the piece still open
  int deepest = 0;
  // A step's loads are issued a step ahead (its packed pair two): its
  // pair, its bucket's start and its key's first two columns.
  auto pair_at = [&](int qq) {
    return qq < q1 ? pr_b[qq] : make_int2(0, -1);
  };
  int2 p_next = pair_at(q0 + 32 + lane);
  int2 p = pair_at(q0 + lane);
  int bs = p.y >= 0 ? st_b[p.y] : 0;
  int k0 = p.y >= 0 ? rk_b[(long long)p.x * w] : 0;
  int k1 = p.y >= 0 && w > 1 ? rk_b[(long long)p.x * w + 1] : 0;
  for (int c0 = q0; c0 < q1; c0 += 32) {
    const int2 p_after = pair_at(c0 + 64 + lane);
    const bool has_next = p_next.y >= 0;
    const int bs_next = has_next ? st_b[p_next.y] : 0;
    const int k0_next = has_next ? rk_b[(long long)p_next.x * w] : 0;
    const int k1_next =
        has_next && w > 1 ? rk_b[(long long)p_next.x * w + 1] : 0;
    const int q = c0 + lane;
    const bool act = q < q1;
    const int bk = p.y;
    const int* key = rk_b + (long long)p.x * w;
    const int bstart = bs;
    const int first = max(bstart, q0);
    const bool head = first == bstart;   // the bucket's first piece
    // A bucket's lanes are contiguous (packed order): its segment runs
    // from its first lane to the next bucket's first.
    const int prev_bk = __shfl_up_sync(REPRO_FULL_MASK, bk, 1);
    const unsigned heads =
        __ballot_sync(REPRO_FULL_MASK, lane == 0 || bk != prev_bk);
    const unsigned upto = lt | (1u << lane);
    const unsigned later = heads & ~upto;
    const unsigned seg = (later ? (1u << (__ffs(later) - 1)) - 1 : ~0u) &
                         ~((1u << (31 - __clz(heads & upto))) - 1);
    // The lanes of a key: one match on a hash of its columns, each lane
    // then held against its group's first lane; a hash collision takes a
    // match a column.
    unsigned kh = (unsigned)k0 * 0x9E3779B1u + (unsigned)k1 * 0x85EBCA77u;
    for (int c = 2; c < w; ++c)
      kh = kh * 0xC2B2AE3Du + (unsigned)(act ? key[c] : 0);
    unsigned same = seg & __match_any_sync(REPRO_FULL_MASK, kh);
    int leader = __ffs(same) - 1;
    {
      const int l0 = __shfl_sync(REPRO_FULL_MASK, k0, leader);
      const int l1 = __shfl_sync(REPRO_FULL_MASK, k1, leader);
      const int lrow = __shfl_sync(REPRO_FULL_MASK, p.x, leader);
      const bool ok = !act || (k0 == l0 && k1 == l1 &&
                               (w < 3 || same_key(key + 2, rk_b + (long long)
                                                  lrow * w + 2, w - 2)));
      if (!__all_sync(REPRO_FULL_MASK, ok)) {
        same = seg & __match_any_sync(REPRO_FULL_MASK, k0);
        same &= __match_any_sync(REPRO_FULL_MASK, k1);
        for (int c = 2; c < w; ++c)
          same &= __match_any_sync(REPRO_FULL_MASK, act ? key[c] : 0);
        leader = __ffs(same) - 1;
      }
    }
    const bool lead = act && lane == leader;
    const bool in_open = act && bk == open_b;
    int found = -1;
    if (lead && in_open) {
      for (int e = 0; e < open_n && found < 0; ++e)
        if (same_key(key, rk_b + (long long)erow_b[open_first + e] * w, w))
          found = e;
    }
    const unsigned fresh = __ballot_sync(REPRO_FULL_MASK, lead && found < 0);
    const int base = in_open ? open_n : 0;
    int r = found >= 0 ? found : base + __popc(fresh & seg & lt);
    int prev = 0;   // the entry's rows before this step
    if (lead) {
      const int at = first + r;
      const int n_same = __popc(same);
      if (found >= 0)
        prev = esize_b[at];
      else
        erow_b[at] = p.x;
      esize_b[at] = prev + n_same;
      if (head) {
        if (found < 0) rec_b[at].x = p.x;
        rec_b[at].y = prev + n_same;
      }
    }
    r = __shfl_sync(REPRO_FULL_MASK, r, leader);
    prev = __shfl_sync(REPRO_FULL_MASK, prev, leader);
    const int n_after = base + __popc(fresh & seg);
    const int next_bk = __shfl_down_sync(REPRO_FULL_MASK, bk, 1);
    if (act) {
      loc_b[q] = r | ((prev + __popc(same & lt)) << 16);
      gr_b[q] = -1;
    }
    __syncwarp();
    // A head piece's new key is its bucket's round r (first < q, so its
    // -1 above came first).
    if (lead && found < 0 && head) gr_b[first + r] = r | PROBE_FIRST;
    // The piece's last slot of this step ends it if its bucket or the tile
    // ends there.
    if (act && lane == 31 - __clz(seg) &&
        (q + 1 == q1 || (lane < 31 ? next_bk : pr_b[q + 1].y) != bk)) {
      rec_b[first].w = n_after;
      deepest = max(deepest, n_after);
    }
    const int last = 31 - __clz(__ballot_sync(REPRO_FULL_MASK, act));
    open_b = __shfl_sync(REPRO_FULL_MASK, bk, last);
    open_first = __shfl_sync(REPRO_FULL_MASK, first, last);
    open_n = __shfl_sync(REPRO_FULL_MASK, n_after, last);
    p = p_next;
    p_next = p_after;
    bs = bs_next;
    k0 = k0_next;
    k1 = k1_next;
    __syncwarp();
  }
  deepest = __reduce_max_sync(REPRO_FULL_MASK, deepest);
  if (lane == 0 && deepest > 0) atomicMax(rmax, deepest);
}

// 4. A warp per tile: the bucket that starts in the tile and crosses its
// end.  Its first piece's groups are the bucket's first ones; each later
// piece's entries get the bucket's round of their key (gr) and add their
// rows to its record; keys of no earlier piece are appended in order.
static __global__ void __launch_bounds__(PROBE_THREADS)
probe_merge_kernel(const int* rk, int w, int n_r, int P, const int* st,
                   const int2* pr, int n_tiles, const int* erow,
                   const int* esize, int* gr, int4* rec, int* rmax) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * PROBE_WARPS + (threadIdx.x >> 5);
  const long long row0 = (long long)blockIdx.y * n_r;
  const int* st_b = st + blockIdx.y * (P + 1LL);
  const int n_valid = st_b[P];
  const long long edge = (long long)(t + 1) * WALK_TILE;
  if (t >= n_tiles || edge >= n_valid) return;   // the whole warp
  const int2* pr_b = pr + row0;
  const int bk = pr_b[edge - 1].y;
  const int s = st_b[bk];
  if (pr_b[edge].y != bk || s < (long long)t * WALK_TILE) return;
  const int end = st_b[bk + 1];
  const int* rk_b = rk + row0 * w;
  const int* erow_b = erow + row0;
  const int* esize_b = esize + row0;
  int* gr_b = gr + row0;
  int4* rec_b = rec + row0;
  auto key_of = [&](int row) { return rk_b + (long long)row * w; };
  const int n0 = rec_b[s].w;
  bool pending = false;
  // 32 later pieces at a time (a lane reads one's count); their entries,
  // numbered across the pieces, 32 at a time (a lane looks one up).
  for (long long p0 = edge; p0 < end; p0 += 32LL * WALK_TILE) {
    const long long mine = p0 + (long long)lane * WALK_TILE;
    const int nk = mine < end ? rec_b[mine].w : 0;
    const int before = warp_inclusive_sum(nk) - nk;
    const int total = __shfl_sync(REPRO_FULL_MASK, before + nk, 31);
    for (int e0 = 0; e0 < total; e0 += 32) {
      const int e = e0 + lane;
      int piece = 0;   // the last piece whose entries start at or before e
      for (int j = 1; j < 32; ++j)
        if (e >= __shfl_sync(REPRO_FULL_MASK, before, j)) piece = j;
      const int u = e - __shfl_sync(REPRO_FULL_MASK, before, piece);
      if (e >= total) continue;
      const long long at = p0 + (long long)piece * WALK_TILE + u;
      const int* key = key_of(erow_b[at]);
      int found = -1;
      for (int g = 0; g < n0 && found < 0; ++g)
        if (same_key(key, key_of(erow_b[s + g]), w)) found = g;
      if (found >= 0) {
        atomicAdd(&rec_b[s + found].y, esize_b[at]);
        gr_b[at] = found;
      }
      pending |= found < 0;
    }
  }
  if (!__any_sync(REPRO_FULL_MASK, pending)) return;
  __syncwarp();
  // Keys of no earlier piece, in order: appended after the bucket's groups
  // so far.  Appends write records' x and y only, so each piece's count
  // (its first slot's w) survives them.
  const unsigned lt = lanemask_lt();
  int g = n0;
  for (long long first = edge; first < end; first += WALK_TILE) {
    const int nk = rec_b[first].w;
    for (int u0 = 0; u0 < nk; u0 += 32) {
      const int u = u0 + lane;
      const bool pend = u < nk && gr_b[first + u] < 0;
      int row = 0, size = 0, found = -1;
      if (pend) {
        row = erow_b[first + u];
        size = esize_b[first + u];
        const int* key = key_of(row);
        for (int e = n0; e < g && found < 0; ++e)
          if (same_key(key, key_of(rec_b[s + e].x), w)) found = e;
      }
      const unsigned fresh = __ballot_sync(REPRO_FULL_MASK, pend && found < 0);
      __syncwarp();
      if (pend && found >= 0) {
        rec_b[s + found].y += size;
        gr_b[first + u] = found;
      } else if (pend) {
        const int at = g + __popc(fresh & lt);
        rec_b[s + at].x = row;
        rec_b[s + at].y = size;
        gr_b[first + u] = at | PROBE_FIRST | PROBE_FAR;
      }
      g += __popc(fresh);
      __syncwarp();
    }
  }
  if (lane == 0) {
    rec_b[s].w = g;
    atomicMax(rmax, g);
  }
}

// 5. One digit pass of the entries' stable counting sort by round, a warp
// per RANK_TILE items of batch row blockIdx.y.  Items: the valid slots in
// pass 0 (an entry where gr >= 0), the previous pass's entry slots
// (pairs_in) after.  kRank false: each tile's items (the last pass: their
// rows) per digit to th[b, digit, tile].  kRank true, th scanned: each
// item's place; the last pass writes it over esize (and a group's first
// entry into its record's z), the others write the entry's slot there in
// pairs_out.  ctl: [0] R, [1 + b] batch row b's entries (pass 0's totals).
template <bool kRank>
static __global__ void __launch_bounds__(PROBE_THREADS)
probe_rank_kernel(int pass, int n_r, int P, int n_tiles, const int* st,
                  const int2* pr, const int* gr, int* esize, const int* ctl,
                  const int* pairs_in, int* th, int* pairs_out, int4* rec) {
  __shared__ int counters[PROBE_WARPS][RANK_BINS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x * PROBE_WARPS + warp;
  const int b = blockIdx.y;
  const int R = ctl[0];
  const int nd = rank_digits(R);
  if (pass >= nd || t >= n_tiles) return;   // whole warps
  const bool last_pass = pass == nd - 1;
  const int bins = rank_bins(R, pass);
  const long long row0 = (long long)b * n_r;
  const int* st_b = st + b * (P + 1LL);
  const int n_items = pass == 0 ? st_b[P] : ctl[1 + b];
  const int i0 = t * RANK_TILE;
  const int i1 = min(i0 + RANK_TILE, n_items);
  if (kRank && i0 >= n_items) return;
  int* cnt = counters[warp];
  int* col = th + (long long)b * RANK_BINS * n_tiles + t;  // th[b, d, t]
  for (int d = lane; d < bins; d += 32)
    cnt[d] = kRank ? col[(long long)d * n_tiles] : 0;
  __syncwarp();
  const int shift = RANK_DIGIT * pass;
  const int digit_bits = 32 - __clz(bins - 1);   // 0 for one bin
  const unsigned lt = lanemask_lt();
  // Each chunk's loads are issued while the chunk before it is counted or
  // placed.  An item's weight is its rows in the last pass, else 1.
  auto item = [&](int i, int& q, int& g, int& wgt) {
    q = i < i1 ? (pass == 0 ? i : pairs_in[row0 + i]) : -1;
    g = q >= 0 ? gr[row0 + q] : -1;
    wgt = last_pass && q >= 0 ? esize[row0 + q] : 1;
  };
  int q, g, wgt;
  item(i0 + lane, q, g, wgt);
  for (int c0 = i0; c0 < i1; c0 += 32) {
    int q_next, g_next, wgt_next;
    item(c0 + 32 + lane, q_next, g_next, wgt_next);
    const int r = g & PROBE_ROUND_MASK;
    const int d = g >= 0 ? (r >> shift) & (RANK_BINS - 1) : -1;
    if constexpr (kRank) {
      const unsigned items = __ballot_sync(REPRO_FULL_MASK, d >= 0);
      if (items) {
        // The lanes of each lane's digit, a ballot a bit of the digit; the
        // weights of the earlier lanes of the same digit (pre) and of all
        // of them (sum), a ballot a bit of the weight.
        unsigned same = items;
        for (int bit = 0; bit < digit_bits; ++bit) {
          const unsigned on = __ballot_sync(REPRO_FULL_MASK, (d >> bit) & 1);
          same &= (d >> bit) & 1 ? on : ~on;
        }
        int pre = __popc(same & lt), sum = __popc(same);
        if (last_pass) {
          const int most =
              __reduce_max_sync(REPRO_FULL_MASK, d >= 0 ? wgt : 0);
          pre = sum = 0;
          for (int bit = 0; (most >> bit) != 0; ++bit) {
            const unsigned has =
                __ballot_sync(REPRO_FULL_MASK, (wgt >> bit) & 1) & same;
            pre += __popc(has & lt) << bit;
            sum += __popc(has) << bit;
          }
        }
        const int base = d >= 0 ? cnt[d] : 0;
        __syncwarp();
        if (d >= 0) {
          const int pos = base + pre;
          if (last_pass) {
            esize[row0 + q] = pos;
            if (g & PROBE_FIRST)
              rec[row0 + ((g & PROBE_FAR) ? st_b[pr[row0 + q].y] + r : q)].z =
                  pos;
          } else {
            pairs_out[row0 + pos] = q;
          }
          if (lane == __ffs(same) - 1) cnt[d] = base + sum;
        }
        __syncwarp();
      }
    } else {
      if (d >= 0) atomicAdd(&cnt[d], wgt);
    }
    q = q_next;
    g = g_next;
    wgt = wgt_next;
  }
  if constexpr (!kRank) {
    __syncwarp();
    for (int d = lane; d < bins; d += 32) col[(long long)d * n_tiles] = cnt[d];
  }
}

// 6. A thread per slot: a valid slot's row goes to its entry's final base
// plus its offset in the entry.
static __global__ void probe_perm_kernel(int B, int n_r, int P,
                                         const int* st, const int2* pr,
                                         const int* loc, const int* esize,
                                         int* perm) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)B * n_r) return;
  const long long b = g / n_r;
  const int q = (int)(g - b * n_r);
  const int* st_b = st + b * (P + 1LL);
  if (q >= st_b[P]) return;
  const int2 p = pr[g];
  const int first = max(st_b[p.y], q & ~(WALK_TILE - 1));
  const int l = loc[g];
  perm[b * n_r + esize[b * n_r + first + (l & 0xffff)] + (l >> 16)] = p.x;
}

// 7. A thread per left row: the record of its bucket whose key is its key.
static __global__ void probe_left_kernel(const int* lk, const int* l_bkt,
                                         int B, int n_l, int w, const int* rk,
                                         int n_r, int P, const int* st,
                                         const int4* rec, int* counts,
                                         int* lo) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)B * n_l) return;
  const long long b = g / n_l;
  const int bk = max(l_bkt[g], 0);
  int c = 0, l = 0;
  if (bk < P) {
    // The key's first two columns are read beside the bucket's start, not
    // after it.
    const int* key = lk + g * w;
    const int k0 = key[0], k1 = w > 1 ? key[1] : 0;
    const int* st_b = st + b * (P + 1LL);
    const int s = st_b[bk];
    if (st_b[bk + 1] > s) {
      const long long row0 = b * n_r;
      const int4* r = rec + row0 + s;
      int4 x = r[0];
      const int n_groups = x.w;
      for (int e = 0;;) {
        const int* rep = rk + (row0 + x.x) * w;
        if (rep[0] == k0 && (w < 2 || (rep[1] == k1 &&
                                       same_key(key + 2, rep + 2, w - 2)))) {
          c = x.y;
          l = x.z;
          break;
        }
        if (++e >= n_groups) break;
        x = r[e];
      }
    }
  }
  counts[g] = c;
  lo[g] = l;
}

// hist: B rows hist_pitch ints apart; st: B * (P + 1); pr: B * n_r int2;
// rec: B * n_r int4; slots: 4 arrays of B * n_r (loc, erow, esize, gr);
// th: B * RANK_BINS * ceil(n_r / RANK_TILE); csum: B * ceil(max(P + 1,
// RANK_BINS * ceil(n_r / RANK_TILE)) / SCAN_CHUNK); ctl: 1 + B; passes:
// the digit passes n_r rounds could need (kernels/join_probe.py::
// probe_tables_cuda).
extern "C" int probe_tables_launch(const int* lk, const int* l_bkt, int B,
                                   int n_l, const int* rk, const int* r_bkt,
                                   const int* rank, const int* hist,
                                   long long hist_pitch, int n_r, int w,
                                   int n_bits, int passes, int* st, int* pr,
                                   int* rec, int* slots, int* th, int* csum,
                                   int* ctl, int* counts, int* lo, int* perm,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || n_r == 0) return 0;
  if (passes < 1 || passes > PROBE_MAX_PASSES || n_r > PROBE_FAR)
    return (int)cudaErrorInvalidValue;
  const int P = 1 << n_bits;
  const long long n = (long long)B * n_r;
  int* loc = slots;
  int* erow = slots + n;    // then the sort's scratch
  int* esize = slots + 2 * n;
  int* gr = slots + 3 * n;
  int2* pr2 = reinterpret_cast<int2*>(pr);
  int4* rec4 = reinterpret_cast<int4*>(rec);
  cudaError_t err = cudaMemsetAsync(ctl, 0, sizeof(int) * (1 + (size_t)B), s);
  if (err != cudaSuccess) return (int)err;
  probe_starts_kernel<<<blocks_for(B * (P + 1LL), PROBE_THREADS),
                        PROBE_THREADS, 0, s>>>(hist, hist_pitch, B, P, st);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = scan_long_rows(st, B, P + 1LL, csum, nullptr, nullptr, 0, 0,
                            s)) != cudaSuccess)
    return (int)err;
  probe_place_kernel<<<blocks_for(n, PROBE_THREADS), PROBE_THREADS, 0, s>>>(
      r_bkt, rank, st, B, n_r, P, pr2, perm);
  const int walk_tiles = (n_r + WALK_TILE - 1) / WALK_TILE;
  const dim3 walk_grid(blocks_for(walk_tiles, PROBE_WARPS), B);
  probe_walk_kernel<<<walk_grid, PROBE_THREADS, 0, s>>>(
      rk, w, n_r, P, st, pr2, walk_tiles, loc, erow, esize, gr, rec4, ctl);
  probe_merge_kernel<<<walk_grid, PROBE_THREADS, 0, s>>>(
      rk, w, n_r, P, st, pr2, walk_tiles, erow, esize, gr, rec4, ctl);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int rank_tiles = (n_r + RANK_TILE - 1) / RANK_TILE;
  const dim3 rank_grid(blocks_for(rank_tiles, PROBE_WARPS), B);
  const long long th_len = (long long)RANK_BINS * rank_tiles;
  // The passes before the last write the sorted entries' slots to erow's
  // scratch (even passes) and to perm's valid region (odd passes; the
  // sentinel's slots of perm are set already).
  for (int pass = 0; pass < passes; ++pass) {
    const int* in = pass == 0 ? nullptr : ((pass - 1) % 2 == 0 ? erow : perm);
    int* out = pass % 2 == 0 ? erow : perm;
    probe_rank_kernel<false><<<rank_grid, PROBE_THREADS, 0, s>>>(
        pass, n_r, P, rank_tiles, st, pr2, gr, esize, ctl, in, th, out, rec4);
    if ((err = cudaGetLastError()) != cudaSuccess ||
        (err = scan_long_rows(th, B, th_len, csum,
                              pass == 0 ? ctl + 1 : nullptr, ctl, pass,
                              rank_tiles, s)) != cudaSuccess)
      return (int)err;
    probe_rank_kernel<true><<<rank_grid, PROBE_THREADS, 0, s>>>(
        pass, n_r, P, rank_tiles, st, pr2, gr, esize, ctl, in, th, out, rec4);
  }
  probe_perm_kernel<<<blocks_for(n, PROBE_THREADS), PROBE_THREADS, 0, s>>>(
      B, n_r, P, st, pr2, loc, esize, perm);
  if (n_l > 0)
    probe_left_kernel<<<blocks_for((long long)B * n_l, PROBE_THREADS),
                        PROBE_THREADS, 0, s>>>(lk, l_bkt, B, n_l, w, rk, n_r,
                                               P, st, rec4, counts, lo);
  return (int)cudaGetLastError();
}
