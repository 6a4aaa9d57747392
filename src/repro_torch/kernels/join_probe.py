"""Reduce-phase radix hash join: `join_hash`, `build_table`, `probe_tables`.

Each cascade step of the local join hashes the left (accumulator) side with
`join_hash`, builds the right side's table with `build_table` (bucket,
stable arrival rank within the bucket, histogram) and resolves matches with
`probe_tables` — key-verified chained probing that yields per-left-row
(counts, lo) and a grouped right permutation `perm`, every exact-key group
contiguous and in arrival order.  All functions take a leading batch axis:
one slice per destination device.

Hash: h = (Σ_c key_c · seed_c) · MULT over uint32, seed_c =
(0x9E3779B1 + 2c·0x85EBCA77) | 1, bucket = the top n_bits bits; invalid rows
land in the sentinel bucket P = 2^n_bits.

`join_hash_host` / `build_table_host` / `probe_tables_host` are the plain
versions (int64 masked arithmetic, one stable sort for the rank, the
reference's chained rounds as torch ops); `*_cuda` launch
csrc/join_probe.cu and csrc/probe_tables.cu.  The CUDA build ranks the
buckets digit by digit, low digit first (digits of at most MAX_DIGIT_BITS
bits, counters in shared memory, tiles of RANK_TILE_ROWS rows), so its
scratch grows with B·n and not with the table size; it takes 1 ≤ n_bits ≤
MAX_BUILD_BITS.  The CUDA probe numbers each bucket's keys in one walk of
the packed table and orders the groups, not the slots, by a stable
counting sort of their rounds, with no host sync; the reference leaves the
probe to XLA.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import MASK32, MULT, u32
from .map_pack import stable_rank

MAX_BITS = 16             # default table-size cap (2^16 buckets)
_SEED0 = 0x9E3779B1
_SEED_STEP = 0x85EBCA77
# The CUDA build: rows a block ranks (csrc/join_probe.cu's DIGIT_TILE;
# 2,048 blocks at 8 x 2^20 rows), the widest digit (2^10 + 1 counters a
# warp in shared memory) and the widest table (three digits; P + 1 stays
# an int32).
RANK_TILE_ROWS = 4096
MAX_DIGIT_BITS = 10
MAX_BUILD_BITS = 30
# The CUDA probe (csrc/probe_tables.cu): items a block scans in its scans
# of long rows (SCAN_CHUNK), the rank's digits (RANK_DIGIT_BITS bits, at
# most PROBE_MAX_PASSES of them) and the items a warp ranks per digit
# pass (RANK_TILE); the most right rows a batch row it takes.
SCAN_CHUNK = 4096
RANK_DIGIT_BITS = 8
RANK_BINS = 1 << RANK_DIGIT_BITS
RANK_TILE_SLOTS = 1024
PROBE_MAX_PASSES = 4
MAX_PROBE_ROWS = 1 << 29


def col_seeds(w: int) -> tuple[int, ...]:
    """Odd multiply-shift seed per key column."""
    return tuple(((_SEED0 + 2 * c * _SEED_STEP) | 1) & MASK32
                 for c in range(w))


def default_bits(n_r: int) -> int:
    """Default table size: ~2·n_r buckets, capped at 2^MAX_BITS."""
    return max(1, min(MAX_BITS, (max(n_r, 2) - 1).bit_length() + 1))


def _hash_block(keys: torch.Tensor, n_bits: int) -> torch.Tensor:
    """(..., n) int32 bucket in [0, 2^n_bits) of keys (..., n, w)."""
    h = torch.zeros(keys.shape[:-1], dtype=torch.int64, device=keys.device)
    for c, seed in enumerate(col_seeds(keys.shape[-1])):
        h = (h + u32(keys[..., c]) * seed) & MASK32
    h = (h * MULT) & MASK32
    return (h >> (32 - n_bits)).to(torch.int32)


def join_hash_host(keys: torch.Tensor, valid: torch.Tensor, n_bits: int
                   ) -> torch.Tensor:
    """Plain version of `join_hash`: keys (B, n, w), valid (B, n) -> (B, n)."""
    return torch.where(valid.bool(), _hash_block(keys, n_bits), 1 << n_bits)


def build_table_host(keys: torch.Tensor, valid: torch.Tensor, n_bits: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of `build_table`: (bucket (B, n), rank (B, n),
    hist (B, P)); the rank from one stable sort over (batch, bucket)."""
    b, n = keys.shape[:2]
    p = 1 << n_bits
    d = join_hash_host(keys, valid, n_bits)
    batch = torch.arange(b, device=keys.device)[:, None]
    rank, hist = stable_rank((batch * (p + 1) + d).reshape(-1), b * (p + 1))
    return (d, rank.reshape(b, n).to(torch.int32),
            hist.reshape(b, p + 1)[:, :p].to(torch.int32))


def join_hash_cuda(keys: torch.Tensor, valid: torch.Tensor, n_bits: int
                   ) -> torch.Tensor:
    """Launch csrc/join_probe.cu's hash: one thread per row."""
    keys = _build.as_i32(keys, "keys")
    valid = _build.as_bool(valid, "valid")
    b, n, w = keys.shape
    out = torch.empty((b, n), dtype=torch.int32, device=keys.device)
    if b * n == 0:
        return out
    _build.call("join_hash_launch", keys.data_ptr(), valid.data_ptr(), b * n,
                w, n_bits, out.data_ptr(), _build.stream(keys))
    return out


def build_digits(n_bits: int) -> tuple[int, int]:
    """(digit passes, bits of every digit but the top one) of the CUDA
    build: as few passes of at most MAX_DIGIT_BITS bits as cover n_bits,
    split evenly.  Raises `KernelError` outside 1..MAX_BUILD_BITS."""
    if not 1 <= n_bits <= MAX_BUILD_BITS:
        raise _build.KernelError(
            f"build_table: n_bits {n_bits} outside the CUDA build's range "
            f"1..{MAX_BUILD_BITS}")
    passes = -(-n_bits // MAX_DIGIT_BITS)
    return passes, -(-n_bits // passes)


def build_table_cuda(keys: torch.Tensor, valid: torch.Tensor, n_bits: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch csrc/join_probe.cu's build: per digit pass, a block counts
    its tile's digits in shared memory, scans run over tiles and digits,
    and the block ranks its tile (one digit) or writes its (bucket, row)
    pairs in stable digit order; the last of two or more digits sorts each
    tile by bucket in shared memory and writes ranks and histogram, with a
    carry over tiles for buckets that began in earlier tiles.  Scratch:
    (B, 2^digit + 1, tiles) counts and two (B, n) buffers a digit but the
    last (at most four)."""
    passes, digit_bits = build_digits(n_bits)
    keys = _build.as_i32(keys, "keys")
    valid = _build.as_bool(valid, "valid")
    b, n, w = keys.shape
    p = 1 << n_bits
    dev = keys.device
    if b * n == 0:
        z = torch.empty((b, n), dtype=torch.int32, device=dev)
        return z, z.clone(), torch.zeros((b, p), dtype=torch.int32, device=dev)
    if n > (1 << 31) - RANK_TILE_ROWS:
        raise _build.KernelError(f"build_table: {n} rows a batch, past int32")
    n_tiles = -(-n // RANK_TILE_ROWS)
    nb = (1 << digit_bits) + 1              # the most bins a digit has
    th = torch.empty(b * nb * n_tiles, dtype=torch.int32, device=dev)
    tot = torch.empty(b * nb, dtype=torch.int32, device=dev)
    # (key, row) pairs after every digit but the last: none for one digit,
    # one pair for two digits, a ping-pong pair of them for three.
    n_pairs = 2 * min(passes - 1, 2)
    pairs = torch.empty((n_pairs, b, n), dtype=torch.int32, device=dev)
    pair_ptrs = [x.data_ptr() for x in pairs] + [0] * (4 - n_pairs)
    bkt = torch.empty((b, n), dtype=torch.int32, device=dev)
    rank = torch.empty((b, n), dtype=torch.int32, device=dev)
    tab = torch.empty((b, p + 1), dtype=torch.int32, device=dev)
    _build.call("build_table_launch", keys.data_ptr(), valid.data_ptr(), b, n,
                w, n_bits, digit_bits, n_tiles, th.data_ptr(),
                tot.data_ptr(), *pair_ptrs,
                bkt.data_ptr(), rank.data_ptr(), tab.data_ptr(),
                _build.stream(keys))
    return bkt, rank, tab[:, :p]


# ---------------------------------------------------------------------------
# Chained probe (torch ops; batched over the leading axis)
# ---------------------------------------------------------------------------

def _rows_at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, n, w) gathered at row indices idx (B, m) -> (B, m, w)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def _chain_probe(lk: torch.Tensor, rk: torch.Tensor, perm1: torch.Tensor,
                 rstart: torch.Tensor, rend: torch.Tensor, s_l: torch.Tensor,
                 l_miss: torch.Tensor, fpos0: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Key-verified chained resolution over a bucketed packed table.

    `perm1` maps packed position -> right row (buckets contiguous, arrival
    order inside, invalid rows last); `rstart`/`rend` are each packed row's
    bucket range; `s_l` each left row's bucket start (junk where `l_miss`);
    `fpos0` pre-assigns final slots to invalid packed rows (-1 elsewhere).
    Each round, every bucket's first unresolved row is its representative:
    right rows with equal keys resolve into one contiguous group of final
    slots and probing left rows with equal keys take that group's
    (start, size).  Rounds run until the right side is resolved; a batch
    already resolved passes through a round unchanged.
    Returns (counts (B, n_l), lo (B, n_l), perm (B, n_r)) int32."""
    b, n_l = lk.shape[:2]
    n_r = rk.shape[1]
    dev = lk.device
    pk = _rows_at(rk, perm1)                                # packed keys
    s_l = torch.clamp(s_l, 0, n_r - 1)
    lmask = ~l_miss
    rend_l = torch.gather(rend, 1, s_l)
    cnt = torch.zeros((b, n_l), dtype=torch.int64, device=dev)
    lo = torch.zeros((b, n_l), dtype=torch.int64, device=dev)
    fpos = fpos0
    total = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    while bool((fpos < 0).any()):
        unres = fpos < 0
        cu = torch.cumsum(unres.long(), 1)                  # inclusive
        base_u = torch.where(rstart > 0, torch.gather(
            cu, 1, torch.clamp(rstart - 1, 0, n_r - 1)), zero)
        pos = torch.searchsorted(cu, base_u + 1)
        rep = torch.where(pos < rend, pos, n_r)
        mask = unres & (pk == _rows_at(pk, torch.clamp(rep, 0, n_r - 1))
                        ).all(-1)
        rep_l = torch.gather(rep, 1, s_l)
        hit = lmask & (rep_l < n_r) & (
            lk == _rows_at(pk, torch.clamp(rep_l, 0, n_r - 1))).all(-1)
        pcm = torch.cumsum(mask.long(), 1)                  # inclusive
        base_l = torch.where(s_l > 0, torch.gather(
            pcm, 1, torch.clamp(s_l - 1, 0, n_r - 1)), zero)
        reach_l = torch.gather(pcm, 1, torch.clamp(rend_l - 1, 0, n_r - 1))
        fpos = torch.where(mask, total + pcm - 1, fpos)
        cnt = torch.where(hit, reach_l - base_l, cnt)
        lo = torch.where(hit, total + base_l, lo)
        total = total + pcm[:, -1:]
    perm = torch.zeros((b, n_r), dtype=torch.int64, device=dev).scatter_(
        1, fpos, perm1)
    return (cnt.to(torch.int32), lo.to(torch.int32), perm.to(torch.int32))


def probe_tables_host(lk: torch.Tensor, l_bkt: torch.Tensor,
                      rk: torch.Tensor, r_bkt: torch.Tensor,
                      rank: torch.Tensor, hist: torch.Tensor, n_bits: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of `probe_tables`, the chained build+probe from
    `join_hash` (left) and `build_table` (right) outputs: lays the right
    side out as the compact per-bucket table (starts[bucket] + rank,
    sentinel bucket last) and runs `_chain_probe` with buckets as the
    partitions."""
    b, n_l = lk.shape[:2]
    n_r = rk.shape[1]
    p = 1 << n_bits
    dev = lk.device
    if n_r == 0:
        z = torch.zeros((b, n_l), dtype=torch.int32, device=dev)
        return z, z.clone(), torch.zeros((b, 0), dtype=torch.int32,
                                         device=dev)
    hist = hist.long()
    hist_full = torch.cat([hist, n_r - hist.sum(1, keepdim=True)], 1)
    starts = torch.cat([torch.zeros((b, 1), dtype=torch.int64, device=dev),
                        torch.cumsum(hist_full, 1)], 1)      # (B, P + 2)
    q = torch.gather(starts, 1, r_bkt.long()) + rank.long()  # packed position
    qidx = torch.arange(n_r, device=dev).expand(b, n_r).contiguous()
    perm1 = torch.zeros((b, n_r), dtype=torch.int64, device=dev).scatter_(
        1, q, qidx)
    pb = torch.searchsorted(starts[:, 1:].contiguous(), qidx, right=True)
    rstart = torch.gather(starts, 1, pb)
    rend = torch.gather(starts, 1, pb + 1)
    fpos0 = torch.where(qidx >= starts[:, p:p + 1], qidx, -1)
    l_bkt = l_bkt.long()
    l_safe = torch.clamp(l_bkt, 0, p)
    l_miss = (l_bkt >= p) | (torch.gather(hist_full, 1, l_safe) == 0)
    return _chain_probe(lk, rk, perm1, rstart, rend,
                        torch.gather(starts, 1, l_safe), l_miss, fpos0)


def probe_passes(n_r: int) -> int:
    """Digit passes of the CUDA probe's rank of the groups by round: as
    many RANK_DIGIT_BITS-bit digits as rounds 0 .. n_r - 1 need (a bucket
    has no more keys than rows).  The kernels read the real number of
    rounds on the card and skip the passes it does not need.  Raises
    `KernelError` past MAX_PROBE_ROWS rows a batch row."""
    if n_r > MAX_PROBE_ROWS:
        raise _build.KernelError(
            f"probe_tables: {n_r} right rows a batch, past {MAX_PROBE_ROWS}")
    return max(1, -(-max(n_r - 1, 1).bit_length() // RANK_DIGIT_BITS))


def probe_tables_cuda(lk: torch.Tensor, l_bkt: torch.Tensor,
                      rk: torch.Tensor, r_bkt: torch.Tensor,
                      rank: torch.Tensor, hist: torch.Tensor, n_bits: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch csrc/probe_tables.cu: (counts (B, n_l), lo (B, n_l), perm
    (B, n_r)) int32, equal to `probe_tables_host`'s.  A walk of the packed
    table numbers each bucket's keys and keeps each tile's piece of a
    bucket as entries (a key's rows in the piece); a stable counting sort
    of the entries by round, whose last digit pass sums their rows, gives
    every entry its final base; the left probe reads one 16-byte record a
    group.  What holds it above its bound: stores at random slots (place,
    perm), the walk's key gathers and the left probe's dependent loads.
    Scratch: the (B, P + 1) starts; per (B, n_r) slot a (row, bucket) pair,
    a 16-byte record and four int32 words; the (B, 256, n_r / 1,024) digit
    counts; a sum per SCAN_CHUNK items of the longer scanned row.  Raises
    `KernelError` outside 1 ≤ n_bits ≤ MAX_BUILD_BITS or past
    MAX_PROBE_ROWS right rows."""
    lk, rk = _build.as_i32(lk, "lk"), _build.as_i32(rk, "rk")
    l_bkt, r_bkt = _build.as_i32(l_bkt, "l_bkt"), _build.as_i32(r_bkt, "r_bkt")
    rank = _build.as_i32(rank, "rank")
    # build_table's hist, a view of its (B, P + 1) table, is read in place.
    if not (hist.device.type == "cuda" and hist.dtype == torch.int32
            and hist.dim() == 2 and hist.stride(1) == 1):
        hist = _build.as_i32(hist, "hist")
    if not 1 <= n_bits <= MAX_BUILD_BITS:
        raise _build.KernelError(
            f"probe_tables: n_bits {n_bits} outside 1..{MAX_BUILD_BITS}")
    b, n_l, w = lk.shape
    n_r = rk.shape[1]
    p = 1 << n_bits
    if (rk.shape != (b, n_r, w) or l_bkt.shape != (b, n_l)
            or r_bkt.shape != (b, n_r) or rank.shape != (b, n_r)
            or hist.shape != (b, p) or w < 1):
        raise ValueError(
            f"probe_tables: shapes lk {tuple(lk.shape)}, l_bkt "
            f"{tuple(l_bkt.shape)}, rk {tuple(rk.shape)}, r_bkt "
            f"{tuple(r_bkt.shape)}, rank {tuple(rank.shape)}, hist "
            f"{tuple(hist.shape)} do not fit n_bits {n_bits}")
    dev = lk.device
    if b * n_r == 0:
        z = torch.zeros((b, n_l), dtype=torch.int32, device=dev)
        return z, z.clone(), torch.zeros((b, n_r), dtype=torch.int32,
                                         device=dev)
    passes = probe_passes(n_r)
    th_len = RANK_BINS * -(-n_r // RANK_TILE_SLOTS)
    i32 = dict(dtype=torch.int32, device=dev)
    st = torch.empty((b, p + 1), **i32)
    pr = torch.empty((b, n_r, 2), **i32)
    rec = torch.empty((b, n_r, 4), **i32)
    slots = torch.empty((4, b, n_r), **i32)
    th = torch.empty((b, th_len), **i32)
    csum = torch.empty(b * -(-max(p + 1, th_len) // SCAN_CHUNK), **i32)
    ctl = torch.empty(1 + b, **i32)
    counts = torch.empty((b, n_l), **i32)
    lo = torch.empty((b, n_l), **i32)
    perm = torch.empty((b, n_r), **i32)
    _build.call("probe_tables_launch", lk.data_ptr(), l_bkt.data_ptr(), b,
                n_l, rk.data_ptr(), r_bkt.data_ptr(), rank.data_ptr(),
                hist.data_ptr(), hist.stride(0), n_r, w, n_bits, passes,
                st.data_ptr(), pr.data_ptr(), rec.data_ptr(), slots.data_ptr(),
                th.data_ptr(), csum.data_ptr(), ctl.data_ptr(),
                counts.data_ptr(), lo.data_ptr(), perm.data_ptr(),
                _build.stream(lk))
    return counts, lo, perm
