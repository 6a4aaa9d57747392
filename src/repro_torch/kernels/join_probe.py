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

`join_hash_host` / `build_table_host` are the plain versions (int64 masked
arithmetic, one stable sort for the rank); `*_cuda` launch
csrc/join_probe.cu.  `probe_tables` / `_chain_probe` are torch ops on every
device, as the reference leaves them to XLA.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import MASK32, MULT, u32
from .map_pack import stable_rank

MAX_BITS = 16             # default table-size cap (2^16 buckets)
_SEED0 = 0x9E3779B1
_SEED_STEP = 0x85EBCA77
# build_table keeps per-tile bucket histograms in device memory: at most
# this many int32 words, and tiles of at least BUILD_TILE_ROWS rows.
TILE_HIST_WORDS = 1 << 26
BUILD_TILE_ROWS = 1024


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


def build_tiles(b: int, n: int, n_bits: int) -> tuple[int, int]:
    """(tile_rows, n_tiles) of the build's per-tile histograms: tiles of at
    least BUILD_TILE_ROWS rows, (B, P+1, n_tiles) within TILE_HIST_WORDS."""
    if n == 0:
        return 1, 1
    max_tiles = max(1, TILE_HIST_WORDS // (max(b, 1) * ((1 << n_bits) + 1)))
    n_tiles = max(1, min(-(-n // BUILD_TILE_ROWS), max_tiles))
    tile_rows = -(-n // n_tiles)
    return tile_rows, -(-n // tile_rows)


def build_table_cuda(keys: torch.Tensor, valid: torch.Tensor, n_bits: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch csrc/join_probe.cu's build (tile counts, scan, tile ranks)."""
    keys = _build.as_i32(keys, "keys")
    valid = _build.as_bool(valid, "valid")
    b, n, w = keys.shape
    p = 1 << n_bits
    dev = keys.device
    if b * n == 0:
        z = torch.empty((b, n), dtype=torch.int32, device=dev)
        return z, z.clone(), torch.zeros((b, p), dtype=torch.int32, device=dev)
    tile_rows, n_tiles = build_tiles(b, n, n_bits)
    th = torch.empty((b, p + 1, n_tiles), dtype=torch.int32, device=dev)
    bkt = torch.empty((b, n), dtype=torch.int32, device=dev)
    rank = torch.empty((b, n), dtype=torch.int32, device=dev)
    hist = torch.empty((b, p), dtype=torch.int32, device=dev)
    _build.call("build_table_launch", keys.data_ptr(), valid.data_ptr(), b, n,
                w, n_bits, tile_rows, n_tiles, th.data_ptr(), bkt.data_ptr(),
                rank.data_ptr(), hist.data_ptr(), _build.stream(keys))
    return bkt, rank, hist


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


def probe_tables(lk: torch.Tensor, l_bkt: torch.Tensor, rk: torch.Tensor,
                 r_bkt: torch.Tensor, rank: torch.Tensor, hist: torch.Tensor,
                 n_bits: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chained build+probe from `join_hash` (left) and `build_table` (right)
    outputs: lays the right side out as the compact per-bucket table
    (starts[bucket] + rank, sentinel bucket last) and runs `_chain_probe`
    with buckets as the partitions."""
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
