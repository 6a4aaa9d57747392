"""Plain torch oracles of the ported kernels (and their helpers).

Each `<name>_ref` is a dead-simple statement of what a kernel computes, for
one device (no batch axis): one-hot cumsums, plain gathers, no blocking.
They are O(n·bins) on purpose and serve the tests only; the plain versions
that run at full size are the `*_host` functions beside each wrapper.

uint32 arithmetic: torch's int32 shifts are arithmetic and its uint32
support is thin, so hashes are computed in int64 and masked to 32 bits
before every shift (a wrapped int64 product keeps the right low 32 bits).
"""
from __future__ import annotations

import torch

# Knuth's multiplicative constant — must match core.hypercube._MULT.
MULT = 2654435769
MASK32 = 0xFFFFFFFF
INVALID = -1


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 values reinterpreted as uint32, held in int64."""
    return x.to(torch.int64) & MASK32


def int32_bits(keys: torch.Tensor) -> torch.Tensor:
    """Integer keys as int32 holding the bits of their uint32 cast (int16
    sign-extends, int64 keeps its low 32 bits); other dtypes raise."""
    if keys.dtype == torch.int32:
        return keys
    if keys.dtype.is_floating_point or keys.dtype.is_complex \
            or keys.dtype == torch.bool:
        raise TypeError(f"expected integer keys, got {keys.dtype}")
    return (keys.to(torch.int64) & MASK32).to(torch.int32)


def mulshift(v: torch.Tensor, seed: int, bits: int) -> torch.Tensor:
    """Top `bits` bits of (v · seed · MULT) over uint32, as int32 (bits ≥ 1)."""
    h = (u32(v) * seed) & MASK32
    h = (h * MULT) & MASK32
    return (h >> (32 - bits)).to(torch.int32)


def hash_partition_ref(keys: torch.Tensor, seed: int, nbuckets: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Multiply-shift hash to power-of-two buckets + bucket histogram:
    h(v) = top log2(nbuckets) bits of (v · seed · MULT) over uint32
    (integer keys cast to uint32).  (ids (n,), histogram (nbuckets,))."""
    assert nbuckets & (nbuckets - 1) == 0, "nbuckets must be a power of two"
    if nbuckets == 1:
        ids = torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    else:
        ids = mulshift(keys, seed & MASK32, nbuckets.bit_length() - 1)
    hist = torch.zeros(nbuckets, dtype=torch.int64, device=keys.device)
    hist.index_add_(0, ids.reshape(-1).long(),
                    torch.ones(ids.numel(), dtype=torch.int64,
                               device=keys.device))
    return ids, hist.to(torch.int32)


def segment_histogram_ref(values: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Frequency histogram of int values in [0, n_bins) (int32 (n_bins,)).

    The heavy-hitter counting pass: values outside the range are dropped.
    """
    valid = (values >= 0) & (values < n_bins)
    clipped = values.clamp(0, n_bins - 1).long()
    hist = torch.zeros(n_bins, dtype=torch.int32, device=values.device)
    return hist.index_add_(0, clipped.reshape(-1),
                           valid.reshape(-1).to(torch.int32))


def match_counts_ref(probe: torch.Tensor, build: torch.Tensor
                     ) -> torch.Tensor:
    """counts[i] = |{j : probe[i] == build[j]}| (int32 (n_probe,))."""
    return (probe[:, None] == build[None, :]).sum(1).to(torch.int32)


def first_match_ref(probe: torch.Tensor, build: torch.Tensor
                    ) -> torch.Tensor:
    """Index of the first matching build row per probe, or -1 (int32)."""
    eq = probe[:, None] == build[None, :]
    col = torch.arange(build.shape[0], device=probe.device)[None, :]
    m = torch.where(eq, col, 2**31 - 1).min(1).values
    return torch.where(m == 2**31 - 1, -1, m).to(torch.int32)


def route_cells_ref(rows: torch.Tensor, recipe) -> torch.Tensor:
    """Hypercube cell Σ_i h_i(row[col_i]) · stride_i (share-1 axes skipped)."""
    cell = torch.zeros(rows.shape[:-1], dtype=torch.int32, device=rows.device)
    for col, seed, share, stride in recipe:
        if share == 1:
            continue
        cell = cell + mulshift(rows[..., col], seed,
                               share.bit_length() - 1) * stride
    return cell


def _map_route_ref(rows: torch.Tensor, routes, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(logical (n, F), wrapped (n, F)) per copy; -1 on non-members."""
    logical_cols, wrapped_cols = [], []
    neg = torch.tensor(INVALID, dtype=torch.int32, device=rows.device)
    for hashed, reps, offset, eqs, notins in routes:
        member = rows[:, 0] != INVALID
        for col, val in eqs:
            member = member & (rows[:, col] == val)
        for col, vals in notins:
            hh = torch.tensor(vals, dtype=rows.dtype, device=rows.device)
            member = member & ~(rows[:, col][:, None] == hh[None, :]).any(1)
        base = route_cells_ref(rows, hashed)
        for r in reps:
            logical = base + (r + offset)
            logical_cols.append(torch.where(member, logical, neg))
            wrapped_cols.append(torch.where(member, logical % k, neg))
    return torch.stack(logical_cols, 1), torch.stack(wrapped_cols, 1)


def fold_cells_ref(dest: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Physical device per wrapped logical cell; -1 passes through.  A dest
    past the table reads its last entry (the reference's clamped gather)."""
    valid = dest >= 0
    safe = torch.clamp(dest.long(), 0, table.shape[0] - 1)
    return torch.where(valid, table[safe], torch.full_like(dest, INVALID))


def bucket_rank_ref(dest: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rank, hist) by one-hot cumsum; out-of-range dests rank in bucket k."""
    m = dest.shape[0]
    d = torch.where((dest >= 0) & (dest < k), dest.long(),
                    torch.full_like(dest, k).long())
    if m == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dest.device),
                torch.zeros(k, dtype=torch.int32, device=dest.device))
    onehot = d[:, None] == torch.arange(k + 1, device=dest.device)[None, :]
    pos = torch.cumsum(onehot.long(), 0) - 1
    rank = torch.gather(pos, 1, d[:, None])[:, 0]
    return rank.to(torch.int32), (pos[-1, :k] + 1).to(torch.int32)


def bucket_pack_ref(dest: torch.Tensor, rows: torch.Tensor, k: int, cap: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable counting-sort pack into (k, cap, w) + dropped-row count."""
    m, w = rows.shape
    rank, hist = bucket_rank_ref(dest, k)
    overflow = torch.clamp(hist - cap, min=0).sum().to(torch.int32)
    buf = torch.full((k, cap, w), INVALID, dtype=rows.dtype,
                     device=rows.device)
    keep = (dest >= 0) & (dest < k) & (rank < cap)
    buf[dest[keep].long(), rank[keep].long()] = rows[keep]
    return buf, overflow


def segment_scan_ref(keys: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(seg_ids, run_start) over lexicographically sorted keys (n, w): the
    dense rank of each row's run and the index of the run's first row."""
    n = keys.shape[0]
    if n == 0:
        z = torch.zeros(0, dtype=torch.int32, device=keys.device)
        return z, z.clone()
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    flags = torch.cat([torch.ones(1, dtype=torch.bool, device=keys.device),
                       (keys[1:] != keys[:-1]).any(1)])
    seg = torch.cumsum(flags.long(), 0) - 1
    start = torch.cummax(torch.where(flags, idx, -1), 0).values
    return seg.to(torch.int32), start.to(torch.int32)


def run_lengths_ref(keys: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(seg_ids, run_start, run_length) over sorted keys (n, w)."""
    seg, start = segment_scan_ref(keys)
    counts = torch.bincount(seg.long(), minlength=keys.shape[0])
    return seg, start, counts[seg.long()].to(torch.int32)


def map_pack_ref(rows: torch.Tensor, ptable: torch.Tensor, routes, k: int,
                 n_dev: int, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The staged route -> fold -> pack composition, materializing the
    (n·F, w+1) tagged expansion: ((n_dev, cap, w+1) buffer, overflow)."""
    n, w = rows.shape
    if n == 0 or not routes:
        return (torch.full((n_dev, cap, w + 1), INVALID, dtype=rows.dtype,
                           device=rows.device),
                torch.tensor(0, dtype=torch.int32))
    logical, wrapped = _map_route_ref(rows, routes, k)
    fanout = logical.shape[1]
    phys = fold_cells_ref(wrapped.reshape(-1), ptable)
    tagged = torch.cat([rows[:, None, :].expand(n, fanout, w),
                        logical[:, :, None].to(rows.dtype)],
                       dim=-1).reshape(n * fanout, w + 1)
    return bucket_pack_ref(phys, tagged, n_dev, cap)


def scatter_pack_ref(rows: torch.Tensor, ptable: torch.Tensor, routes,
                     k: int, n_dev: int, cap: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """`scatter_pack`'s ground truth: what the staged composition holds."""
    return map_pack_ref(rows, ptable, routes, k, n_dev, cap)


def map_count_ref(rows: torch.Tensor, routes, k: int, n_src: int
                  ) -> torch.Tensor:
    """(n_src, k) routed copies per (source i // (n // n_src), cell)."""
    n = rows.shape[0]
    if n == 0 or not routes:
        return torch.zeros((n_src, k), dtype=torch.int32, device=rows.device)
    _, wrapped = _map_route_ref(rows, routes, k)
    fanout = wrapped.shape[1]
    flat = wrapped.reshape(-1).long()
    src = torch.repeat_interleave(
        torch.arange(n, device=rows.device) // max(n // n_src, 1), fanout)
    ok = (flat >= 0) & (src < n_src)
    counts = torch.zeros(n_src * k, dtype=torch.int64, device=rows.device)
    counts.index_add_(0, (src * k + flat)[ok], torch.ones_like(flat[ok]))
    return counts.reshape(n_src, k).to(torch.int32)


def expand_rows_ref(left: torch.Tensor, right: torch.Tensor,
                    counts: torch.Tensor, lo: torch.Tensor,
                    perm: torch.Tensor, cap: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Slot t = left[li] ++ right[perm[lo[li] + t - off[li]]], li the row
    whose [off, off + counts) window covers t; valid = t < Σ counts."""
    n_l, n_r = left.shape[0], right.shape[0]
    if n_l == 0 or n_r == 0:
        return (torch.full((cap, left.shape[1] + right.shape[1]), INVALID,
                           dtype=left.dtype, device=left.device),
                torch.zeros(cap, dtype=torch.bool, device=left.device))
    counts = counts.long()
    off = torch.cumsum(counts, 0) - counts
    t = torch.arange(cap, device=left.device)
    li = torch.clamp(torch.searchsorted(off, t, right=True) - 1, 0, n_l - 1)
    ri = perm.long()[torch.clamp(lo.long()[li] + t - off[li], 0, n_r - 1)]
    return torch.cat([left[li], right[ri]], 1), t < counts.sum()


def join_hash_ref(keys: torch.Tensor, valid: torch.Tensor, n_bits: int
                  ) -> torch.Tensor:
    """h = (Σ_c key_c · seed_c) · MULT over uint32, bucket = top n_bits bits,
    seed_c = (0x9E3779B1 + 2c·0x85EBCA77) | 1; invalid rows -> 2^n_bits."""
    h = torch.zeros(keys.shape[0], dtype=torch.int64, device=keys.device)
    for c in range(keys.shape[1]):
        seed = ((0x9E3779B1 + 2 * c * 0x85EBCA77) | 1) & MASK32
        h = (h + u32(keys[:, c]) * seed) & MASK32
    h = ((h * MULT) & MASK32) >> (32 - n_bits)
    return torch.where(valid.bool(), h, torch.full_like(h, 1 << n_bits)
                       ).to(torch.int32)


def build_table_ref(keys: torch.Tensor, valid: torch.Tensor, n_bits: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(bucket, stable within-bucket rank, histogram) by one-hot cumsum."""
    d = join_hash_ref(keys, valid, n_bits)
    rank, hist = bucket_rank_ref(d, 1 << n_bits)
    return d, rank, hist


def join_probe_ref(lk: torch.Tensor, l_valid: torch.Tensor, rk: torch.Tensor,
                   r_valid: torch.Tensor, cap: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense probe: (li, ri, valid) of every exact-key match in (left row,
    right arrival) order, padded to `cap`.  O(n_l·n_r)."""
    n_r = rk.shape[0]
    match = l_valid.bool()[:, None] & r_valid.bool()[None, :]
    match &= (lk[:, None, :] == rk[None, :, :]).all(-1)
    flat = torch.nonzero(match.reshape(-1))[:, 0][:cap]
    n_match = int(match.sum())
    flat = torch.cat([flat, torch.zeros(cap - flat.shape[0], dtype=flat.dtype,
                                        device=flat.device)])
    return (flat // max(n_r, 1), flat % max(n_r, 1),
            torch.arange(cap, device=lk.device) < n_match)
