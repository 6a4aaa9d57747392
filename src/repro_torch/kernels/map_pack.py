"""Routing recipes, the prepare-time counting pass (`map_count`) and the
fused map phase's streams (`map_pack`).

A relation's routing recipe is the `RouteSpec` nested tuple of
core.executor: one entry per residual route,
``(hashed, rep_strides, offset, eq_constraints, notin_constraints)`` with
``hashed = ((col, seed, share, stride), ...)``.  `_route_block` evaluates it
on torch tensors (any leading batch axes) and gives every (row, copy) its
unwrapped LOGICAL cell id, -1 on non-members; copies are ordered row-major
over (row, route, rep).  `route_desc` packs the same recipe into a
descriptor (layout in csrc/common.cuh), and `scatter_desc_tensor` uploads
it, wrapped to int32, for the CUDA kernels (map_count, map_pack,
scatter_pack).

`map_count` counts routed copies per (source shard, wrapped cell): rows
[i·(n/n_src), (i+1)·(n/n_src)) are source i.  `map_count_host` is its plain
version; `map_count_cuda` launches csrc/map_pack.cu.

`map_pack` is the map phase per source shard (leading axis) in two
stages, as the reference's: the streams — d (each (row, copy)'s device
through the (k,) placement table, n_dev for non-members), tag (its
unwrapped logical cell, -1 for non-members) and rank (its stable arrival
rank within d) — plus the (n_dev + 1,) histogram; then the assembly of the
(n_src, n_dev, cap, w+1) buffer from them, ranks ≥ cap dropped and counted
as overflow.  The buffer equals `scatter_pack`'s bit for bit.
`route_streams` is the plain version of the streams (one stable sort) and
`_assemble_tagged` of the assembly (torch gathers);
`map_pack_streams_cuda` launches csrc/map_pack.cu's streams kernels and
`map_pack_cuda` those and its assembly kernels: no torch op touches the
buffer on the card.
"""
from __future__ import annotations

import functools

import torch

from . import _build
from .ref import INVALID, mulshift

RouteSpec = tuple

# One more than the devices map_pack's and scatter_pack's kernels take
# (their per-warp device counters sit in shared memory).
MAX_PACK_BINS = 1536


def route_fanout(routes: RouteSpec) -> int:
    """Total copies per input row over every residual route."""
    return sum(len(reps) for _, reps, _, _, _ in routes)


def _route_block(rows: torch.Tensor, routes: RouteSpec, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(logical (..., n, F) int32, valid (..., n, F) bool) for rows (..., n, w).

    Flattening the last two axes gives the reference's copy order (routes
    concatenated, reps in rep_strides order)."""
    member_base = rows[..., 0] != INVALID
    logical_cols, valid_cols = [], []
    neg = torch.tensor(INVALID, dtype=torch.int32, device=rows.device)
    for hashed, reps, offset, eqs, notins in routes:
        member = member_base
        for col, val in eqs:
            member = member & (rows[..., col] == val)
        for col, vals in notins:
            for v in vals:
                member = member & (rows[..., col] != v)
        base = torch.zeros(rows.shape[:-1], dtype=torch.int32,
                           device=rows.device)
        for col, seed, share, stride in hashed:
            if share == 1:
                continue
            base = base + mulshift(rows[..., col], seed,
                                   share.bit_length() - 1) * stride
        for r in reps:
            logical_cols.append(torch.where(member, base + (r + offset), neg))
            valid_cols.append(member)
    return torch.stack(logical_cols, -1), torch.stack(valid_cols, -1)


def route_desc(routes: RouteSpec) -> list[int]:
    """The recipe as the kernels' int64 descriptor (csrc/common.cuh)."""
    copies, records = [], []
    for r, (hashed, reps, offset, eqs, notins) in enumerate(routes):
        copies.extend(w for rep in reps for w in (r, rep + offset))
        hs = [(col, seed, share.bit_length() - 1, stride)
              for col, seed, share, stride in hashed if share != 1]
        ne = [(col, v) for col, vals in notins for v in vals]
        records.append([len(hs), len(eqs), len(ne),
                        *(x for h in hs for x in h),
                        *(x for e in eqs for x in e),
                        *(x for e in ne for x in e)])
    fanout = len(copies) // 2
    head = 2 + len(copies) + len(records)
    starts = []
    for rec in records:
        starts.append(head)
        head += len(rec)
    return [fanout, len(routes), *copies, *starts,
            *(x for rec in records for x in rec)]


@functools.lru_cache(maxsize=256)
def scatter_desc_tensor(routes: RouteSpec, device: torch.device
                        ) -> torch.Tensor:
    """The int32 descriptor of csrc/scatter_pack.cu and of map_count
    (csrc/map_pack.cu), uploaded once per (recipe, device): `route_desc`'s
    words wrapped to int32 (what the routing truncates them to), then each
    route's first copy (n_routes + 1 words)."""
    first = [0]
    for _, reps, _, _, _ in routes:
        first.append(first[-1] + len(reps))
    words = [(x + (1 << 31)) % (1 << 32) - (1 << 31)
             for x in route_desc(routes) + first]
    return torch.tensor(words, dtype=torch.int32, device=device)


def count_scatter(dest: torch.Tensor, n: int, k: int, n_src: int
                  ) -> torch.Tensor:
    """(n_src, k) histogram of flat per-copy wrapped cells (row-major copy
    order of n rows); dest < 0 and sources beyond n_src count toward
    nothing."""
    fan = dest.shape[0] // max(n, 1)
    src = torch.repeat_interleave(
        torch.arange(n, device=dest.device) // max(n // n_src, 1), fan)
    ok = (dest >= 0) & (src < n_src)
    idx = (src * k + dest.long())[ok]
    return torch.bincount(idx, minlength=n_src * k).reshape(
        n_src, k).to(torch.int32)


def map_count_host(rows: torch.Tensor, routes: RouteSpec, k: int,
                   n_src: int) -> torch.Tensor:
    """Plain version of `map_count`: route, then one bincount."""
    n = rows.shape[0]
    if n == 0 or route_fanout(routes) == 0:
        return torch.zeros((n_src, k), dtype=torch.int32, device=rows.device)
    logical, valid = _route_block(rows, routes, k)
    wrapped = torch.where(valid, logical % k, INVALID).reshape(-1)
    return count_scatter(wrapped, n, k, n_src)


def map_count_cuda(rows: torch.Tensor, routes: RouteSpec, k: int,
                   n_src: int) -> torch.Tensor:
    """Launch csrc/map_pack.cu: rows (n, w) int32 on the card -> (n_src, k).
    A block takes 2,048 rows of one source, staged in shared memory a tile
    at a time; a thread a row tests each route once and hashes a member
    route once (a heavy route's reps spread over the warp), and the warp's
    cells go to counters in shared memory (device memory past 8,192 cells)
    with one add a distinct cell; each block flushes its non-zero counters
    with one atomic each.  What holds it above its bound: those atomics and
    each tile's load before its count."""
    rows = _build.as_i32(rows, "rows")
    n, w = rows.shape
    if n == 0 or route_fanout(routes) == 0:
        return torch.zeros((n_src, k), dtype=torch.int32, device=rows.device)
    counts = torch.empty((n_src, k), dtype=torch.int32, device=rows.device)
    desc = scatter_desc_tensor(routes, rows.device)
    _build.call("map_count_launch", rows.data_ptr(), n, w, desc.data_ptr(),
                desc.numel(), len(routes), k, n_src, max(n // n_src, 1),
                counts.data_ptr(), _build.stream(rows))
    return counts


def stable_rank(key: torch.Tensor, n_bins: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rank, hist) of flat bucket ids in [0, n_bins): each element's
    arrival rank within its bucket, via one stable sort."""
    order = torch.argsort(key, stable=True)
    sk = key[order]
    pos = torch.arange(key.shape[0], device=key.device) \
        - torch.searchsorted(sk, sk)
    rank = torch.empty_like(pos).scatter_(0, order, pos)
    return rank, torch.bincount(key, minlength=n_bins)


def empty_pack(rows: torch.Tensor, n_dev: int, cap: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The pack of no copies: a -1 buffer and zero overflow per source."""
    s, _, w = rows.shape
    return (torch.full((s, n_dev, cap, w + 1), INVALID, dtype=torch.int32,
                       device=rows.device),
            torch.zeros(s, dtype=torch.int32, device=rows.device))


def route_streams(rows: torch.Tensor, routes: RouteSpec,
                  ptable: torch.Tensor, k: int, n_dev: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Plain version of the map_pack kernel: rows (n_src, n_loc, w) ->
    (tag, d, rank) (n_src, n_loc·F) and hist (n_src, n_dev + 1), int32."""
    s, n, _ = rows.shape
    logical, valid = _route_block(rows, routes, k)              # (s, n, F)
    wrapped = torch.where(valid, logical % k, 0).long()
    d = torch.where(valid, ptable.long()[wrapped], n_dev).reshape(s, -1)
    nb = n_dev + 1
    src = torch.arange(s, device=rows.device)[:, None]
    rank, hist = stable_rank((src * nb + d).reshape(-1), s * nb)
    return (logical.reshape(s, -1), d.to(torch.int32),
            rank.reshape(s, -1).to(torch.int32),
            hist.reshape(s, nb).to(torch.int32))


def pack_slots(d: torch.Tensor, rank: torch.Tensor, n_dev: int, cap: int
               ) -> torch.Tensor:
    """Flat buffer slot d·cap + rank of each copy; n_dev·cap (one past the
    buffer) for non-members and ranks ≥ cap."""
    d, rank = d.long(), rank.long()
    return torch.where((d < n_dev) & (rank < cap), d * cap + rank,
                       n_dev * cap)


def pack_overflow(hist: torch.Tensor, n_dev: int, cap: int) -> torch.Tensor:
    """(n_src,) copies dropped: Σ_dev max(hist − cap, 0)."""
    return torch.clamp(hist[:, :n_dev].long() - cap, min=0).sum(1).to(
        torch.int32)


def _assemble_tagged(rows: torch.Tensor, tag: torch.Tensor, d: torch.Tensor,
                     rank: torch.Tensor, hist: torch.Tensor, n_dev: int,
                     cap: int, fanout: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(buf (n_src, n_dev, cap, w+1), overflow (n_src,)) from the per-copy
    streams.  The inverse permutation is scattered as copy indices into
    n_dev·cap + 1 slots (the last, every dropped copy's, is cut off; empty
    slots hold m = n_loc·F); the rows are then gathered once from the
    original rows at copy // F (m // F = n_loc reads an appended -1 row),
    with the tag appended as the last column."""
    s, n, w = rows.shape
    m, dev = n * fanout, rows.device
    slot = pack_slots(d, rank, n_dev, cap)
    copies = torch.arange(m, device=dev).expand(s, m)
    inv = torch.full((s, n_dev * cap + 1), m, dtype=torch.int64, device=dev
                     ).scatter_(1, slot, copies)[:, :n_dev * cap]
    pad = torch.full((s, 1, w), INVALID, dtype=torch.int32, device=dev)
    rows_pad = torch.cat([rows, pad], 1)
    tag_pad = torch.cat([tag, pad[:, :, 0]], 1)
    vals = torch.gather(rows_pad, 1,
                        (inv // fanout)[..., None].expand(s, n_dev * cap, w))
    buf = torch.cat([vals, torch.gather(tag_pad, 1, inv)[..., None]], -1)
    return (buf.reshape(s, n_dev, cap, w + 1),
            pack_overflow(hist, n_dev, cap))


def map_pack_host(rows: torch.Tensor, routes: RouteSpec,
                  ptable: torch.Tensor, k: int, n_dev: int, cap: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `map_pack`: rows (n_src, n_loc, w) ->
    (buf (n_src, n_dev, cap, w+1), overflow (n_src,))."""
    fanout = route_fanout(routes)
    if rows.shape[1] == 0 or fanout == 0:
        return empty_pack(rows, n_dev, cap)
    streams = route_streams(rows, routes, ptable, k, n_dev)
    return _assemble_tagged(rows, *streams, n_dev, cap, fanout)


def pack_scratch(rows: torch.Tensor, fanout: int, n_dev: int
                 ) -> tuple[int, int, torch.Tensor]:
    """(rows per tile, tiles per source, per-tile counts (n_src, n_dev + 1,
    tiles)) of csrc/map_pack.cu's streams: scatter_pack's tiles; bin n_dev
    holds each tile's non-member copies.  Raises on what the kernels do not
    take: n_dev ≥ MAX_PACK_BINS, or a source of 2^31 copies or more."""
    from .scatter_pack import scatter_tile_rows
    s, n, w = rows.shape
    if not 1 <= n_dev < MAX_PACK_BINS:
        raise ValueError(f"map_pack takes 1 <= n_dev < {MAX_PACK_BINS}, "
                         f"got {n_dev}")
    if n * fanout >= 1 << 31:
        raise ValueError(f"map_pack: {n} rows x fanout {fanout} copies a "
                         f"source, past int32")
    if w < 1:
        raise ValueError("map_pack: rows need at least one column")
    tile_rows = scatter_tile_rows(w)
    n_tiles = -(-n // tile_rows)
    th = torch.empty((s, n_dev + 1, n_tiles), dtype=torch.int32,
                     device=rows.device)
    return tile_rows, n_tiles, th


def _launch_map_pack(rows: torch.Tensor, routes: RouteSpec,
                     ptable: torch.Tensor, k: int, n_dev: int,
                     cap: int | None):
    """Launch csrc/map_pack.cu on rows (n_src, n_loc, w) with n_loc·F > 0:
    ((d, tag, rank) planes (3, n_src, n_loc·F), hist (n_src, n_dev + 1),
    buf, overflow); with cap None only the streams (buf, overflow None).
    The assembly's scratch is the (n_src, n_dev, cap) slot map of (copy,
    tag) pairs."""
    s, n, w = rows.shape
    fanout = route_fanout(routes)
    tile_rows, n_tiles, th = pack_scratch(rows, fanout, n_dev)
    dev = rows.device
    streams = torch.empty((3, s, n * fanout), dtype=torch.int32, device=dev)
    hist = torch.empty((s, n_dev + 1), dtype=torch.int32, device=dev)
    buf = overflow = slots = None
    if cap is not None:
        buf = torch.empty((s, n_dev, cap, w + 1), dtype=torch.int32,
                          device=dev)
        overflow = torch.empty(s, dtype=torch.int32, device=dev)
        slots = torch.empty((s, n_dev, cap, 2), dtype=torch.int32,
                            device=dev)
    desc = scatter_desc_tensor(routes, dev)
    _build.call("map_pack_launch", rows.data_ptr(), s, n, w, desc.data_ptr(),
                desc.numel(), len(routes), fanout, ptable.data_ptr(), k,
                n_dev, tile_rows, n_tiles, th.data_ptr(), hist.data_ptr(),
                streams.data_ptr(), int(cap is not None),
                0 if cap is None else cap,
                None if buf is None else buf.data_ptr(),
                None if overflow is None else overflow.data_ptr(),
                None if slots is None else slots.data_ptr(),
                _build.stream(rows))
    return streams, hist, buf, overflow


def _card_args(rows: torch.Tensor, ptable: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """rows and ptable as the kernels take them, or raise."""
    rows = _build.as_i32(rows, "rows")
    ptable = _build.as_i32(ptable, "ptable")
    if rows.dim() != 3 or ptable.shape != (k,):
        raise ValueError(f"map_pack: rows must be (n_src, n_loc, w) and "
                         f"ptable ({k},), got {tuple(rows.shape)} and "
                         f"{tuple(ptable.shape)}")
    return rows, ptable


def map_pack_streams_cuda(rows: torch.Tensor, routes: RouteSpec,
                          ptable: torch.Tensor, k: int, n_dev: int
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Launch csrc/map_pack.cu's streams on rows (n_src, n_loc, w) int32 on
    the card: (tag, d, rank) (n_src, n_loc·F) and hist (n_src, n_dev+1)."""
    rows, ptable = _card_args(rows, ptable, k)
    s, n, _ = rows.shape
    fanout = route_fanout(routes)
    if n * fanout == 0:
        empty = torch.empty((s, 0), dtype=torch.int32, device=rows.device)
        hist = torch.zeros((s, n_dev + 1), dtype=torch.int32,
                           device=rows.device)
        return empty, empty, empty, hist
    (d, tag, rank), hist, _, _ = _launch_map_pack(rows, routes, ptable, k,
                                                  n_dev, None)
    return tag, d, rank, hist


def map_pack_cuda(rows: torch.Tensor, routes: RouteSpec,
                  ptable: torch.Tensor, k: int, n_dev: int, cap: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/map_pack.cu (streams, then the assembly: records, -1
    fill, overflow): (buf (n_src, n_dev, cap, w+1), overflow (n_src,))."""
    rows, ptable = _card_args(rows, ptable, k)
    if cap < 0:
        raise ValueError(f"map_pack: cap {cap} < 0")
    if rows.shape[1] == 0 or route_fanout(routes) == 0:
        return empty_pack(rows, n_dev, cap)
    _, _, buf, overflow = _launch_map_pack(rows, routes, ptable, k, n_dev,
                                           cap)
    return buf, overflow
