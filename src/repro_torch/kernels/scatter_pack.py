"""The map phase (`scatter_pack`) and the reduce-side expansion (`expand_rows`).

scatter_pack — per source shard (leading axis), route every (row, copy)
through the relation's recipe, fold the wrapped cell to a device through the
(k,) placement table, rank each copy stably within its device in (row, copy)
order and write ``row ++ logical cell`` at ``buf[src, dev, rank]``; ranks
≥ cap are dropped and counted: overflow[src] = Σ_dev max(hist − cap, 0).
The buffer is (n_src, n_dev, cap, w+1), -1 filled: exactly what the
reference's per-device `scatter_pack` writes, stacked over sources.

expand_rows — per destination (leading axis), turn a probe's (counts, lo,
perm) into output rows: slot t holds
``left[li] ++ right[perm[lo[li] + t − off[li]]]`` with off the exclusive
prefix sum of counts and li the left row whose window covers t (clipped);
valid = t < Σ counts.  Slots past the total hold the clipped formula's rows,
as the reference's do.  With ``cols`` (indices into the ``left ++ right``
columns) the output is ``where(valid, full[..., cols], -1)``: the join
step's column selection and -1 fill, written in the same pass.

`*_host` are the plain versions (stable sort / searchsorted + gathers);
`scatter_pack_cuda` launches csrc/scatter_pack.cu, `expand_rows_cuda`
csrc/expand_rows.cu.  The scatter_pack kernel works on member copies only:
it routes each row once, ranks the member copies of a tile in shared
memory and writes each device's records as one contiguous run.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .map_pack import (MAX_PACK_BINS, RouteSpec, empty_pack, pack_overflow,
                       pack_slots, route_fanout, route_streams,
                       scatter_desc_tensor)
from .ref import INVALID


def scatter_pack_host(rows: torch.Tensor, routes: RouteSpec,
                      ptable: torch.Tensor, k: int, n_dev: int, cap: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `scatter_pack`: rows (n_src, n_loc, w) ->
    (buf (n_src, n_dev, cap, w+1), overflow (n_src,))."""
    s, n, w = rows.shape
    fanout = route_fanout(routes)
    if n == 0 or fanout == 0:
        return empty_pack(rows, n_dev, cap)
    m = n * fanout
    tag, d, rank, hist = route_streams(rows, routes, ptable, k, n_dev)
    slot = pack_slots(d, rank, n_dev, cap)
    vals = torch.cat([rows[:, :, None, :].expand(s, n, fanout, w)
                      .reshape(s, m, w), tag[..., None]], -1)
    buf = torch.full((s, n_dev * cap + 1, w + 1), INVALID, dtype=torch.int32,
                     device=rows.device)
    src = torch.arange(s, device=rows.device)[:, None]
    buf[src.expand(s, m), slot] = vals           # trash row n_dev·cap dropped
    return (buf[:, :n_dev * cap].reshape(s, n_dev, cap, w + 1),
            pack_overflow(hist, n_dev, cap))


# csrc/scatter_pack.cu's SCATTER_TILE_ROWS and SCATTER_ROW_WORDS: a tile
# holds at most 1,024 rows, and at most 8,192 row words unless one row is
# wider.
SCATTER_TILE_ROWS = 1024
SCATTER_ROW_WORDS = 8192


def scatter_tile_rows(w: int) -> int:
    """Rows per tile of csrc/scatter_pack.cu for rows of w words: as many
    as fit the kernels' shared-memory copy of the tile, at least one."""
    return max(1, min(SCATTER_TILE_ROWS, SCATTER_ROW_WORDS // max(w, 1)))


def scatter_scratch(rows: torch.Tensor, n_dev: int
                    ) -> tuple[int, int, torch.Tensor]:
    """(rows per tile, tiles per source, per-tile member copies per device
    (n_src, n_dev, tiles)) of csrc/scatter_pack.cu; n_dev < MAX_PACK_BINS."""
    if n_dev + 1 > MAX_PACK_BINS:
        raise ValueError(f"scatter_pack takes n_dev < {MAX_PACK_BINS}")
    s, n, w = rows.shape
    tile_rows = scatter_tile_rows(w)
    n_tiles = -(-n // tile_rows)
    return tile_rows, n_tiles, torch.empty((s, n_dev, n_tiles),
                                           dtype=torch.int32,
                                           device=rows.device)


def scatter_pack_cuda(rows: torch.Tensor, routes: RouteSpec,
                      ptable: torch.Tensor, k: int, n_dev: int, cap: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/scatter_pack.cu (member counts per tile, scan, rank and
    write, -1 fill, overflow) for rows (n_src, n_loc, w) int32 on the
    card."""
    rows = _build.as_i32(rows, "rows")
    ptable = _build.as_i32(ptable, "ptable")
    s, n, w = rows.shape
    fanout = route_fanout(routes)
    if n == 0 or fanout == 0:
        return empty_pack(rows, n_dev, cap)
    tile_rows, n_tiles, th = scatter_scratch(rows, n_dev)
    dev = rows.device
    hist = torch.empty((s, n_dev), dtype=torch.int32, device=dev)
    buf = torch.empty((s, n_dev, cap, w + 1), dtype=torch.int32, device=dev)
    overflow = torch.empty(s, dtype=torch.int32, device=dev)
    desc = scatter_desc_tensor(routes, dev)
    _build.call("scatter_pack_launch", rows.data_ptr(), s, n, w,
                desc.data_ptr(), desc.numel(), len(routes), ptable.data_ptr(),
                k, n_dev, cap, tile_rows, n_tiles, th.data_ptr(),
                hist.data_ptr(), buf.data_ptr(), overflow.data_ptr(),
                _build.stream(rows))
    return buf, overflow


# Merge items (left rows + output slots) per block of the expansion and
# entries per block of its scan of counts; at most EXPAND_MAX_COLS output
# columns (csrc/expand_rows.cu).
EXPAND_TILE = 2048
SCAN_TILE = 2048
EXPAND_MAX_COLS = 16


def _check_cols(cols, width: int) -> tuple[int, ...] | None:
    """`cols` as a tuple of column indices into ``left ++ right``, or None."""
    if cols is None:
        return None
    cols = tuple(int(c) for c in cols)
    if not 1 <= len(cols) <= EXPAND_MAX_COLS or \
            any(not 0 <= c < width for c in cols):
        raise ValueError(f"cols {cols}: 1 to {EXPAND_MAX_COLS} indices into "
                         f"the {width} columns of left ++ right")
    return cols


def _empty_expand(left: torch.Tensor, right: torch.Tensor, cap: int, cols
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    b = left.shape[0]
    width = left.shape[2] + right.shape[2] if cols is None else len(cols)
    return (torch.full((b, cap, width), INVALID, dtype=torch.int32,
                       device=left.device),
            torch.zeros((b, cap), dtype=torch.bool, device=left.device))


def expand_rows_host(left: torch.Tensor, right: torch.Tensor,
                     counts: torch.Tensor, lo: torch.Tensor,
                     perm: torch.Tensor, cap: int, cols=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `expand_rows`: batched searchsorted + gathers.
    left (B, n_l, wl), right (B, n_r, wr), counts/lo (B, n_l), perm (B, n_r)
    -> (out (B, cap, wl + wr), valid (B, cap)); with `cols`, out is
    ``where(valid, full[..., cols], -1)`` of that full expansion."""
    b, n_l, wl = left.shape
    n_r, wr = right.shape[1], right.shape[2]
    cols = _check_cols(cols, wl + wr)
    if n_l == 0 or n_r == 0:
        return _empty_expand(left, right, cap, cols)
    counts = counts.long()
    off = torch.cumsum(counts, 1) - counts
    t = torch.arange(cap, device=left.device).expand(b, cap).contiguous()
    li = torch.clamp(torch.searchsorted(off, t, right=True) - 1, 0, n_l - 1)
    inner = torch.clamp(torch.gather(lo.long(), 1, li) + t
                        - torch.gather(off, 1, li), 0, n_r - 1)
    ri = torch.gather(perm.long(), 1, inner)
    out = torch.cat([torch.gather(left, 1, li[..., None].expand(b, cap, wl)),
                     torch.gather(right, 1, ri[..., None].expand(b, cap, wr))],
                    -1)
    valid = t < counts.sum(1, keepdim=True)
    if cols is None:
        return out, valid
    return torch.where(valid[..., None], out[..., list(cols)], INVALID), valid


def expand_rows_cuda(left: torch.Tensor, right: torch.Tensor,
                     counts: torch.Tensor, lo: torch.Tensor,
                     perm: torch.Tensor, cap: int, cols=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/expand_rows.cu: tiled scan of counts, pre-permute of the
    right columns that the output takes, merge-path partition, one block
    per merge tile writing its span of output columns, then the slots past
    the total."""
    left = _build.as_i32(left, "left")
    right = _build.as_i32(right, "right")
    counts = _build.as_i32(counts, "counts")
    lo = _build.as_i32(lo, "lo")
    perm = _build.as_i32(perm, "perm")
    b, n_l, wl = left.shape
    n_r, wr = right.shape[1], right.shape[2]
    cols = _check_cols(cols, wl + wr)
    if n_l == 0 or n_r == 0:
        return _empty_expand(left, right, cap, cols)
    cmap = tuple(range(wl + wr)) if cols is None else cols
    rcols = sorted({c - wl for c in cmap if c >= wl})
    code = [c if c < wl else wl + rcols.index(c - wl) for c in cmap]
    c_code = (ctypes.c_int * len(code))(*code)
    c_rcols = (ctypes.c_int * max(len(rcols), 1))(*rcols)
    n_scan = -(-n_l // SCAN_TILE)
    n_tiles = max(1, -(-(n_l + cap) // EXPAND_TILE))
    dev = left.device
    i32 = dict(dtype=torch.int32, device=dev)
    tsum = torch.empty((b, n_scan), **i32)
    off = torch.empty((b, n_l), **i32)
    total = torch.empty(b, **i32)
    rsel = torch.empty((b, n_r, len(rcols)), **i32)
    splits = torch.empty((b, n_tiles + 1), dtype=torch.int64, device=dev)
    out = torch.empty((b, cap, len(cmap)), **i32)
    valid = torch.empty((b, cap), dtype=torch.bool, device=dev)
    _build.call("expand_rows_launch", left.data_ptr(), right.data_ptr(),
                counts.data_ptr(), lo.data_ptr(), perm.data_ptr(), b, n_l, wl,
                n_r, wr, cap, ctypes.addressof(c_code), len(code),
                ctypes.addressof(c_rcols), len(rcols), int(cols is not None),
                n_scan, tsum.data_ptr(), off.data_ptr(), total.data_ptr(),
                rsel.data_ptr(), n_tiles, splits.data_ptr(), out.data_ptr(),
                valid.data_ptr(), _build.stream(left))
    return out, valid
