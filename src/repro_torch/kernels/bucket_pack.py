"""The staged map's pack: `bucket_rank` and `bucket_pack`.

Per batch row (one source shard), destinations outside [0, k) go to a
sentinel bucket k.  bucket_rank gives each item its stable arrival rank
within its bucket and the (k,) histogram; bucket_pack writes row i at
``buf[dest[i], rank[i]]`` of a (k, cap, w) buffer filled with -1 when
dest is in [0, k) and rank < cap, and counts the rest of the valid rows:
overflow = Σ_d max(hist_d − cap, 0).

`*_host` are the plain versions (one stable sort); `*_cuda` launch
csrc/bucket_pack.cu, which counts and ranks only the members of [0, k)
for the pack (bucket_rank also ranks the sentinel bucket), keeps its
counters in shared memory, writes each bucket's records of a tile as one
contiguous run and writes -1 only where no record lands.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import INVALID
from .map_pack import stable_rank

# csrc/bucket_pack.cu's tile (items) and BUCKET_SHARED_BINS.
TILE_ITEMS = 2048
SHARED_BINS = 4096


def bucket_geometry(n_bins: int) -> tuple[int, bool]:
    """(items a tile, counters in shared memory) of csrc/bucket_pack.cu for
    n_bins bins (k, or k + 1 with bucket_rank's sentinel).  Past SHARED_BINS
    bins one warp walks each tile with its counters in device memory."""
    return TILE_ITEMS, n_bins <= SHARED_BINS


def _bins(dest: torch.Tensor, k: int) -> torch.Tensor:
    return torch.where((dest >= 0) & (dest < k), dest, k).long()


def bucket_rank_host(dest: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `bucket_rank`: dest (B, m) -> (rank (B, m),
    hist (B, k)) int32."""
    b, m = dest.shape
    batch = torch.arange(b, device=dest.device)[:, None]
    rank, hist = stable_rank((batch * (k + 1) + _bins(dest, k)).reshape(-1),
                             b * (k + 1))
    return (rank.reshape(b, m).to(torch.int32),
            hist.reshape(b, k + 1)[:, :k].to(torch.int32))


def bucket_pack_host(dest: torch.Tensor, rows: torch.Tensor, k: int,
                     cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `bucket_pack`: dest (B, m), rows (B, m, w) ->
    (buf (B, k, cap, w), overflow (B,)) int32."""
    b, m, w = rows.shape
    rank, hist = bucket_rank_host(dest, k)
    overflow = torch.clamp(hist - cap, min=0).sum(1).to(torch.int32)
    d = _bins(dest, k)
    slot = torch.where((d < k) & (rank < cap), d * cap + rank, k * cap)
    buf = torch.full((b, k * cap + 1, w), INVALID, dtype=torch.int32,
                     device=rows.device)
    batch = torch.arange(b, device=rows.device)[:, None].expand(b, m)
    buf[batch, slot] = rows.to(torch.int32)      # trash slot k·cap dropped
    return buf[:, :k * cap].reshape(b, k, cap, w), overflow


def _launch(dest: torch.Tensor, rows: torch.Tensor | None, k: int, cap: int,
            rank: torch.Tensor | None, buf: torch.Tensor | None,
            overflow: torch.Tensor | None) -> torch.Tensor:
    """One bucket_pack_launch: with rows, the pack into buf and overflow;
    without, the ranks into rank.  Returns hist (B, k)."""
    b, m = dest.shape
    dev = dest.device
    w = 0 if rows is None else rows.shape[2]
    n_bins = k + (rows is None)
    tile, shared = bucket_geometry(n_bins)
    n_tiles = -(-m // tile)
    th = torch.empty((b, n_bins, n_tiles), dtype=torch.int32, device=dev)
    hist = torch.empty((b, k), dtype=torch.int32, device=dev)
    _build.call("bucket_pack_launch", dest.data_ptr(),
                None if rows is None else rows.data_ptr(), b, m, w, k, cap,
                tile, n_tiles, int(shared), th.data_ptr(),
                None if rank is None else rank.data_ptr(), hist.data_ptr(),
                None if buf is None else buf.data_ptr(),
                None if overflow is None else overflow.data_ptr(),
                _build.stream(dest))
    return hist


def bucket_rank_cuda(dest: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/bucket_pack.cu without a buffer: (rank, hist)."""
    dest = _build.as_i32(dest, "dest")
    if dest.dim() != 2:
        raise ValueError(f"bucket_rank: dest must be (B, m), got {dest.shape}")
    b, m = dest.shape
    if m == 0:
        return (torch.empty((b, 0), dtype=torch.int32, device=dest.device),
                torch.zeros((b, k), dtype=torch.int32, device=dest.device))
    rank = torch.empty((b, m), dtype=torch.int32, device=dest.device)
    return rank, _launch(dest, None, k, 0, rank, None, None)


def bucket_pack_cuda(dest: torch.Tensor, rows: torch.Tensor, k: int,
                     cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/bucket_pack.cu (tile counts, scan, rank and write, fill,
    overflow): (buf (B, k, cap, w), overflow (B,)).  No rank is allocated
    or written."""
    dest = _build.as_i32(dest, "dest")
    rows = _build.as_i32(rows, "rows")
    b, m, w = rows.shape
    if dest.shape != (b, m):
        raise ValueError(f"bucket_pack: dest {tuple(dest.shape)} does not "
                         f"match rows {tuple(rows.shape)}")
    dev = rows.device
    if m == 0:
        return (torch.full((b, k, cap, w), INVALID, dtype=torch.int32,
                           device=dev),
                torch.zeros(b, dtype=torch.int32, device=dev))
    buf = torch.empty((b, k, cap, w), dtype=torch.int32, device=dev)
    overflow = torch.empty(b, dtype=torch.int32, device=dev)
    _launch(dest, rows, k, cap, None, buf, overflow)
    return buf, overflow
