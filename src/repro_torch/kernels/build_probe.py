"""The sort-merge reduce's grouping pass: `segment_scan` and `run_lengths`.

Keys are (B, n, w), sorted lexicographically within each batch row (one
destination); runs never cross a batch row.  Row i starts a run when it is
row 0 or any column differs from the row before.  segment_scan gives each
row the dense id of its run (seg) and the run's first row (start);
run_lengths adds the run's length.

`*_host` are the plain versions (cumsum and cummax); `*_cuda` launch
csrc/build_probe.cu.  The reference's `match_counts` and `first_match`,
in the same reference module, are not ported here.
"""
from __future__ import annotations

import torch

from . import _build

# Rows one block scans per tile (csrc/build_probe.cu SEG_TILE).
SEG_TILE_ROWS = 2048


def _scan_host(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(seg, start) int64 of keys (B, n, w), n ≥ 1."""
    b, n = keys.shape[:2]
    flags = torch.ones((b, n), dtype=torch.bool, device=keys.device)
    flags[:, 1:] = (keys[:, 1:] != keys[:, :-1]).any(-1)
    seg = torch.cumsum(flags.long(), 1) - 1
    idx = torch.arange(n, device=keys.device).expand(b, n)
    start = torch.cummax(torch.where(flags, idx, -1), 1).values
    return seg, start


def segment_scan_host(keys: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `segment_scan`: (seg (B, n), start (B, n)) int32."""
    if keys.shape[1] == 0:
        z = torch.zeros(keys.shape[:2], dtype=torch.int32, device=keys.device)
        return z, z.clone()
    seg, start = _scan_host(keys)
    return seg.to(torch.int32), start.to(torch.int32)


def run_lengths_host(keys: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of `run_lengths`: (seg, start, length), each (B, n)."""
    b, n = keys.shape[:2]
    if n == 0:
        z = torch.zeros((b, 0), dtype=torch.int32, device=keys.device)
        return z, z.clone(), z.clone()
    seg, start = _scan_host(keys)
    flat = (torch.arange(b, device=keys.device)[:, None] * n + seg).reshape(-1)
    length = torch.bincount(flat, minlength=b * n)[flat].reshape(b, n)
    return (seg.to(torch.int32), start.to(torch.int32),
            length.to(torch.int32))


def _scan_cuda(keys: torch.Tensor, with_length: bool) -> tuple:
    keys = _build.as_i32(keys, "keys")
    if keys.dim() != 3:
        raise ValueError(f"segment_scan: keys must be (B, n, w), got "
                         f"{keys.shape}")
    b, n, w = keys.shape
    dev = keys.device
    outs = tuple(torch.empty((b, n), dtype=torch.int32, device=dev)
                 for _ in range(3 if with_length else 2))
    if b * n == 0:
        return outs
    n_tiles = -(-n // SEG_TILE_ROWS)
    cnt = torch.empty((b, n_tiles), dtype=torch.int32, device=dev)
    runs = torch.empty(b, dtype=torch.int32, device=dev)
    first = torch.empty((b, n), dtype=torch.int32, device=dev)
    _build.call("segment_scan_launch", keys.data_ptr(), b, n, w, n_tiles,
                cnt.data_ptr(), runs.data_ptr(), first.data_ptr(),
                outs[0].data_ptr(), outs[1].data_ptr(),
                outs[2].data_ptr() if with_length else None,
                _build.stream(keys))
    return outs


def segment_scan_cuda(keys: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/build_probe.cu's scan: (seg, start)."""
    return _scan_cuda(keys, False)


def run_lengths_cuda(keys: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch csrc/build_probe.cu's scan with run lengths."""
    return _scan_cuda(keys, True)
