"""Routing recipes and the prepare-time counting pass (`map_count`).

A relation's routing recipe is the `RouteSpec` nested tuple of
core.executor: one entry per residual route,
``(hashed, rep_strides, offset, eq_constraints, notin_constraints)`` with
``hashed = ((col, seed, share, stride), ...)``.  `_route_block` evaluates it
on torch tensors (any leading batch axes) and gives every (row, copy) its
unwrapped LOGICAL cell id, -1 on non-members; copies are ordered row-major
over (row, route, rep).  `route_desc` packs the same recipe into the int64
descriptor the CUDA kernels walk (layout in csrc/common.cuh).

`map_count` counts routed copies per (source shard, wrapped cell): rows
[i·(n/n_src), (i+1)·(n/n_src)) are source i.  `map_count_host` is its plain
version; `map_count_cuda` launches csrc/map_pack.cu.
"""
from __future__ import annotations

import functools

import torch

from . import _build
from .ref import INVALID, mulshift

RouteSpec = tuple


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
def route_desc_tensor(routes: RouteSpec, device: torch.device) -> torch.Tensor:
    """`route_desc` uploaded once per (recipe, device)."""
    return torch.tensor(route_desc(routes), dtype=torch.int64, device=device)


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
    """Launch csrc/map_pack.cu: rows (n, w) int32 on the card -> (n_src, k)."""
    rows = _build.as_i32(rows, "rows")
    n, w = rows.shape
    if n == 0 or route_fanout(routes) == 0:
        return torch.zeros((n_src, k), dtype=torch.int32, device=rows.device)
    counts = torch.empty((n_src, k), dtype=torch.int32, device=rows.device)
    desc = route_desc_tensor(routes, rows.device)
    _build.call("map_count_launch", rows.data_ptr(), n, w, desc.data_ptr(),
                route_fanout(routes), k, n_src, max(n // n_src, 1),
                counts.data_ptr(), _build.stream(rows))
    return counts
