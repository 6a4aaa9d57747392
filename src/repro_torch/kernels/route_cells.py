"""The staged map's first two stages: `route_cells` and `fold_cells`.

route_cells — the hypercube base cell of every row,
``Σ_i h_i(row[col_i]) · stride_i`` over uint32, h_i the top log2(share_i)
bits of row[col_i]·seed_i·MULT, for a recipe ``((col, seed, share,
stride), ...)`` with power-of-two shares (share-1 axes add nothing).
Replication offsets and membership are the caller's (core.executor).

fold_cells — the placement fold ``table[dest]`` of wrapped logical cells:
-1 stays -1, and a dest past the (k,) table gives 0, as the reference's
Pallas kernel does (its one-hot sum finds no match).

`*_host` are the plain versions; `*_cuda` launch csrc/route_cells.cu.
"""
from __future__ import annotations

import functools

import torch

from . import _build
from .ref import INVALID, route_cells_ref


def _check_recipe(recipe) -> None:
    """Raise ValueError on a share that is not a power of two."""
    for _, _, share, _ in recipe:
        if share & (share - 1):
            raise ValueError(f"share {share} not a power of two")


def route_cells_host(rows: torch.Tensor, recipe) -> torch.Tensor:
    """Plain version of `route_cells`: rows (n, w) -> (n,) int32."""
    _check_recipe(recipe)
    return route_cells_ref(rows, recipe)


@functools.lru_cache(maxsize=256)
def _recipe_desc(recipe, device: torch.device) -> torch.Tensor:
    """The recipe's non-trivial axes as (col, seed, bits, stride) int64
    records, uploaded once per (recipe, device)."""
    words = [x for col, seed, share, stride in recipe if share != 1
             for x in (col, seed, share.bit_length() - 1, stride)]
    return torch.tensor(words, dtype=torch.int64, device=device)


def route_cells_cuda(rows: torch.Tensor, recipe) -> torch.Tensor:
    """Launch csrc/route_cells.cu's router: one thread per row."""
    _check_recipe(recipe)
    rows = _build.as_i32(rows, "rows")
    n, w = rows.shape
    if any(not 0 <= col < w for col, _, _, _ in recipe):
        raise ValueError(f"route_cells: a recipe column is outside the "
                         f"rows' {w} columns")
    out = torch.empty(n, dtype=torch.int32, device=rows.device)
    if n == 0:
        return out
    desc = _recipe_desc(tuple(recipe), rows.device)
    _build.call("route_cells_launch", rows.data_ptr(), n, w, desc.data_ptr(),
                desc.numel() // 4, out.data_ptr(), _build.stream(rows))
    return out


def fold_cells_host(dest: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain version of `fold_cells`: dest (any shape) -> the same shape."""
    k = table.shape[0]
    inside = (dest >= 0) & (dest < k)
    phys = table[torch.where(inside, dest, 0).long()]
    return torch.where(inside, phys, torch.where(dest < 0, INVALID, 0)
                       ).to(torch.int32)


def fold_cells_cuda(dest: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Launch csrc/route_cells.cu's fold: one thread per element, the table
    in shared memory."""
    dest = _build.as_i32(dest, "dest")
    table = _build.as_i32(table, "table")
    if table.dim() != 1:
        raise ValueError(f"fold_cells: table must be 1-D, got {table.shape}")
    out = torch.empty_like(dest)
    if dest.numel() == 0:
        return out
    _build.call("fold_cells_launch", dest.data_ptr(), dest.numel(),
                table.data_ptr(), table.shape[0], out.data_ptr(),
                _build.stream(dest))
    return out
