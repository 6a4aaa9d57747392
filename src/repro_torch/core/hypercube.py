"""Hypercube routing: tuples -> reducer cells (paper §2 'Shares' schema).

Each residual join J_i owns a block of k_i reducers arranged as a hypercube
with one axis per *free-share* attribute (share = axis length).  A tuple of
relation R_j is sent to the cells whose coordinates agree with the tuple's
hashes on the free attributes R_j contains, for ALL values of the axes R_j
lacks (replication).  HH-typed and dominated attributes have share 1 and
contribute no axis — Theorem 5.1 in executable form: *each tuple is hashed on
its non-HH attributes only*.

Hashing is multiply-shift over uint32 with per-(attribute, residual) odd seeds;
power-of-two bucket counts take the top bits, which is the standard universal
scheme; the port's CUDA map kernels (kernels/csrc/map_pack.cu) apply it
on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

# Knuth's multiplicative constant (odd, 32-bit).
_MULT = np.uint32(2654435769)


def hash_seed(attr: str, salt: int = 0) -> int:
    """Deterministic odd 32-bit seed per attribute (stable across hosts)."""
    h = 2166136261 ^ (salt * 16777619)
    for ch in attr.encode():
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return int(h | 1)


def multiply_shift(values: np.ndarray, seed: int, nbuckets: int) -> np.ndarray:
    """h(v) = top-log2(nbuckets) bits of (v*seed*MULT) over uint32.  nbuckets=2^b."""
    if nbuckets & (nbuckets - 1):
        raise ValueError(f"nbuckets={nbuckets} not a power of two")
    if nbuckets == 1:
        return np.zeros(np.shape(values), dtype=np.int32)
    b = nbuckets.bit_length() - 1
    v = np.asarray(values).astype(np.uint32)
    h = (v * np.uint32(seed)) * _MULT
    return (h >> np.uint32(32 - b)).astype(np.int32)


@dataclass(frozen=True)
class Hypercube:
    """A reducer block: ordered free attributes with their (power-of-two) shares."""

    attr_order: tuple[str, ...]
    shares: tuple[int, ...]
    offset: int = 0              # global reducer id of cell (0,…,0)
    salt: int = 0                # residual-join index -> independent hash family

    @property
    def n_cells(self) -> int:
        out = 1
        for s in self.shares:
            out *= s
        return out

    def cell_ids(self) -> np.ndarray:
        """The block's LOGICAL cell ids: [offset, offset + n_cells), unwrapped.

        Offsets are cumulative across a plan's residual blocks, so these ids
        are globally unique; routing wraps them modulo the plan's k and
        `core.placement.CellPlacement` then folds the wrapped ids onto
        physical devices.  (Cells of this block may therefore share a device
        with cells of OTHER residuals — exactness comes from the executor
        joining only within equal logical cell ids.)"""
        return np.arange(self.offset, self.offset + self.n_cells,
                         dtype=np.int64)

    def strides(self) -> tuple[int, ...]:
        """Mixed-radix strides: cell_id = Σ coord_i · stride_i (row-major)."""
        strides = [1] * len(self.shares)
        for i in range(len(self.shares) - 2, -1, -1):
            strides[i] = strides[i + 1] * self.shares[i + 1]
        return tuple(strides)

    def encode(self, coords: Sequence[np.ndarray]) -> np.ndarray:
        cell = np.zeros_like(np.asarray(coords[0])) if coords else np.zeros((), np.int32)
        for c, stride in zip(coords, self.strides()):
            cell = cell + np.asarray(c) * stride
        return cell + self.offset

    def route(
        self,
        rel_attrs: tuple[str, ...],
        arr: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Destinations for every row of `arr` (relation with `rel_attrs`).

        Returns (row_idx, reducer_id), both of length n_rows · fanout, where
        fanout = ∏ shares of free attrs NOT in the relation.  Reference (numpy)
        implementation; the on-device analogue lives in kernels/map_pack.py.
        """
        n = len(arr)
        strides = self.strides()
        base = np.zeros(n, dtype=np.int64)
        wild_axes: list[tuple[int, int]] = []   # (axis index, share)
        for ax, (attr, share) in enumerate(zip(self.attr_order, self.shares)):
            if attr in rel_attrs:
                col = arr[:, rel_attrs.index(attr)]
                base += multiply_shift(col, hash_seed(attr, self.salt), share).astype(np.int64) * strides[ax]
            else:
                wild_axes.append((ax, share))
        fanout = 1
        for _, s in wild_axes:
            fanout *= s
        # Enumerate the replication grid.
        reps = np.zeros(fanout, dtype=np.int64)
        if wild_axes:
            grids = np.meshgrid(*[np.arange(s) for _, s in wild_axes], indexing="ij")
            reps = sum(g.ravel() * strides[ax] for (ax, _), g in zip(wild_axes, grids))
        row_idx = np.repeat(np.arange(n), fanout)
        dest = (base[:, None] + reps[None, :]).ravel() + self.offset
        return row_idx, dest

    def fanout(self, rel_attrs: tuple[str, ...]) -> int:
        f = 1
        for attr, share in zip(self.attr_order, self.shares):
            if attr not in rel_attrs:
                f *= share
        return f
