"""Reference (single-machine) multiway natural join — correctness oracle.

Plain left-to-right hash-join cascade in numpy.  Output columns follow the
query's attribute order (`query.attributes`).  Used by tests and benchmarks to
validate the distributed executor and the local-join kernels.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from .plan import JoinQuery


def join_two(
    left: np.ndarray, left_attrs: tuple[str, ...],
    right: np.ndarray, right_attrs: tuple[str, ...],
) -> tuple[np.ndarray, tuple[str, ...]]:
    """Natural join of two column-store arrays; returns (rows, attrs)."""
    common = [a for a in left_attrs if a in right_attrs]
    out_attrs = tuple(left_attrs) + tuple(a for a in right_attrs if a not in common)
    if left.size == 0 or right.size == 0:
        return np.zeros((0, len(out_attrs)), dtype=np.int64), out_attrs
    if not common:
        li = np.repeat(np.arange(len(left)), len(right))
        ri = np.tile(np.arange(len(right)), len(left))
    else:
        lkey = left[:, [left_attrs.index(a) for a in common]]
        rkey = right[:, [right_attrs.index(a) for a in common]]
        # Group right rows by key.
        buckets: dict[tuple, list[int]] = {}
        for i, row in enumerate(map(tuple, rkey)):
            buckets.setdefault(row, []).append(i)
        li_list, ri_list = [], []
        for i, row in enumerate(map(tuple, lkey)):
            for j in buckets.get(row, ()):
                li_list.append(i)
                ri_list.append(j)
        if not li_list:
            return np.zeros((0, len(out_attrs)), dtype=np.int64), out_attrs
        li, ri = np.asarray(li_list), np.asarray(ri_list)
    extra = [right_attrs.index(a) for a in right_attrs if a not in common]
    rows = np.concatenate([left[li], right[ri][:, extra].reshape(len(ri), -1)], axis=1)
    return rows.astype(np.int64), out_attrs


def reference_join(query: JoinQuery, data: Mapping[str, np.ndarray]) -> np.ndarray:
    """Full natural multiway join; columns ordered as `query.attributes`."""
    rels = list(query.relations)
    acc, attrs = data[rels[0].name].astype(np.int64), tuple(rels[0].attrs)
    for rel in rels[1:]:
        acc, attrs = join_two(acc, attrs, data[rel.name].astype(np.int64), tuple(rel.attrs))
    order = [attrs.index(a) for a in query.attributes]
    out = acc[:, order]
    # Canonical row order for multiset comparison.
    if len(out):
        out = out[np.lexsort(out.T[::-1])]
    return out


def canonical(rows: np.ndarray) -> np.ndarray:
    """Sort rows lexicographically (multiset-comparable form)."""
    rows = np.asarray(rows, dtype=np.int64)
    if len(rows) == 0:
        return rows
    return rows[np.lexsort(rows.T[::-1])]
