"""Residual-join decomposition (paper §3–§5).

For each attribute X_i with p_i heavy hitters, the type set is
L_{X_i} = {T_-, T_{b_1}, …, T_{b_{p_i}}}.  A *type combination* C_T picks one
type per attribute; each C_T defines a residual join — the original join
restricted to the tuples matching the combination's constraints:

  * attribute of ordinary type  T_-  : exclude tuples where X = any HH of X,
  * attribute of type T_b            : keep only tuples with X = b.

Residual joins partition every relation's tuples, are pairwise disjoint in
output, and union to the original join.  Per §4/§5 (Theorem 5.1), the cost
expression of a residual join is the original expression with HH-typed
attributes' shares forced to 1 (they become auxiliary-attribute relations whose
shares collapse), and dominance is then recomputed among the free attributes.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Mapping

import numpy as np

from .cost import CostExpression, cost_expression
from .heavy_hitters import HHSet
from .plan import JoinQuery

ORDINARY = None  # the T_- type


@dataclass(frozen=True)
class TypeCombination:
    """attr -> HH value (T_b) for non-ordinary attrs; missing attr means T_-."""

    hh: tuple[tuple[str, int], ...]   # sorted ((attr, value), ...)

    @staticmethod
    def make(assign: Mapping[str, int]) -> "TypeCombination":
        return TypeCombination(tuple(sorted(assign.items())))

    @property
    def as_dict(self) -> dict[str, int]:
        return dict(self.hh)

    @property
    def frozen_attrs(self) -> frozenset[str]:
        return frozenset(a for a, _ in self.hh)

    def is_ordinary(self) -> bool:
        return not self.hh

    def __str__(self) -> str:
        if not self.hh:
            return "{all T_-}"
        return "{" + ", ".join(f"{a}={v}" for a, v in self.hh) + "}"


@dataclass(frozen=True)
class ResidualJoin:
    """One residual join: the original query on a type-restricted data subset."""

    combo: TypeCombination
    query: JoinQuery              # sizes = per-combination restricted sizes
    expr: CostExpression          # simplified cost expression (Thm 5.1 applied)

    @property
    def frozen_attrs(self) -> frozenset[str]:
        return self.combo.frozen_attrs


def enumerate_combinations(hhs: HHSet) -> list[TypeCombination]:
    """All elements of ∏_i L_{X_i} (ordinary-only combination first)."""
    attrs = [a for a in hhs.per_attr if hhs.values(a)]
    choices = [[ORDINARY, *hhs.values(a)] for a in attrs]
    combos = []
    for picks in itertools.product(*choices):
        assign = {a: v for a, v in zip(attrs, picks) if v is not ORDINARY}
        combos.append(TypeCombination.make(assign))
    # Deterministic order: ordinary combo first, then by #HH attrs, then value.
    combos.sort(key=lambda c: (len(c.hh), c.hh))
    return combos


def tuple_mask(
    rel_attrs: tuple[str, ...],
    arr: np.ndarray,
    combo: TypeCombination,
    hhs: HHSet,
) -> np.ndarray:
    """Boolean mask of `arr` rows that belong to residual join `combo`.

    A row belongs iff for every attribute X of the relation:
      * X ordinary in combo  -> row[X] is not any HH value of X,
      * X typed T_b in combo -> row[X] == b.
    Attributes not present in the relation impose no constraint on its rows.
    """
    mask = np.ones(len(arr), dtype=bool)
    assign = combo.as_dict
    for i, attr in enumerate(rel_attrs):
        hh_vals = hhs.values(attr)
        if not hh_vals:
            continue
        col = arr[:, i]
        if attr in assign:
            mask &= col == assign[attr]
        else:
            mask &= ~np.isin(col, np.asarray(hh_vals))
    return mask


def residual_sizes(
    data: Mapping[str, np.ndarray],
    query: JoinQuery,
    combo: TypeCombination,
    hhs: HHSet,
) -> dict[str, int]:
    """Per-relation contributing-tuple counts for one combination (paper §4 3b)."""
    return {
        r.name: int(tuple_mask(r.attrs, data[r.name], combo, hhs).sum())
        for r in query.relations
    }


def decompose(
    query: JoinQuery,
    hhs: HHSet,
    sizes: Mapping[TypeCombination, Mapping[str, int]] | None = None,
    drop_empty: bool = True,
) -> list[ResidualJoin]:
    """Build all residual joins.

    `sizes` maps each combination to per-relation restricted sizes (from
    `residual_sizes`); without it, symbolic sizes from `query` are kept for
    every combination (useful for tests that match the paper's expressions).
    With `drop_empty`, combinations where some relation contributes 0 tuples
    are pruned — their join is provably empty and deserves no reducers.
    """
    out = []
    for combo in enumerate_combinations(hhs):
        q = query
        if sizes is not None:
            sz = sizes[combo]
            if drop_empty and any(v == 0 for v in sz.values()):
                continue
            q = query.with_sizes(sz)
        expr = cost_expression(q, frozen=combo.frozen_attrs)
        out.append(ResidualJoin(combo, q, expr))
    return out
