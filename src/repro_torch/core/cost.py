"""Communication-cost model (paper §2, §4, §5).

A cost expression is a posynomial Σ_j r_j · ∏_{X_i ∈ F_j} x_i where F_j is the
set of *free-share* attributes NOT appearing in relation R_j (replication axes
for R_j's tuples).  Frozen (HH-typed / auxiliary) and dominated attributes have
share 1 and simply drop out of the products — this file is where Theorem 5.1's
simplification becomes executable.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

from .dominance import free_share_attributes
from .plan import JoinQuery


@dataclass(frozen=True)
class CostTerm:
    """One relation's contribution: size × ∏ shares of `repl_attrs`."""

    relation: str
    size: float
    repl_attrs: frozenset[str]   # free attributes NOT in the relation

    def evaluate(self, shares: Mapping[str, float]) -> float:
        c = self.size
        for a in self.repl_attrs:
            c *= shares[a]
        return c

    def replication(self, shares: Mapping[str, float]) -> float:
        """Per-tuple fan-out for this relation under `shares`."""
        f = 1.0
        for a in self.repl_attrs:
            f *= shares[a]
        return f


@dataclass(frozen=True)
class CostExpression:
    """Σ of CostTerms over the relations of one (residual) join."""

    terms: tuple[CostTerm, ...]
    free_attrs: tuple[str, ...]     # attributes carrying a share variable

    def evaluate(self, shares: Mapping[str, float]) -> float:
        return sum(t.evaluate(shares) for t in self.terms)

    def __str__(self) -> str:
        def term(t: CostTerm) -> str:
            attrs = "".join(sorted(a.lower() for a in t.repl_attrs))
            return f"{t.relation.lower()}{attrs}"
        return " + ".join(term(t) for t in self.terms)


def cost_expression(
    query: JoinQuery,
    frozen: frozenset[str] = frozenset(),
    apply_dominance: bool = True,
) -> CostExpression:
    """Build the cost expression for `query` with `frozen` attributes' shares = 1.

    With `apply_dominance` (the default) dominated attributes are also dropped,
    per §5; without it you get the raw expression of §2 (useful for tests that
    reproduce the paper's 'before simplification' forms).
    """
    if apply_dominance:
        free = free_share_attributes(query, frozen)
    else:
        free = tuple(a for a in query.attributes if a not in frozen)
    free_set = frozenset(free)
    terms = []
    for r in query.relations:
        repl = free_set - frozenset(r.attrs)
        terms.append(CostTerm(r.name, float(r.size), repl))
    return CostExpression(tuple(terms), free)


# ---------------------------------------------------------------------------
# Analytic baselines used by the benchmarks (paper Examples 1.1 / 1.2).
# ---------------------------------------------------------------------------

def naive_hh_cost(r: float, s: float, k: int) -> float:
    """Example 1.1: partition the bigger side into k buckets, broadcast the other.

    Cost = max_side + k · min_side  (choose the cheaper orientation).
    """
    big, small = (r, s) if r >= s else (s, r)
    return big + k * small


def shares_hh_cost(r: float, s: float, k: int) -> float:
    """Example 1.2 optimum: min { r·y + s·x : x·y = k } = 2·√(k·r·s).

    (The paper prints this as √(2krs); the Lagrangean/AM-GM optimum of
    r·y + s·x subject to xy = k is 2√(krs), and the claimed comparison
    2√(krs) ≤ r + ks is exactly AM-GM on {r, ks}.  We implement — and the
    benchmarks verify numerically — the correct closed form.)
    """
    return 2.0 * (k * r * s) ** 0.5


def shares_hh_splits(r: float, s: float, k: int) -> tuple[float, float]:
    """Optimal continuous (x, y) for Example 1.2: x = √(kr/s), y = √(ks/r)."""
    return (k * r / s) ** 0.5, (k * s / r) ** 0.5
