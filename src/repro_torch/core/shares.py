"""The Shares optimizer (paper §2, following Afrati & Ullman TKDE'11 [3]).

Minimize  C(x) = Σ_j r_j · ∏_{X_i ∈ F_j} x_i   subject to  ∏_i x_i = k, x_i ≥ 1,
where F_j = free attributes not in relation R_j.

With x_i = e^{y_i} this is a geometric program: minimize a posynomial under a
linear equality — convex in y.  We solve the continuous problem with projected
gradient descent on the scaled simplex {Σ y_i = ln k, y ≥ 0}, then round to
*integer power-of-two* shares whose product is exactly k (mesh axes are powers
of two).  Rounding is exact (enumeration over compositions of log2 k) when the
search space is small, greedy-with-local-swaps otherwise; `tests/test_shares.py`
checks both against brute force.

Attributes appearing in every relation occur in no cost term, so their share is
"free" parallelism — the solver correctly pushes budget there (e.g. the join
attribute B of R(A,B) ⋈ S(B,C) absorbs all of k in the no-skew residual).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Mapping

import numpy as np

from .cost import CostExpression, cost_expression
from .plan import JoinQuery

_MAX_EXACT_ENUM = 200_000


@dataclass(frozen=True)
class SharesSolution:
    shares: dict[str, int]         # integer shares for EVERY attribute (1 for frozen/dominated)
    cont_shares: dict[str, float]  # continuous optimum over the free attributes
    cost: float                    # cost of the integer solution
    cont_cost: float               # cost of the continuous optimum (lower bound)
    k: int
    expr: CostExpression

    @property
    def reducers_used(self) -> int:
        out = 1
        for v in self.shares.values():
            out *= v
        return out


# ---------------------------------------------------------------------------
# Continuous solve (convex, projected gradient on the simplex Σy = ln k).
# ---------------------------------------------------------------------------

def _project_simplex(y: np.ndarray, total: float) -> np.ndarray:
    """Euclidean projection of y onto {y ≥ 0, Σ y = total}."""
    n = y.size
    u = np.sort(y)[::-1]
    css = np.cumsum(u) - total
    idx = np.arange(1, n + 1)
    cond = u - css / idx > 0
    rho = int(np.nonzero(cond)[0][-1]) + 1
    theta = css[rho - 1] / rho
    return np.maximum(y - theta, 0.0)


def solve_continuous(expr: CostExpression, k: int, iters: int = 2000) -> dict[str, float]:
    """Continuous optimal shares (≥1, product=k) for `expr.free_attrs`."""
    attrs = list(expr.free_attrs)
    n = len(attrs)
    if n == 0 or k <= 1:
        return {a: 1.0 for a in attrs}
    aidx = {a: i for i, a in enumerate(attrs)}
    # Term matrix: M[j, i] = 1 iff attr i multiplies term j.
    sizes = np.array([max(t.size, 0.0) for t in expr.terms])
    scale = sizes.max() if sizes.max() > 0 else 1.0
    sizes = sizes / scale
    M = np.zeros((len(expr.terms), n))
    for j, t in enumerate(expr.terms):
        for a in t.repl_attrs:
            M[j, aidx[a]] = 1.0

    total = math.log(k)
    y = np.full(n, total / n)
    lr = 0.5
    fy_prev = None
    for _ in range(iters):
        tvals = sizes * np.exp(M @ y)          # value of each term
        grad = M.T @ tvals                     # ∂f/∂y_i
        fy = tvals.sum()
        # Backtracking step on the projected path.
        step = lr
        for _bt in range(30):
            y_new = _project_simplex(y - step * grad / (np.abs(grad).max() + 1e-30), total)
            f_new = (sizes * np.exp(M @ y_new)).sum()
            if f_new <= fy:
                break
            step *= 0.5
        if np.allclose(y_new, y, atol=1e-12) or (
                fy_prev is not None and abs(fy_prev - f_new) < 1e-15 * max(1.0, fy_prev)):
            y = y_new
            break
        y, fy_prev = y_new, f_new
    return {a: float(math.exp(y[aidx[a]])) for a in attrs}


# ---------------------------------------------------------------------------
# Integer (power-of-two) rounding:  shares = 2^{e_i},  Σ e_i = log2 k.
# ---------------------------------------------------------------------------

def _cost_pow2(expr: CostExpression, exps: Mapping[str, int]) -> float:
    return expr.evaluate({a: float(1 << e) for a, e in exps.items()})


def _enum_count(units: int, parts: int) -> int:
    return math.comb(units + parts - 1, parts - 1) if parts > 0 else (1 if units == 0 else 0)


def _exact_pow2(expr: CostExpression, units: int) -> dict[str, int]:
    attrs = list(expr.free_attrs)
    best, best_cost = None, math.inf
    for cuts in itertools.combinations(range(units + len(attrs) - 1), len(attrs) - 1):
        exps, prev = {}, -1
        alloc = []
        for c in cuts:
            alloc.append(c - prev - 1)
            prev = c
        alloc.append(units + len(attrs) - 2 - prev)
        exps = dict(zip(attrs, alloc))
        c = _cost_pow2(expr, exps)
        if c < best_cost:
            best, best_cost = exps, c
    return best or {a: 0 for a in attrs}


def _greedy_pow2(expr: CostExpression, units: int, cont: Mapping[str, float]) -> dict[str, int]:
    attrs = list(expr.free_attrs)
    # Seed from the continuous solution (floor of log2), then greedy top-up.
    exps = {a: max(0, int(math.floor(math.log2(max(cont.get(a, 1.0), 1.0)) + 1e-9))) for a in attrs}
    while sum(exps.values()) > units:           # floor overshoot (rare)
        a = max(attrs, key=lambda a: exps[a])
        exps[a] -= 1
    while sum(exps.values()) < units:
        best_a, best_c = None, math.inf
        for a in attrs:
            exps[a] += 1
            c = _cost_pow2(expr, exps)
            exps[a] -= 1
            if c < best_c:
                best_a, best_c = a, c
        exps[best_a] += 1
    # Local improvement: move one unit between attributes while it helps.
    improved = True
    while improved:
        improved = False
        cur = _cost_pow2(expr, exps)
        for a, b in itertools.permutations(attrs, 2):
            if exps[a] == 0:
                continue
            exps[a] -= 1
            exps[b] += 1
            c = _cost_pow2(expr, exps)
            if c < cur - 1e-12:
                cur, improved = c, True
            else:
                exps[a] += 1
                exps[b] -= 1
    return exps


def round_pow2(expr: CostExpression, k: int, cont: Mapping[str, float]) -> dict[str, int]:
    """Integer power-of-two shares with ∏ = k exactly (k must be a power of 2)."""
    if k & (k - 1):
        raise ValueError(f"k={k} is not a power of two")
    units = k.bit_length() - 1
    attrs = list(expr.free_attrs)
    if not attrs:
        return {}
    if _enum_count(units, len(attrs)) <= _MAX_EXACT_ENUM:
        exps = _exact_pow2(expr, units)
    else:
        exps = _greedy_pow2(expr, units, cont)
    return {a: 1 << e for a, e in exps.items()}


# ---------------------------------------------------------------------------
# Public entry points.
# ---------------------------------------------------------------------------

def optimize_shares_expr(expr: CostExpression, k: int) -> SharesSolution:
    cont = solve_continuous(expr, k)
    cont_cost = expr.evaluate(cont)
    ints = round_pow2(expr, k, cont)
    cost = expr.evaluate({a: float(v) for a, v in ints.items()})
    return SharesSolution(dict(ints), cont, cost, cont_cost, k, expr)


def optimize_shares(
    query: JoinQuery,
    k: int,
    frozen: frozenset[str] = frozenset(),
) -> SharesSolution:
    """Optimal shares for `query` with `frozen` attributes forced to share 1.

    The returned `shares` dict covers every attribute of the query (frozen and
    dominated attributes map to 1), ready for the hypercube router.
    """
    expr = cost_expression(query, frozen)
    sol = optimize_shares_expr(expr, k)
    shares = {a: 1 for a in query.attributes}
    shares.update(sol.shares)
    return SharesSolution(shares, sol.cont_shares, sol.cost, sol.cont_cost, k, expr)


def brute_force_shares(expr: CostExpression, k: int) -> tuple[dict[str, int], float]:
    """Exact integer-share optimum over ALL integer factorizations of k (tests only)."""
    attrs = list(expr.free_attrs)
    if not attrs:
        return {}, expr.evaluate({})

    def divisors(n: int) -> list[int]:
        return [d for d in range(1, n + 1) if n % d == 0]

    best, best_cost = None, math.inf

    def rec(i: int, rem: int, cur: dict[str, int]):
        nonlocal best, best_cost
        if i == len(attrs) - 1:
            cur[attrs[i]] = rem
            c = expr.evaluate({a: float(v) for a, v in cur.items()})
            if c < best_cost:
                best, best_cost = dict(cur), c
            return
        for d in divisors(rem):
            cur[attrs[i]] = d
            rec(i + 1, rem // d, cur)

    rec(0, k, {})
    return best, best_cost
