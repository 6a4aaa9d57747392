"""End-to-end SkewShares planner — the paper's algorithm, assembled.

Given (query, data, k):
  1. detect heavy hitters per join attribute            (§1, heavy_hitters.py)
  2. enumerate residual joins + restricted sizes        (§3, residual.py)
  3. per residual join: freeze HH attrs, dominance-
     simplify, build the cost expression                (§4–5, cost/dominance)
  4. allocate k_i reducers per residual (Σ k_i ≤ k) and
     optimize shares within each                         (§2.1, shares.py)
  5. emit a routable plan: one Hypercube per residual.

The k_i allocation is greedy doubling on the convex per-residual cost curves
C_i(k_i) (each evaluation is itself a Shares optimization), which matches the
paper's objective 'minimize Σ_i C_i subject to Σ k_i = k'.  Ties — doublings
with zero communication benefit, e.g. a residual whose budget is absorbed by an
every-relation attribute — are broken toward the residual with the highest
per-reducer load, which is what balances the reduce phase.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import TYPE_CHECKING, Mapping

import numpy as np

if TYPE_CHECKING:  # placement imports skewjoin's plan types in docs only
    from .placement import CellPlacement

from .cost import naive_hh_cost
from .heavy_hitters import HHSet, exact_heavy_hitters
from .hypercube import Hypercube
from .plan import JoinQuery
from .residual import (ResidualJoin, decompose, enumerate_combinations,
                       residual_sizes, tuple_mask)
from .shares import SharesSolution, optimize_shares_expr


@dataclass(frozen=True)
class ResidualPlan:
    residual: ResidualJoin
    k_i: int
    solution: SharesSolution
    cube: Hypercube

    @property
    def cost(self) -> float:
        return self.solution.cost

    @property
    def total_input(self) -> float:
        return sum(t.size for t in self.residual.expr.terms)


@dataclass(frozen=True)
class SkewJoinPlan:
    query: JoinQuery
    hhs: HHSet
    residuals: tuple[ResidualPlan, ...]
    k: int

    @property
    def total_cost(self) -> float:
        return sum(r.cost for r in self.residuals)

    @property
    def reducers_used(self) -> int:
        return min(self.k, sum(r.cube.n_cells for r in self.residuals))

    def route_relation(self, rel_name: str, arr: np.ndarray,
                       hhs_data: Mapping[str, np.ndarray] | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Route every row of one relation through every matching residual.

        Returns (row_idx, reducer_id) concatenated over residual joins.  A row
        participates in residual J_i iff it satisfies J_i's type constraints
        (paper Example 3.2's dispatch rules).  Cell ids wrap modulo k: when
        there are more residual cells than k, blocks share LOGICAL cells
        (exact, given the executor's logical-cell join keying); folding the k
        logical cells onto fewer devices is `core.placement`'s job.
        """
        rel = self.query.relation(rel_name)
        rows, dests = [], []
        for rp in self.residuals:
            mask = tuple_mask(rel.attrs, arr, rp.residual.combo, self.hhs)
            if not mask.any():
                continue
            sub_idx = np.nonzero(mask)[0]
            r, d = rp.cube.route(rel.attrs, arr[sub_idx])
            rows.append(sub_idx[r])
            dests.append(d % self.k)
        if not rows:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(rows), np.concatenate(dests)

    def cell_loads(self, data: Mapping[str, np.ndarray]) -> np.ndarray:
        """#routed tuple copies landing on each of the k LOGICAL cells.

        One `np.bincount` over the concatenated destinations — not a
        per-relation `np.add.at` scatter loop.  This is the load estimate
        `core.placement.lpt_placement` bin-packs onto physical devices."""
        dests = [self.route_relation(rel.name, data[rel.name])[1]
                 for rel in self.query.relations]
        dest = (np.concatenate(dests) if dests
                else np.zeros(0, np.int64))
        return np.bincount(dest, minlength=self.k).astype(np.int64)

    def reducer_loads(self, data: Mapping[str, np.ndarray],
                      placement: "CellPlacement | None" = None) -> np.ndarray:
        """Per-reducer input loads (balance metric).

        Without a placement: the k logical cells ARE the reducers (one cell
        per device, the pre-folding view).  With a `CellPlacement`: loads are
        folded through its table and the result is per PHYSICAL device —
        the quantity the reduce-phase makespan actually depends on."""
        loads = self.cell_loads(data)
        if placement is None:
            return loads
        return placement.device_loads(loads).astype(np.int64)

    def shuffle_capacity(self, rel_name: str, sharded: np.ndarray,
                         n_devices: int,
                         placement: "CellPlacement | None" = None) -> int:
        """Worst per-(source device, destination device) routed-copy count for
        one device-sharded relation (rows split into `n_devices` contiguous
        blocks; -1 rows are padding).  This is the capacity hook: the
        host-side oracle for the executor session's on-device
        capacity pass — `ExecutorSession.prepare` derives its per-relation
        shuffle capacities as ceil(this · capacity_factor).

        `placement` folds logical cells onto devices first (destinations are
        then physical, stride n_devices); without one, destinations stay
        LOGICAL cells in [0, k) (stride k) — correct for any k, and identical
        to the physical view when k == n_devices."""
        per_dev = max(len(sharded) // n_devices, 1)
        valid_idx = np.nonzero(sharded[:, 0] != -1)[0]
        if not len(valid_idx):
            return 1
        ridx, dest = self.route_relation(rel_name, sharded[valid_idx])
        if not len(dest):
            return 1
        n_dest = self.k
        if placement is not None:
            dest = placement.table[dest]
            n_dest = n_devices
        dev = valid_idx[ridx] // per_dev
        counts = np.bincount(dev * n_dest + dest,
                             minlength=n_devices * n_dest)
        return max(1, int(counts.max()))


# The greedy doubling below re-evaluates identical (expr, k_i) pairs every
# round (the sort re-ranks ALL residuals each time one is doubled), and
# plan_skew_join / plan_no_skew often share sub-expressions — so Shares
# solutions are memoized process-wide.  CostExpression is a frozen dataclass
# of tuples/frozensets, hence hashable; solutions are immutable in practice.
_optimize_shares_cached = functools.lru_cache(maxsize=4096)(optimize_shares_expr)


def _allocate_budget(residuals: list[ResidualJoin], k: int
                     ) -> list[tuple[ResidualJoin, int, SharesSolution]]:
    """Greedy-doubling allocation of k reducers across residual joins.

    Communication cost C_i(k_i) is monotone *increasing* in k_i (more cells ⇒
    more replication), so minimizing Σ C_i alone degenerates to k_i = 1 and no
    parallelism — the skew the paper sets out to kill.  The objective that
    matches the paper's motivation is the reduce-phase makespan: the largest
    per-reducer delivered load, load_i = C_i(k_i)/k_i, which the Shares split
    makes uniform within a residual block.  We greedily double the k_i of the
    residual with the highest per-cell load until the budget is spent;
    communication-minimality lives *inside* each residual via the Shares
    optimizer, exactly as in §2.1.
    """
    n = len(residuals)
    if n == 0:
        return []
    if n > 64 * k:
        raise ValueError(
            f"{n} residual joins vastly exceeds k={k} reducers; lower "
            f"max_hh_per_attr or raise the HH threshold")
    k_i = [1] * n
    sols: list[SharesSolution] = [_optimize_shares_cached(r.expr, 1)
                                  for r in residuals]
    while True:
        budget = k - sum(k_i)
        # Double the residual with the highest per-cell load that still fits.
        order = sorted(range(n), key=lambda i: sols[i].cost / k_i[i], reverse=True)
        doubled = False
        for i in order:
            if k_i[i] > budget:
                continue
            nxt = _optimize_shares_cached(residuals[i].expr, 2 * k_i[i])
            if nxt.cost / (2 * k_i[i]) >= sols[i].cost / k_i[i] - 1e-12:
                continue    # doubling doesn't reduce this block's per-cell load
            k_i[i] *= 2
            sols[i] = nxt
            doubled = True
            break
        if not doubled:
            break
    return list(zip(residuals, k_i, sols))


def plan_from_hhs(
    query: JoinQuery,
    data: Mapping[str, np.ndarray],
    k: int,
    hhs: HHSet,
) -> SkewJoinPlan:
    """Assemble the SkewShares plan from an EXTERNALLY supplied HH set.

    The planner's steps 2–5 (residual sizes, decomposition, k_i allocation,
    Hypercube assembly) with step 1 — HH detection — factored out: the exact
    planner hands in its histogram HHs (`plan_skew_join`), the online
    adaptation loop (core/adapt.py) hands in the windowed Misra–Gries
    sketch's set and a recent batch as the size sample.  Residual sizes
    depend on the data ONLY through per-attribute HH membership counts, so
    two datasets with the same HH set and the same per-type-combination row
    counts yield structurally identical plans — route specs and all — which
    is what lets a drift-triggered re-plan land on an already-compiled
    executor (a serving layer can key its plan cache on the route specs)."""
    sizes = {c: residual_sizes(data, query, c, hhs)
             for c in enumerate_combinations(hhs)}
    residuals = decompose(query, hhs, sizes)
    allocated = _allocate_budget(residuals, k)
    plans, offset = [], 0
    for salt, (res, ki, sol) in enumerate(allocated):
        order = tuple(res.expr.free_attrs)
        shares = tuple(sol.shares.get(a, 1) for a in order)
        # Offsets are cumulative in LOGICAL cell space (globally unique per
        # residual block); routing wraps them modulo k, and core.placement
        # folds the k wrapped cells onto the physical devices.  Correctness
        # with shared cells comes from the executor's logical-cell tagging:
        # tuples only join within one logical cell.
        cube = Hypercube(order, shares, offset=offset, salt=salt)
        plans.append(ResidualPlan(res, ki, sol, cube))
        offset += cube.n_cells
    return SkewJoinPlan(query, hhs, tuple(plans), k)


def plan_skew_join(
    query: JoinQuery,
    data: Mapping[str, np.ndarray],
    k: int,
    threshold_factor: float = 1.0,
    max_hh_per_attr: int = 64,
) -> SkewJoinPlan:
    """Full SkewShares plan for `query` over `data` with `k` reducers."""
    hhs = exact_heavy_hitters(data, query, k, threshold_factor, max_hh_per_attr)
    return plan_from_hhs(query, data, k, hhs)


def pruned_combos(plan: SkewJoinPlan
                  ) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """The plan's sorted HH values per attribute, and the type combinations
    it pruned (some relation had no row of them in the data it was planned
    on) as a (combinations, attributes) array of codes, the attributes in
    the dict's order: 0 for ordinary, else 1 + the value's rank among the
    attribute's HH values."""
    hh = {a: np.sort(np.asarray(plan.hhs.values(a), np.int64))
          for a in plan.query.join_attributes() if plan.hhs.values(a)}
    if not hh:                  # one combination, pruned iff unplanned
        return hh, np.zeros((0 if plan.residuals else 1, 0), np.int64)
    dims = [len(v) + 1 for v in hh.values()]
    kept = [[1 + int(np.searchsorted(v, rp.residual.combo.as_dict[a]))
             if a in rp.residual.combo.as_dict else 0 for a, v in hh.items()]
            for rp in plan.residuals]
    kept = np.ravel_multi_index(
        np.array(kept, np.int64).reshape(-1, len(hh)).T, dims)
    pruned = np.setdiff1d(np.arange(int(np.prod(dims))), kept)
    return hh, np.stack(np.unravel_index(pruned, dims), 1)


def fills_pruned(query: JoinQuery, data: Mapping[str, np.ndarray],
                 hh: Mapping[str, np.ndarray], pruned: np.ndarray) -> bool:
    """Whether every relation of `data` has rows in one of the `pruned`
    combinations: rows the plan has no residual join for, which its
    routing would drop."""
    fills = np.ones(len(pruned), bool)
    order = list(hh)
    for rel in query.relations:
        arr = np.asarray(data[rel.name])
        attrs = [a for a in rel.attrs if a in hh]
        if not attrs:
            fills &= len(arr) > 0
            continue
        dims = [len(hh[a]) + 1 for a in attrs]
        codes = []
        for a in attrs:
            col = arr[:, rel.attrs.index(a)].astype(np.int64)
            idx = np.searchsorted(hh[a], col)
            hit = hh[a][np.minimum(idx, len(hh[a]) - 1)] == col
            codes.append(np.where(hit, idx + 1, 0))
        seen = np.unique(np.ravel_multi_index(codes, dims))
        want = pruned[:, [order.index(a) for a in attrs]].T
        fills &= np.isin(np.ravel_multi_index(want, dims), seen)
    return bool(fills.any())


def plan_no_skew(query: JoinQuery, data: Mapping[str, np.ndarray], k: int
                 ) -> SkewJoinPlan:
    """Plain Shares plan (no HH handling) — the paper's baseline strawman."""
    hhs = HHSet({a: () for a in query.join_attributes()})
    return plan_from_hhs(query, data, k, hhs)


def naive_two_way_cost(data: Mapping[str, np.ndarray], query: JoinQuery,
                       k: int, hhs: HHSet) -> float:
    """Example 1.1 baseline for 2-way joins: per HH, partition big / broadcast small."""
    (rel_r, rel_s) = query.relations
    join_attr = [a for a in rel_r.attrs if rel_s.has(a)][0]
    cost = 0.0
    r_col = data[rel_r.name][:, rel_r.attrs.index(join_attr)]
    s_col = data[rel_s.name][:, rel_s.attrs.index(join_attr)]
    hh_vals = np.asarray(hhs.values(join_attr))
    for b in hh_vals:
        cost += naive_hh_cost(float((r_col == b).sum()), float((s_col == b).sum()), k)
    # Non-HH tuples: one reducer per key, each tuple sent once.
    cost += float((~np.isin(r_col, hh_vals)).sum())
    cost += float((~np.isin(s_col, hh_vals)).sum())
    return cost
