"""Synthetic skewed relations — the workload generator for every join benchmark.

Columns are drawn either uniformly or zipf-distributed (the classical skew
model: value rank v has probability ∝ v^-alpha), so a handful of values become
heavy hitters exactly as in the paper's motivating scenario.
"""
from __future__ import annotations

from typing import Iterator, Mapping, Sequence

import numpy as np

from ..core.plan import JoinQuery, Relation, running_example, two_way


def zipf_column(rng: np.random.Generator, n: int, domain: int,
                alpha: float = 0.0) -> np.ndarray:
    """n samples over [0, domain); alpha=0 -> uniform, larger -> more skewed."""
    if alpha <= 0:
        return rng.integers(0, domain, size=n, dtype=np.int64)
    ranks = np.arange(1, domain + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    p /= p.sum()
    return rng.choice(domain, size=n, p=p).astype(np.int64)


def skewed_relation(
    rng: np.random.Generator,
    attrs: Sequence[str],
    n: int,
    domain: int,
    skew: Mapping[str, float] | None = None,
) -> np.ndarray:
    """(n, arity) relation; per-attribute zipf exponents via `skew[attr]`."""
    skew = skew or {}
    cols = [zipf_column(rng, n, domain, skew.get(a, 0.0)) for a in attrs]
    return np.stack(cols, axis=1)


def drifting_join_batch(
    query: JoinQuery,
    n: int,
    hh_rows: int,
    tail_domain: int,
    hot_set: Sequence[int],
    hot_bonus: int,
    seed: int = 0,
    extra_hh: Mapping[str, int] | None = None,
) -> dict[str, np.ndarray]:
    """One deterministic batch of a drifting stream, combos pinned by design.

    Join attributes get `hh_rows` rows of the heavy value 0 plus exactly
    n - hh_rows tail rows over values 1..tail_domain: every tail value
    carries a uniform base count, and the values in `hot_set` carry
    `hot_bonus` extra rows each (any remainder tops up the first tail
    values).  Moving `hot_set` between batches moves cell load — drift — but
    the per-value counts stay far below any HH threshold and the
    (HH rows, tail rows) split NEVER changes, so two batches with the same
    `extra_hh` yield byte-identical residual-join sizes and hence the SAME
    SkewShares plan (`plan_from_hhs`): the warm re-plan scenario the
    adaptive session's plan cache exists for.  `extra_hh[attr] = rows`
    promotes value 1 to a genuine second heavy hitter (carved out of the
    tail budget) — the honest-cold-replan scenario.  Non-join attributes
    cycle uniformly.  Fully deterministic given the arguments; `seed` only
    shuffles row order so batches are not sorted by value.
    """
    extra_hh = extra_hh or {}
    join_attrs = set(query.join_attributes())
    hot = sorted({int(v) for v in hot_set if 0 <= int(v) < tail_domain})
    rng = np.random.default_rng(seed)
    out = {}
    for rel in query.relations:
        cols = []
        for a in rel.attrs:
            if a not in join_attrs:
                cols.append(np.arange(n, dtype=np.int64) % max(tail_domain, 1))
                continue
            promo = int(extra_hh.get(a, 0))
            n_tail = n - hh_rows - promo - hot_bonus * len(hot)
            if n_tail < 0:
                raise ValueError(
                    f"hh_rows + extra_hh + hot bonus exceed n={n}")
            # Uniform base + largest-remainder top-up, then the hot bonus:
            # counts sum to n - hh_rows - promo exactly, deterministically.
            counts = np.full(tail_domain, n_tail // tail_domain, np.int64)
            counts[:n_tail % tail_domain] += 1
            counts[hot] += hot_bonus
            vals = np.concatenate([
                np.zeros(hh_rows, np.int64),
                np.full(promo, 1, np.int64),
                np.repeat(np.arange(tail_domain, dtype=np.int64) + 2, counts),
            ])
            cols.append(vals)
        arr = np.stack([c[:n] for c in cols], axis=1)
        out[rel.name] = arr[rng.permutation(n)]
    return out


def skewed_join_dataset(
    query: JoinQuery,
    n_per_relation: int | Mapping[str, int],
    domain: int,
    skew: Mapping[str, float] | None = None,
    seed: int = 0,
) -> dict[str, np.ndarray]:
    """One array per relation of `query`, shared attribute domains.

    Shared attributes use the same domain so the join is non-trivially
    selective; skewed attributes produce genuine heavy hitters.
    """
    rng = np.random.default_rng(seed)
    out = {}
    for rel in query.relations:
        n = n_per_relation if isinstance(n_per_relation, int) else n_per_relation[rel.name]
        out[rel.name] = skewed_relation(rng, rel.attrs, n, domain, skew)
    return out


def chain_query(width: int) -> JoinQuery:
    """An acyclic chain R0(X0,X1) ⋈ R1(X1,X2) ⋈ ... of `width` relations."""
    if width < 2:
        raise ValueError(f"chain needs ≥ 2 relations, got {width}")
    return JoinQuery(tuple(
        Relation(f"R{i}", (f"X{i}", f"X{i+1}")) for i in range(width)))


# The multi-tenant serving mix: ≥ 3 structurally distinct query
# shapes (2-way, the paper's 3-way running example, a 4-way chain), each with
# its own skew profile and a row-count cycle that exercises ≥ 2 shape
# buckets.  Domains and exponents are fixed per tenant so every request of a
# tenant yields the SAME SkewShares plan (stable HH set + residual sizes) —
# the steady-state zero-recompile contract is about shapes and capacities,
# not about replanning noise.
_WORKLOAD_TENANTS = (
    ("pairs", two_way(), {"B": 0.7}, 1500, (900, 1500)),
    ("chain3", running_example(), {"B": 0.6, "C": 0.6}, 1500, (700, 1100)),
    ("chain4", chain_query(4), {"X2": 0.7}, 2000, (500, 800)),
)


def mixed_workload(n_requests: int, seed: int = 0,
                   tenants=_WORKLOAD_TENANTS
                   ) -> Iterator[tuple[str, JoinQuery, dict[str, np.ndarray]]]:
    """Deterministic multi-tenant join-request stream for the serving bench.

    Yields `n_requests` tuples `(tenant, query, data)` round-robin across the
    tenant mix; request j of a tenant draws fresh rows (seeded by (seed,
    tenant, j) — no two requests share data) at the tenant's j-th cycled row
    count.  Same arguments → byte-identical stream, so benches and tests can
    replay warmup + steady phases exactly."""
    for j in range(n_requests):
        t = j % len(tenants)
        name, query, skew, domain, sizes = tenants[t]
        cycle = j // len(tenants)
        n_rows = sizes[cycle % len(sizes)]
        # str.hash is process-randomized; derive the per-request seed
        # arithmetically so replays are byte-identical across processes.
        req_seed = (seed * 1_000_003 + t * 10_007 + cycle) & 0x7FFFFFFF
        data = skewed_join_dataset(query, n_rows, domain, skew, seed=req_seed)
        yield name, query, data
