"""The drifting stream of the adaptation tests (tests/test_torch_adapt_*
and the card's), torch-only: `tests/test_adapt.py`'s cell (two_way,
1,024 rows a relation, heavy hitter B = 0 of 128 rows, a tail of 128
values, k = 32 on 8 devices) and its hot sets; and the engine tests' pair
of requests whose second fills a combination the first's plan pruned."""
from collections import defaultdict

import numpy as np

from repro_torch.core import plan_skew_join, two_way
from repro_torch.data import drifting_join_batch

N, HH_ROWS, DOM, K_PLAN = 1024, 128, 128, 32
NHOT, BONUS = 6, 24
CAP_OUT = 65536
E2E_POL = dict(replace_threshold=0.02, replan_threshold=0.07, window=4,
               patience=2, min_batches=2, replace_cooldown=2,
               replan_cooldown=4, sketch_counters=64)


def drift_batch(hot, seed, **kw):
    return drifting_join_batch(two_way(), N, HH_ROWS, DOM, hot, BONUS,
                               seed=seed, **kw)


def hot_sets():
    """Hot tail values grouped by the cell slice they route to, so moving
    the hot set provably moves cell load (hash collisions could otherwise
    cancel the drift)."""
    q = two_way()
    base = drifting_join_batch(q, N, HH_ROWS, DOM, [], 0, seed=0)
    plan = plan_skew_join(q, base, K_PLAN)
    assert dict(plan.hhs.per_attr) == {"B": (0,)}
    vals = np.arange(2, DOM + 2, dtype=np.int64)
    ridx, dest = plan.route_relation(
        "R", np.stack([np.zeros_like(vals), vals], axis=1))
    per_val = defaultdict(set)
    for r, d in zip(ridx, dest):
        per_val[int(vals[r])].add(int(d))
    by_slice = defaultdict(list)
    for v, ds in sorted(per_val.items()):
        by_slice[tuple(sorted(ds))].append(v - 2)
    slices = [vs for _, vs in sorted(by_slice.items())]
    return [vs[0] for vs in slices[:NHOT]], [vs[0] for vs in slices[-NHOT:]]


HOT_A, HOT_B = hot_sets()
HOT_MILD = HOT_A[:-2] + HOT_B[:2]


def pruned_pair():
    """Two requests of one two_way tenant: in the first, B = 7 is a heavy
    hitter of R (100 of 500 rows, over the 500 / 8 threshold) that S lacks,
    so the plan prunes the combination B = 7; the second adds 20 rows of
    B = 7 to S, 2,000 joined rows in that combination."""
    rng = np.random.default_rng(0)

    def rel(n, hot):
        b = np.concatenate([rng.integers(1000, 2000, n), np.full(hot, 7)])
        return np.stack([rng.integers(0, 1 << 20, n + hot), b], 1)

    r, s = rel(400, 100), rel(400, 0)[:, ::-1].copy()
    s2 = np.concatenate([s, np.stack([rng.integers(0, 1 << 20, 20),
                                      np.full(20, 7)], 1)[:, ::-1]])
    return {"R": r, "S": s}, {"R": r, "S": s2}
