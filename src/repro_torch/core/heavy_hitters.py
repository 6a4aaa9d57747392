"""Heavy-hitter detection (paper §1, §3).

A value b of join attribute X is a heavy hitter (HH) when its frequency in some
relation containing X is at least `threshold_frac` of that relation's size —
frequent enough that a single reducer handling all of b's tuples would be
overloaded.  The default fraction 1/k mirrors the systems the paper cites
(Pig/Hive identify values exceeding a per-reducer quota).

Two detectors:
  * `exact_heavy_hitters`   — full histogram (numpy), used by the planner.
  * `MisraGries`            — mergeable streaming sketch with the classical
                              guarantee count_err ≤ N/m, used by the sharded
                              data pipeline where a full pass is too expensive.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Mapping

import numpy as np

from .plan import JoinQuery


@dataclass(frozen=True)
class HHSet:
    """Heavy hitters per attribute: attr -> sorted tuple of HH values."""

    per_attr: Mapping[str, tuple[int, ...]]

    def attrs_with_hh(self) -> tuple[str, ...]:
        return tuple(a for a, v in self.per_attr.items() if v)

    def values(self, attr: str) -> tuple[int, ...]:
        return self.per_attr.get(attr, ())

    def total(self) -> int:
        return sum(len(v) for v in self.per_attr.values())


def exact_heavy_hitters(
    data: Mapping[str, np.ndarray],
    query: JoinQuery,
    k: int,
    threshold_factor: float = 1.0,
    max_hh_per_attr: int = 64,
) -> HHSet:
    """Exact HH detection over column-store data.

    `data[rel]` is an (n_tuples, arity) int array matching `rel.attrs` order.
    A value is a HH for attribute X if, in some relation R containing X, its
    count ≥ threshold_factor · |R| / k.  At most `max_hh_per_attr` heaviest
    values are kept per attribute (residual-join count is exponential in HH
    count per *co-skewed* attribute; the tail is rarely worth a residual).
    """
    out: dict[str, tuple[int, ...]] = {}
    for attr in query.join_attributes():
        counts: dict[int, int] = {}
        for rel in query.relations_with(attr):
            arr = data[rel.name]
            if arr.size == 0:
                continue
            col = arr[:, rel.attrs.index(attr)]
            thresh = max(1.0, threshold_factor * len(col) / k)
            vals, cnts = np.unique(col, return_counts=True)
            for v, c in zip(vals[cnts >= thresh], cnts[cnts >= thresh]):
                counts[int(v)] = max(counts.get(int(v), 0), int(c))
        hh = sorted(counts, key=lambda v: (-counts[v], v))[:max_hh_per_attr]
        out[attr] = tuple(sorted(hh))
    return HHSet(out)


def _reduce_counters(cs: dict[int, int], m: int) -> dict[int, int]:
    """Decrement a counter dict until at most m survivors remain.

    One round subtracts the (m+1)-th largest count from everything and keeps
    the strictly positive remainder — at least one counter (the cut itself)
    hits zero, so each round strictly shrinks the dict.  A single round is the
    classical merge reduction, but when several counts TIE at the cut the
    survivors {c : c > cut} can still number more than m (zeros of the tie all
    die, yet distinct larger counts may exceed m when the cut is 0 after an
    earlier subtraction) — so loop until the invariant len ≤ m holds, with the
    cut floored at 1 to guarantee progress even on all-equal counts.

    Error accounting (why the N/m guarantee survives): every round subtracts
    `cut` from AT LEAST m+1 counters (the m survivors' upper bound plus the
    dying ones), so the total weight removed is ≥ cut·(m+1).  Weight removed
    over the sketch's lifetime cannot exceed the weight inserted, N, hence
    Σ cut_r ≤ N/(m+1) < N/m — any single value is under-counted by at most
    Σ cut_r, which keeps true_count − N/m ≤ estimate ≤ true_count.
    """
    while len(cs) > m:
        cut = max(1, sorted(cs.values(), reverse=True)[m])
        cs = {v: c - cut for v, c in cs.items() if c > cut}
    return cs


@dataclass
class MisraGries:
    """Misra–Gries frequent-items sketch with m counters.

    Guarantee: for every value v, true_count - N/m ≤ estimate(v) ≤ true_count,
    where N is the total weight seen.  Sketches over disjoint shards merge by
    summing counters then decrementing back down to m survivors, preserving the
    guarantee with N = Σ N_shard (`_reduce_counters` carries the argument).
    """

    m: int
    counters: dict[int, int] = field(default_factory=dict)
    n_seen: int = 0

    def update(self, xs: Iterable[int]) -> None:
        for x in np.asarray(list(xs)).ravel():
            x = int(x)
            self.n_seen += 1
            if x in self.counters:
                self.counters[x] += 1
            elif len(self.counters) < self.m:
                self.counters[x] = 1
            else:
                dead = []
                for key in self.counters:
                    self.counters[key] -= 1
                    if self.counters[key] == 0:
                        dead.append(key)
                for key in dead:
                    del self.counters[key]

    def update_counts(self, values: Iterable[int],
                      counts: Iterable[int]) -> None:
        """Weighted batch update: absorb an exact (value, count) histogram.

        Equivalent (up to the guarantee) to `update` over the expanded stream
        but O(distinct) — the adaptive loop feeds whole batch columns through
        one `np.unique` per batch instead of per-row Python.  An exact
        histogram is an error-free sketch, so this is a merge: add the
        weights, then reduce back to m survivors.
        """
        for v, c in zip(np.asarray(list(values)).ravel(),
                        np.asarray(list(counts)).ravel()):
            c = int(c)
            if c <= 0:
                continue
            v = int(v)
            self.n_seen += c
            self.counters[v] = self.counters.get(v, 0) + c
        self.counters = _reduce_counters(self.counters, self.m)

    def estimate(self, x: int) -> int:
        return self.counters.get(int(x), 0)

    def merge(self, other: "MisraGries") -> "MisraGries":
        """Combine two shard sketches (Agarwal et al.'s mergeability).

        The merged sketch keeps the weaker (smaller-m) guarantee of the two;
        `_reduce_counters` handles count ties at the cut, so the result always
        has ≤ min(m) survivors."""
        merged = MisraGries(min(self.m, other.m))
        merged.n_seen = self.n_seen + other.n_seen
        cs = dict(self.counters)
        for v, c in other.counters.items():
            cs[v] = cs.get(v, 0) + c
        merged.counters = _reduce_counters(cs, merged.m)
        return merged

    def heavy_hitters(self, n_total: int, frac: float) -> tuple[int, ...]:
        """Values that MAY exceed frac·n_total (no false negatives)."""
        floor = frac * n_total - n_total / self.m
        return tuple(sorted(v for v, c in self.counters.items() if c > floor))

    def certain_heavy_hitters(self, frac: float) -> tuple[int, ...]:
        """Values whose SKETCH count alone exceeds frac·n_seen.

        Counters only ever under-count, so each of these is a TRUE heavy
        hitter (no false positives) — the dual of `heavy_hitters`'s
        no-false-negative candidate set.  The drift detector uses this as its
        definite new-heavy-hitter trigger: a replan fires only on values the
        sketch can prove, never on slack."""
        return tuple(sorted(v for v, c in self.counters.items()
                            if c > frac * self.n_seen))
