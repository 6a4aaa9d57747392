"""Dominance relation over join attributes (paper §2 / §5).

Attribute A is *dominated* by attribute B iff B appears in every relation in
which A appears (and A ≠ B).  Dominated attributes get share 1 in the optimal
Shares solution, so they can be dropped from the optimization — and, crucially
for the skew construction (Theorem 5.1), every *auxiliary* attribute is
dominated (or lives in an all-auxiliary relation) and therefore has share 1.

`frozen` attributes are attributes whose share has been forced to 1 (HH-typed
attributes in a residual join).  Per the paper's Example 5.2 a frozen attribute
cannot act as a dominator: dominance is computed among free attributes only.
"""
from __future__ import annotations

from .plan import JoinQuery


def relset(query: JoinQuery, attr: str) -> frozenset[str]:
    """Names of relations containing `attr`."""
    return frozenset(r.name for r in query.relations if r.has(attr))


def dominates(query: JoinQuery, b: str, a: str) -> bool:
    """True iff `b` dominates `a` in `query` (b appears everywhere a does)."""
    if a == b:
        return False
    ra, rb = relset(query, a), relset(query, b)
    return ra <= rb and len(ra) > 0


def dominated_attributes(
    query: JoinQuery,
    frozen: frozenset[str] = frozenset(),
) -> frozenset[str]:
    """Attributes whose share is 1 by the dominance rule.

    Only free (non-frozen) attributes may dominate.  Mutual domination (equal
    relation sets) is broken deterministically: the lexicographically smallest
    attribute of each equivalence class survives, the rest are dominated.
    Hashing on the survivor alone is equivalent to hashing on the class — a
    combined share variable — so optimality is preserved.
    """
    free = [a for a in query.attributes if a not in frozen]
    out: set[str] = set()
    for a in free:
        ra = relset(query, a)
        for b in free:
            if a == b:
                continue
            rb = relset(query, b)
            if ra < rb:
                out.add(a)
                break
            if ra == rb and b < a:
                out.add(a)
                break
    return frozenset(out)


def free_share_attributes(
    query: JoinQuery,
    frozen: frozenset[str] = frozenset(),
) -> tuple[str, ...]:
    """Attributes that get a real (≥1) share variable: not frozen, not dominated."""
    dom = dominated_attributes(query, frozen)
    return tuple(a for a in query.attributes if a not in frozen and a not in dom)
