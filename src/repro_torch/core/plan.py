"""Join IR: relations, attributes, and multiway-join queries.

This is the vocabulary the whole `core` package speaks.  A `JoinQuery` is a
natural multiway join R_1 ⋈ R_2 ⋈ … where relations share attributes by name
(the paper's setting).  Sizes are tuple counts used by the communication-cost
model; they default to 1.0 so symbolic reasoning (dominance, cost expressions)
works without data.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping


@dataclass(frozen=True)
class Relation:
    """A named relation with an ordered attribute tuple and a size (in tuples)."""

    name: str
    attrs: tuple[str, ...]
    size: float = 1.0

    def __post_init__(self):
        if len(set(self.attrs)) != len(self.attrs):
            raise ValueError(f"duplicate attribute in relation {self.name}: {self.attrs}")
        if self.size < 0:
            raise ValueError(f"negative relation size for {self.name}")

    def has(self, attr: str) -> bool:
        return attr in self.attrs

    def with_size(self, size: float) -> "Relation":
        return dataclasses.replace(self, size=size)


@dataclass(frozen=True)
class JoinQuery:
    """A natural multiway join over `relations`."""

    relations: tuple[Relation, ...]

    def __post_init__(self):
        names = [r.name for r in self.relations]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate relation names: {names}")

    @property
    def attributes(self) -> tuple[str, ...]:
        """Ordered union of all attributes (first-appearance order)."""
        seen: dict[str, None] = {}
        for r in self.relations:
            for a in r.attrs:
                seen.setdefault(a, None)
        return tuple(seen)

    def relation(self, name: str) -> Relation:
        for r in self.relations:
            if r.name == name:
                return r
        raise KeyError(name)

    def relations_with(self, attr: str) -> tuple[Relation, ...]:
        return tuple(r for r in self.relations if r.has(attr))

    def join_attributes(self) -> tuple[str, ...]:
        """Attributes appearing in ≥2 relations (the ones that can be skewed)."""
        return tuple(a for a in self.attributes if len(self.relations_with(a)) >= 2)

    def with_sizes(self, sizes: Mapping[str, float]) -> "JoinQuery":
        return JoinQuery(tuple(
            r.with_size(float(sizes[r.name])) if r.name in sizes else r
            for r in self.relations))

    def __str__(self) -> str:
        return " ⋈ ".join(f"{r.name}({', '.join(r.attrs)})" for r in self.relations)


def two_way(r_size: float = 1.0, s_size: float = 1.0) -> JoinQuery:
    """The paper's Example 1.1/1.2 query: R(A,B) ⋈ S(B,C)."""
    return JoinQuery((
        Relation("R", ("A", "B"), r_size),
        Relation("S", ("B", "C"), s_size),
    ))


def triangle(r1: float = 1.0, r2: float = 1.0, r3: float = 1.0) -> JoinQuery:
    """The Shares-paper triangle join R1(X1,X2) ⋈ R2(X2,X3) ⋈ R3(X3,X1)."""
    return JoinQuery((
        Relation("R1", ("X1", "X2"), r1),
        Relation("R2", ("X2", "X3"), r2),
        Relation("R3", ("X3", "X1"), r3),
    ))


def running_example(r: float = 1.0, s: float = 1.0, t: float = 1.0) -> JoinQuery:
    """The paper's running Example 3.1: R(A,B) ⋈ S(B,E,C) ⋈ T(C,D)."""
    return JoinQuery((
        Relation("R", ("A", "B"), r),
        Relation("S", ("B", "E", "C"), s),
        Relation("T", ("C", "D"), t),
    ))
