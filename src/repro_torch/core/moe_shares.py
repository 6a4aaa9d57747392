"""SkewShares applied to MoE expert dispatch — the paper's idea at the EP layer.

Token->expert routing IS a 2-way join Tokens(tok, e) ⋈ Experts(e, W) on the
expert id, and a hot expert is exactly a heavy hitter: classical expert
parallelism sends every token of expert e to e's single home device (the
"partition one side, broadcast the other" of the paper's Example 1.1), so one
hot expert straggles the whole step.

The paper's Example 1.2 prescription — split the heavy hitter's tuples on BOTH
sides across a grid of cells — translates to *expert replication*: give expert
e a group of g_e physical slots (weight replicas), partition its tokens g_e
ways by hashing, and choose g_e by the same budget-allocation greedy the
residual-join planner uses (equalize per-slot load).  The 2-way closed form
x = √(k t/w), y = √(k w/t) further splits each replica tensor-parallel when the
weight side dominates (y maps onto the TP axis).

The planner is numpy, copied from the reference package; `route_tokens` is
the torch data-plane hook the MoE layer calls, with the multiply-shift hash
over uint32 computed in int64 and masked to 32 bits (`kernels.ref.mulshift`).
A plan uploads its dispatch tables to a device the first time it routes
there and keeps them (`MoEDispatchPlan.tables`), so a routing call copies
nothing from the host and a captured decode step can hold it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from ..kernels.ref import mulshift

_ROUTE_SEED = 0x85EBCA6B


@dataclass(frozen=True)
class MoEDispatchPlan:
    """Static expert -> physical-slot assignment with per-expert replication."""

    n_experts: int
    n_slots: int
    slots_of_expert: np.ndarray    # (E, max_group) int32 slot ids, -1 padded
    group_size: np.ndarray         # (E,) int32, power of two
    slot_to_expert: np.ndarray     # (n_slots,) int32 (-1 = unused slot)
    # Device copies of (slots_of_expert, group_size) by device; not part of
    # the plan's value (==, hash, repr).
    _tables: dict = field(default_factory=dict, init=False, repr=False,
                          compare=False)

    def tables(self, device: torch.device
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(slots_of_expert, group_size) on `device`: uploaded the first time
        they are asked for there, then kept."""
        kept = self._tables.get(device)
        if kept is None:
            kept = (torch.as_tensor(self.slots_of_expert, device=device),
                    torch.as_tensor(self.group_size, device=device))
            # A dry run's fake tables (launch/dryrun.py) are not kept.
            if not is_fake(kept[0]):
                self._tables[device] = kept
        return kept

    @property
    def max_group(self) -> int:
        return int(self.slots_of_expert.shape[1])

    def expected_slot_loads(self, loads: np.ndarray) -> np.ndarray:
        out = np.zeros(self.n_slots)
        for e in range(self.n_experts):
            g = int(self.group_size[e])
            for r in range(g):
                out[self.slots_of_expert[e, r]] += loads[e] / g
        return out


def plan_dispatch(loads: np.ndarray, n_slots: int) -> MoEDispatchPlan:
    """Allocate `n_slots` physical expert slots over E experts by load.

    Greedy doubling (the residual-join budget allocator, one residual per
    expert): every expert starts with one slot; the expert with the highest
    per-slot load repeatedly doubles its replication group while slots remain.
    Group sizes stay powers of two so the token-side split is a mask of the
    routing hash.
    """
    loads = np.asarray(loads, dtype=np.float64)
    E = len(loads)
    if n_slots < E:
        raise ValueError(f"n_slots={n_slots} < n_experts={E}")
    g = np.ones(E, dtype=np.int64)
    free = n_slots - E
    while free > 0:
        # Only the current straggler is worth replicating: doubling any other
        # expert cannot reduce the makespan but does cost a weight replica.
        e = int(np.argmax(loads / g))
        if loads[e] <= 0 or g[e] > free:
            break
        free -= int(g[e])
        g[e] *= 2
    max_g = int(g.max())
    slots = np.full((E, max_g), -1, dtype=np.int32)
    slot_to_expert = np.full(n_slots, -1, dtype=np.int32)
    nxt = 0
    for e in range(E):
        for r in range(int(g[e])):
            slots[e, r] = nxt
            slot_to_expert[nxt] = e
            nxt += 1
    return MoEDispatchPlan(E, n_slots, slots, g.astype(np.int32), slot_to_expert)


def route_tokens(plan: MoEDispatchPlan, expert_ids: torch.Tensor,
                 token_ids: torch.Tensor) -> torch.Tensor:
    """Physical slot (int32) per (token, expert) assignment.

    Replica index = top bits of the token-id hash masked to the expert's
    (power-of-two) group size: the heavy hitter's tokens split evenly across
    its replicas, everyone else routes straight to their single slot.
    """
    slots, gsize = plan.tables(expert_ids.device)   # (E, max_g), (E,)
    eidx = expert_ids.long()
    if plan.max_group == 1:
        return slots[eidx, 0]
    h = multiply_shift_torch(token_ids, _ROUTE_SEED, plan.max_group)
    replica = h % gsize[eidx]                        # g_e is a power of two
    return slots[eidx, replica.long()]


def multiply_shift_torch(values: torch.Tensor, seed: int, nbuckets: int
                         ) -> torch.Tensor:
    """Torch twin of core.hypercube.multiply_shift (same hash family): the
    top log2(nbuckets) bits of (values · seed · 2654435769) over uint32."""
    if nbuckets & (nbuckets - 1):
        raise ValueError(f"nbuckets={nbuckets} not a power of two")
    if nbuckets == 1:
        return torch.zeros(values.shape, dtype=torch.int32,
                           device=values.device)
    return mulshift(values, seed, nbuckets.bit_length() - 1)


def shares_split(tokens: float, weight_cost: float, k: int) -> tuple[float, float]:
    """Example 1.2's continuous optimum for one hot expert's k-cell grid.

    Minimize tokens·y + weight_cost·x  s.t. x·y = k:
      x (token partitions)  = √(k · tokens / weight_cost)
      y (weight partitions) = √(k · weight_cost / tokens)
    x is clamped into [1, k] (and y = k/x) so the grid stays feasible when one
    side dominates completely.
    """
    x = min(max(1.0, (k * tokens / weight_cost) ** 0.5), float(k))
    y = k / x
    return x, y


def dispatch_cost(loads: np.ndarray, plan: MoEDispatchPlan,
                  weight_cost: float) -> dict[str, float]:
    """Communication + balance metrics for a dispatch plan (benchmarks)."""
    slot_loads = plan.expected_slot_loads(np.asarray(loads, np.float64))
    token_traffic = float(np.asarray(loads).sum())          # every token moves once
    weight_traffic = float(weight_cost * (plan.group_size - 1).sum())
    used = slot_loads[slot_loads > 0]
    return {
        "token_traffic": token_traffic,
        "weight_traffic": weight_traffic,
        "max_slot_load": float(slot_loads.max()),
        "mean_slot_load": float(used.mean()) if len(used) else 0.0,
        "imbalance": float(slot_loads.max() / max(used.mean(), 1e-9)) if len(used) else 0.0,
    }
