"""Straggler detection + mitigation policy.

Tracks per-node step times (EMA); a node is a straggler when its EMA exceeds
`threshold` × the fleet median.  Mitigations: `shard_weights` (∝ 1/step
time) for shrinking a straggler's data shard, and `to_evict` — nodes with
`evict_after` consecutive strikes, which `serve.engine.SelfHealingSession`
evicts through the same re-fold as a lost device.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class StragglerWatchdog:
    n_nodes: int
    threshold: float = 1.5
    ema: float = 0.7
    evict_after: int = 5
    _t: np.ndarray = field(default=None)
    _strikes: np.ndarray = field(default=None)

    def __post_init__(self):
        self._t = np.zeros(self.n_nodes)
        self._strikes = np.zeros(self.n_nodes, dtype=int)

    def _median(self) -> float:
        """Fleet median over nodes WITH a recorded time; 0.0 when none have
        one (all-zero reports) — np.median of the empty slice is nan plus a
        RuntimeWarning, and nan comparisons would silently disable strikes."""
        recorded = self._t[self._t > 0]
        return float(np.median(recorded)) if recorded.size else 0.0

    def record_step(self, times_s: np.ndarray) -> None:
        times_s = np.asarray(times_s, dtype=float)
        self._t = np.where(self._t == 0, times_s,
                           self.ema * self._t + (1 - self.ema) * times_s)
        med = self._median()
        if med == 0.0:
            return                      # no node has a time yet: no stragglers
        slow = self._t > self.threshold * med
        self._strikes = np.where(slow, self._strikes + 1, 0)

    def stragglers(self) -> list[int]:
        med = self._median()
        return [i for i in range(self.n_nodes)
                if med and self._t[i] > self.threshold * med]

    def to_evict(self) -> list[int]:
        return [i for i in range(self.n_nodes)
                if self._strikes[i] >= self.evict_after]

    def shard_weights(self) -> np.ndarray:
        """Per-node data-shard weights ∝ 1/step-time (rebalance mitigation)."""
        if not (self._t > 0).all():
            return np.full(self.n_nodes, 1.0 / self.n_nodes)
        w = 1.0 / self._t
        return w / w.sum()
