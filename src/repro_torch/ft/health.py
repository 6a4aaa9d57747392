"""Node health tracking: heartbeats + failure detection.

The heartbeat transport is injectable (a clock and `heartbeat` calls),
which is also how tests simulate failures.  `serve.engine.
SelfHealingSession` feeds one heartbeat per live device per completed batch
and polls `failed_nodes()` before the next; a failed device is evicted and
its cells re-fold over the survivors.
"""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field


class NodeState(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    FAILED = "failed"


@dataclass
class HealthMonitor:
    n_nodes: int
    heartbeat_timeout_s: float = 30.0
    suspect_timeout_s: float = 10.0
    clock: callable = time.monotonic
    _last_beat: dict[int, float] = field(default_factory=dict)
    _forced_failures: set[int] = field(default_factory=set)

    def __post_init__(self):
        now = self.clock()
        self._last_beat = {i: now for i in range(self.n_nodes)}

    def heartbeat(self, node: int) -> None:
        if node not in self._forced_failures:
            self._last_beat[node] = self.clock()

    def inject_failure(self, node: int) -> None:
        """Test hook: node stops heartbeating permanently."""
        self._forced_failures.add(node)

    def state(self, node: int) -> NodeState:
        if node not in self._last_beat:
            raise ValueError(
                f"unknown node {node}: this monitor tracks nodes "
                f"0..{self.n_nodes - 1} (n_nodes={self.n_nodes})")
        age = self.clock() - self._last_beat[node]
        if age > self.heartbeat_timeout_s:
            return NodeState.FAILED
        if age > self.suspect_timeout_s:
            return NodeState.SUSPECT
        return NodeState.HEALTHY

    def failed_nodes(self) -> list[int]:
        return [i for i in range(self.n_nodes)
                if self.state(i) == NodeState.FAILED]

    def healthy_nodes(self) -> list[int]:
        return [i for i in range(self.n_nodes)
                if self.state(i) == NodeState.HEALTHY]
