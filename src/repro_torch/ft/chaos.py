"""Deterministic chaos injection for the self-healing executor.

Every fault the FT layer claims to survive is injectable here — via explicit
schedules and a seeded rng, never wall-clock randomness — so the chaos suite
(tests/test_torch_chaos.py) and `chip_smoke.py` can drive executor
sessions through fault scenarios and assert bit-exact recovery:

  * ``squeeze_caps``     forced-tiny shuffle capacities -> capacity overflow
                         (exercises bounded retry + bucket-aligned
                         escalation in `ExecutorSession.run_with_retry`);
  * ``delay_device``     per-device step-time inflation -> straggler
                         detection (StragglerWatchdog strikes -> eviction);
  * ``drop_heartbeats``  a device goes silent -> HealthMonitor failure
                         (device-loss eviction + survivor re-fold);
  * ``corrupt_rows``     scribbles sub-sentinel garbage into a relation
                         chunk -> rejected by executor input validation
                         (`InputValidationError`), never routed.

The injector also owns the VIRTUAL CLOCK the engine hands to HealthMonitor:
`advance()` moves time forward one batch at a time, so heartbeat timeouts
fire at exact, reproducible batch indices instead of wall-time races.  The
hook methods (`clock`, `advance`, `squeeze`, `step_times`,
`dropped_heartbeats`, `mangle`) are what `serve.engine.SelfHealingSession`
calls; the schedule methods are the test/bench surface.
"""
from __future__ import annotations

import numpy as np

# Any value below the executor's -1 padding sentinel is contract-violating
# garbage; input validation must reject it before routing.
CORRUPT_VALUE = -7


class ChaosInjector:
    """Deterministic fault schedule + virtual clock for one engine."""

    def __init__(self, n_devices: int, seed: int = 0):
        if n_devices < 1:
            raise ValueError(f"n_devices={n_devices} must be >= 1")
        self.n_devices = n_devices
        self.rng = np.random.default_rng(seed)
        self.step = 0                    # batches observed (advance() calls)
        self._time = 0.0
        self._squeeze: dict[str | None, float] = {}   # None = every relation
        self._delays = np.zeros(n_devices)
        self._dropped: set[int] = set()
        self._corrupt: list[tuple[str, int, int]] = []  # (rel, at_step, rows)

    # -- schedule (test / bench surface) ------------------------------------
    def squeeze_caps(self, factor: float, rel: str | None = None) -> None:
        """Shrink derived shuffle caps by `factor` at prepare time (None =
        all relations) — the forced-tiny-caps overflow fault."""
        if not 0 < factor:
            raise ValueError(f"squeeze factor {factor} must be > 0")
        self._squeeze[rel] = factor

    def delay_device(self, device: int, seconds: float) -> None:
        """Inflate one device's reported step time by `seconds` from now on
        — the persistent-straggler fault."""
        self._check_device(device)
        self._delays[device] += seconds

    def drop_heartbeats(self, device: int) -> None:
        """Silence one device's heartbeats from now on — the device-loss
        fault (HealthMonitor declares it failed after its timeout)."""
        self._check_device(device)
        self._dropped.add(device)

    def restore_heartbeats(self, device: int) -> None:
        self._dropped.discard(device)

    def corrupt_rows(self, rel: str, n_rows: int = 1,
                     at_step: int | None = None) -> None:
        """Scribble sub-sentinel garbage into `n_rows` random rows of one
        relation's chunk at batch `at_step` (default: the next batch)."""
        self._corrupt.append(
            (rel, self.step if at_step is None else int(at_step),
             int(n_rows)))

    # -- hooks (called by SelfHealingSession) --------------------------------
    def clock(self) -> float:
        """Virtual monotonic time (hand this to HealthMonitor)."""
        return self._time

    def advance(self, dt: float) -> None:
        """One batch of virtual time passed."""
        self._time += float(dt)
        self.step += 1

    def squeeze(self, caps: dict[str, int]) -> dict[str, int]:
        """Apply scheduled cap squeezes (floor 1 — a zero cap is shapeless)."""
        out = dict(caps)
        for rel, cap in caps.items():
            factor = self._squeeze.get(rel, self._squeeze.get(None))
            if factor is not None:
                out[rel] = max(1, int(cap * factor))
        return out

    def step_times(self, base: np.ndarray) -> np.ndarray:
        """Per-device reported step times = measured base + injected delays."""
        return np.asarray(base, float) + self._delays

    def dropped_heartbeats(self) -> set[int]:
        return set(self._dropped)

    def mangle(self, chunks):
        """Apply row corruption scheduled for the CURRENT batch index.

        Returns `chunks` untouched (same object) when nothing is due;
        otherwise a deep copy with the scheduled rows overwritten by
        `CORRUPT_VALUE` — callers' arrays are never modified in place."""
        due = [(rel, n) for rel, at, n in self._corrupt if at == self.step]
        if not due or chunks is None:
            return chunks
        out = {name: np.array(arr, copy=True)
               for name, arr in chunks.items()}
        for rel, n in due:
            arr = out[rel]
            if not len(arr):
                continue
            idx = self.rng.choice(len(arr), size=min(n, len(arr)),
                                  replace=False)
            cols = self.rng.integers(0, arr.shape[1], size=idx.size)
            arr[idx, cols] = CORRUPT_VALUE
        return out

    def _check_device(self, device: int) -> None:
        if not 0 <= device < self.n_devices:
            raise ValueError(
                f"device {device} outside [0, {self.n_devices})")
