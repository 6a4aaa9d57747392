"""Online skew adaptation: drift detection over the live batch stream.

Everything after `ExecutorSession.prepare` is frozen — the Shares/HH plan
comes from one histogram pass, the LPT placement from one count matrix —
while live traffic drifts.  This module is the control side of the adaptive
loop that un-freezes it (SharesSkew's re-derivation of the residual plan from
observed heavy hitters, run continuously):

  observe   each executed batch contributes (a) its per-(device, cell)
            routed-copy count matrices — already produced by the scatter-free
            counting pass, summed to a (k,) cell-load vector and kept in a
            sliding window — and (b) its raw join-attribute columns, folded
            through one `np.unique` into a per-attribute windowed
            `MisraGries` sketch;
  compare   the window's normalized cell-load distribution against the
            plan-time expectation via total-variation distance — TV is the
            natural metric here because the worst-case device-load shift of
            ANY placement is bounded by the total probability mass that
            moved between cells;
  decide    `assess()` is a small hysteresis state machine: `patience`
            consecutive drifted batches arm an action, a per-action cooldown
            disarms thrash, and the action is graded — mild drift wants a
            RE-PLACEMENT (re-run LPT on observed loads and swap the traced
            placement table: zero recompile), threshold-crossing drift or a
            provable new heavy hitter wants a RE-PLAN (re-derive the
            residual plan from the sketched HH set; warm when the HH set and
            residual structure are unchanged).

The detector is pure host-side numpy + sketches: it never touches the
card, so it is unit-testable with synthetic count-matrix sequences
(tests/test_torch_adapt.py holds it against the JAX package's) and its cost
a batch is one `np.unique` and one `MisraGries.update_counts` per stream.
The actuation side — swapping placements/plans on a live
`SelfHealingSession` — lives in serve/engine.py, which treats adaptation as
a third recovery axis beside overflow retry and device eviction.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Mapping

import numpy as np

from .heavy_hitters import HHSet, MisraGries


def tv_distance(p: np.ndarray, q: np.ndarray) -> float:
    """Total-variation distance between two load vectors (normalized first).

    ½·Σ|p̂ − q̂| ∈ [0, 1]: the fraction of probability mass that moved.  Load
    vectors, not distributions, come in — zero-sum vectors normalize to
    nothing, so two empty loads are distance 0 and empty-vs-nonempty is 1.
    """
    p = np.asarray(p, np.float64).ravel()
    q = np.asarray(q, np.float64).ravel()
    if p.shape != q.shape:
        raise ValueError(f"load vectors differ in shape: {p.shape} vs {q.shape}")
    ps, qs = p.sum(), q.sum()
    if ps <= 0 or qs <= 0:
        return 0.0 if ps == qs else 1.0
    return 0.5 * float(np.abs(p / ps - q / qs).sum())


@dataclass(frozen=True)
class AdaptPolicy:
    """Tuning knobs of the drift state machine (all host-side).

    Thresholds are TV distances in [0, 1]: `replace_threshold` arms the cheap
    action (re-run LPT, swap the traced table), `replan_threshold` the
    expensive one (re-derive the residual plan).  `patience` consecutive
    drifted batches are required to arm either (one weird batch is noise);
    separate cooldowns — measured in observed batches since the last action
    of that kind — bound the action frequency so an oscillating workload
    cannot thrash the session.  `min_batches` suppresses decisions until the
    window has any evidence at all.  The sketch side: `sketch_counters` is
    the Misra–Gries m per join attribute, `hh_threshold_factor` scales the
    planner's 1/k HH frequency threshold, `max_hh_per_attr` caps the
    re-planned HH set exactly as the exact planner caps its own.
    """

    replace_threshold: float = 0.10
    replan_threshold: float = 0.35
    window: int = 8
    patience: int = 2
    min_batches: int = 2
    replace_cooldown: int = 2
    replan_cooldown: int = 6
    sketch_counters: int = 64
    hh_threshold_factor: float = 1.0
    max_hh_per_attr: int = 64

    def __post_init__(self):
        if not (0.0 < self.replace_threshold <= self.replan_threshold):
            raise ValueError(
                f"need 0 < replace_threshold ≤ replan_threshold, got "
                f"{self.replace_threshold} / {self.replan_threshold}")
        if self.patience < 1 or self.window < 1 or self.sketch_counters < 1:
            raise ValueError("patience, window, sketch_counters must be ≥ 1")


class DriftDetector:
    """Windowed drift detector: observed cell loads + HH sketches vs plan.

    Construct with the plan-time expected per-cell load vector (the prepare
    count matrices' column sums), the join attributes to sketch, the HH
    frequency threshold `hh_frac` (the planner's threshold_factor/k), and the
    plan's current HH values per attribute.  Per batch, call `observe_loads`
    (and `observe_values` when the raw columns are available), then `assess()`
    for the graded decision.  After the caller ACTS on a decision it must
    call `rebaseline(new_expected, action=...)` — that clears the window
    (post-action batches are judged against the post-action expectation, not
    pre-shift history), resets the patience streaks, and starts the action's
    cooldown; a replan rebaseline also resets the sketches and adopts the new
    plan's HH set.
    """

    def __init__(self, expected_cell_loads: np.ndarray,
                 policy: AdaptPolicy | None = None,
                 attrs: tuple[str, ...] = (),
                 hh_frac: float = 0.0,
                 known_hhs: Mapping[str, tuple[int, ...]] | None = None):
        self.policy = policy or AdaptPolicy()
        self.expected = np.asarray(expected_cell_loads, np.float64).ravel()
        self.k = int(self.expected.size)
        self.attrs = tuple(attrs)
        self.hh_frac = float(hh_frac)
        known_hhs = known_hhs or {}
        self.known_hhs: dict[str, frozenset[int]] = {
            a: frozenset(known_hhs.get(a, ())) for a in self.attrs}
        # One sketch per (attribute, stream) where a stream is one relation's
        # column — `exact_heavy_hitters` thresholds each relation against its
        # OWN size, so pooling the columns would shift the threshold and a
        # stable workload's sketched HH set would stop matching the plan's.
        # Streams materialize lazily on first observation.
        self.sketches: dict[str, dict[str, MisraGries]] = {
            a: {} for a in self.attrs}
        self.window: deque[np.ndarray] = deque(maxlen=self.policy.window)
        self.batches = 0                      # observed batches, lifetime
        self._replace_streak = 0
        self._replan_streak = 0
        self._last_replace = -(1 << 30)       # batch index of the last action
        self._last_replan = -(1 << 30)
        self.history: list[tuple[int, str, float]] = []  # (batch, action, tv)

    # -- observation ---------------------------------------------------------
    def observe_loads(self, loads: np.ndarray) -> None:
        """Feed one batch's per-cell routed-copy loads ((k,) vector, or the
        per-relation (n_devices, k) count matrices to be summed here)."""
        arr = np.asarray(loads, np.float64)
        if arr.ndim > 1:
            arr = arr.reshape(-1, self.k).sum(axis=0)
        if arr.shape != (self.k,):
            raise ValueError(f"loads shape {arr.shape} incompatible with "
                             f"k={self.k}")
        self.window.append(arr)
        self.batches += 1

    def observe_values(self, columns: Mapping[str, object]) -> None:
        """Feed one batch's raw join-attribute columns into the HH sketches
        (one np.unique per stream; padding rows < 0 are dropped).

        `columns[attr]` is either a single array (sketched as one pooled
        stream) or a mapping {relation_name: column} — one sketch per
        relation, matching `exact_heavy_hitters`'s per-relation thresholds."""
        for attr in self.attrs:
            entry = columns.get(attr)
            if entry is None:
                continue
            streams = (entry if isinstance(entry, Mapping)
                       else {"*": entry})
            for name, col in streams.items():
                col = np.asarray(col).ravel()
                col = col[col >= 0]
                if col.size == 0:
                    continue
                sk = self.sketches[attr].get(name)
                if sk is None:
                    sk = MisraGries(self.policy.sketch_counters)
                    self.sketches[attr][name] = sk
                vals, cnts = np.unique(col, return_counts=True)
                sk.update_counts(vals, cnts)

    # -- signals --------------------------------------------------------------
    def observed_cell_loads(self) -> np.ndarray:
        """Sum of the windowed per-batch load vectors ((k,), float64)."""
        if not self.window:
            return np.zeros(self.k, np.float64)
        return np.sum(self.window, axis=0)

    def drift(self) -> float:
        """TV distance between the windowed observation and the baseline."""
        if not self.window:
            return 0.0
        return tv_distance(self.observed_cell_loads(), self.expected)

    def new_heavy_hitters(self) -> dict[str, tuple[int, ...]]:
        """Per attribute: values the sketch PROVES are heavy hitters (their
        under-counting counter already clears hh_frac·n_seen) but the current
        plan does not know.  Empty unless hh_frac > 0."""
        if self.hh_frac <= 0:
            return {a: () for a in self.attrs}
        out: dict[str, tuple[int, ...]] = {}
        for attr in self.attrs:
            new: set[int] = set()
            for sk in self.sketches[attr].values():
                new.update(v for v in sk.certain_heavy_hitters(self.hh_frac)
                           if v not in self.known_hhs[attr])
            out[attr] = tuple(sorted(new))
        return out

    def sketched_hhs(self) -> HHSet:
        """The HH set a re-plan should use, mirroring `exact_heavy_hitters`:
        per attribute, a value qualifies when SOME stream's sketch estimate
        reaches hh_frac of that stream's weight (the planner's per-relation
        count ≥ threshold_factor·|R|/k, with the sketch's under-counting
        estimate standing in for the count — so an exact sketch, m ≥ distinct
        values, reproduces the exact detector bit-for-bit, and a lossy one
        errs toward fewer HHs, never phantom ones).  Values are ranked by
        their best estimate and capped at the policy's max_hh_per_attr."""
        out: dict[str, tuple[int, ...]] = {}
        for attr in self.attrs:
            counts: dict[int, int] = {}
            for sk in self.sketches[attr].values():
                if not sk.n_seen or self.hh_frac <= 0:
                    continue
                thresh = max(1.0, self.hh_frac * sk.n_seen)
                for v, c in sk.counters.items():
                    if c >= thresh:
                        counts[v] = max(counts.get(v, 0), c)
            ranked = sorted(counts, key=lambda v: (-counts[v], v))
            out[attr] = tuple(sorted(ranked[:self.policy.max_hh_per_attr]))
        return HHSet(out)

    # -- decision --------------------------------------------------------------
    def assess(self) -> str:
        """Graded decision for the current window: 'stable', 'replace', or
        'replan'.  Advances the patience streaks, so call it exactly once per
        observed batch (the engine does)."""
        pol = self.policy
        if self.batches < pol.min_batches or not self.window:
            return "stable"
        tv = self.drift()
        definite_new_hh = any(v for v in self.new_heavy_hitters().values())
        replan_signal = tv >= pol.replan_threshold or definite_new_hh
        replace_signal = tv >= pol.replace_threshold
        self._replan_streak = self._replan_streak + 1 if replan_signal else 0
        self._replace_streak = self._replace_streak + 1 if replace_signal else 0
        if (self._replan_streak >= pol.patience
                and self.batches - self._last_replan >= pol.replan_cooldown):
            return "replan"
        if (self._replace_streak >= pol.patience
                and self.batches - self._last_replace >= pol.replace_cooldown):
            return "replace"
        return "stable"

    def rebaseline(self, expected_cell_loads: np.ndarray, action: str,
                   known_hhs: Mapping[str, tuple[int, ...]] | None = None
                   ) -> None:
        """Adopt a post-action baseline after the caller acted on `assess()`.

        `action` is the action taken ('replace' or 'replan'); it starts that
        action's cooldown and is recorded in `history` with the drift that
        triggered it.  A replan additionally resets the sketches (the new
        plan absorbed everything they knew) and adopts `known_hhs` (the new
        plan's HH set) so the definite-new-HH trigger re-arms only on values
        the NEW plan misses."""
        tv = self.drift()
        self.expected = np.asarray(expected_cell_loads, np.float64).ravel()
        if self.expected.size != self.k:
            raise ValueError(f"expected loads size {self.expected.size} != "
                             f"k={self.k}")
        self.window.clear()
        self._replace_streak = self._replan_streak = 0
        if action == "replan":
            self._last_replan = self.batches
            self._last_replace = self.batches   # a replan re-places too
            self.sketches = {a: {} for a in self.attrs}
            if known_hhs is not None:
                self.known_hhs = {a: frozenset(known_hhs.get(a, ()))
                                  for a in self.attrs}
        elif action == "replace":
            self._last_replace = self.batches
        else:
            raise ValueError(f"unknown rebaseline action {action!r}")
        self.history.append((self.batches, action, tv))


class TenantDriftBank:
    """Per-tenant `DriftDetector`s behind one shared `AdaptPolicy`.

    The multi-tenant serving engine (serve/join_engine.py) interleaves many
    query streams on one card; each stream drifts independently, so one
    global detector would smear tenant A's hot-key migration into tenant B's
    stable baseline.  The bank lazily creates one detector per tenant on
    `register` (seeded with that tenant's prepare-time expected loads) and
    routes `observe` / `rebaseline` by tenant id.  Pure host-side, like the
    detectors it holds."""

    def __init__(self, policy: AdaptPolicy | None = None):
        self.policy = policy or AdaptPolicy()
        self.detectors: dict[object, DriftDetector] = {}

    def register(self, tenant: object, expected_cell_loads: np.ndarray,
                 **detector_kw) -> DriftDetector:
        """(Re)create `tenant`'s detector around a fresh baseline.  Extra
        keyword args go to `DriftDetector` (attrs, hh_frac, known_hhs)."""
        det = DriftDetector(expected_cell_loads, self.policy, **detector_kw)
        self.detectors[tenant] = det
        return det

    def get(self, tenant: object) -> DriftDetector | None:
        return self.detectors.get(tenant)

    def observe(self, tenant: object, loads: np.ndarray,
                columns: Mapping[str, object] | None = None) -> str:
        """Feed one executed batch of `tenant`'s stream and return the graded
        verdict ('stable' / 'replace' / 'replan').  Unregistered tenants are
        'stable' — the engine registers at prepare time."""
        det = self.detectors.get(tenant)
        if det is None:
            return "stable"
        det.observe_loads(loads)
        if columns is not None:
            det.observe_values(columns)
        return det.assess()

    def rebaseline(self, tenant: object, expected_cell_loads: np.ndarray,
                   action: str, **kw) -> None:
        det = self.detectors[tenant]
        det.rebaseline(expected_cell_loads, action, **kw)
