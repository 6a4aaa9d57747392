"""Cell placement: logical reducer cells -> physical devices (fold layer).

The Shares plan allocates ``k`` LOGICAL reducer cells sized to the data
(Hypercube blocks in one flat offset space, wrapped modulo k), while the
hardware provides ``n_devices`` physical devices — usually far fewer.  This
module is the layer between them: a `CellPlacement` is a static table
``table[logical_cell] = device`` that the executor composes with hypercube
routing (`route_cells` then a `fold_cells` lookup), so any power-of-two
k >= n_devices executes on any mesh.

Beame–Koutris–Suciu state their load guarantees for p servers each receiving
MANY hash cells; *which* cells share a server is exactly where that guarantee
meets real hardware.  Two strategies:

  modulo  device = cell % n_devices.  Oblivious baseline — correct, and fine
          when per-cell loads are uniform (the no-skew regime), but adjacent
          heavy cells of one residual block can pile onto one device.
  lpt     greedy Longest-Processing-Time bin packing on per-cell load
          estimates (`SkewJoinPlan.cell_loads` or the executor's on-device
          routing histogram): place cells in decreasing load order, each onto
          the currently least-loaded device.  Classic 4/3-OPT makespan bound;
          on zipf-skewed workloads it restores the balance the modulo wrap
          destroys (see the `fold_scaling` benchmark / BENCH_fold.json).

Correctness never depends on the placement: every routed tuple carries its
logical cell id and the executor's local join matches only within equal
logical cells, so ANY table — even all-cells-on-one-device — yields the exact
join (tests/test_fold.py proves the adversarial case).  Placement only moves
load.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class CellPlacement:
    """Static assignment of k logical cells onto n_devices physical devices.

    `table` is int32 (k,), values in [0, n_devices); `strategy` records how it
    was built ("lpt", "modulo", or "explicit").  Immutable — build a new one
    to re-place.
    """

    table: np.ndarray = field(repr=False)
    n_devices: int
    strategy: str = "explicit"

    def __post_init__(self):
        t = np.ascontiguousarray(np.asarray(self.table, dtype=np.int32))
        object.__setattr__(self, "table", t)
        if t.ndim != 1 or t.size == 0:
            raise ValueError("placement table must be a non-empty 1-D array")
        if self.n_devices < 1:
            raise ValueError(f"n_devices={self.n_devices} must be >= 1")
        if t.min() < 0 or t.max() >= self.n_devices:
            raise ValueError(
                f"placement table values must lie in [0, {self.n_devices})")

    @property
    def k(self) -> int:
        """Number of logical cells placed."""
        return int(self.table.size)

    def device_of(self, cells: np.ndarray) -> np.ndarray:
        """Physical device per (wrapped) logical cell id; -1 passes through."""
        cells = np.asarray(cells)
        valid = cells >= 0
        out = np.full(cells.shape, -1, np.int32)
        out[valid] = self.table[cells[valid] % self.k]
        return out

    def cells_of(self, device: int) -> np.ndarray:
        """Logical cell ids folded onto one physical device."""
        return np.nonzero(self.table == device)[0].astype(np.int32)

    def device_loads(self, cell_loads: np.ndarray) -> np.ndarray:
        """Fold per-logical-cell loads into per-device loads (float64 (n,))."""
        cell_loads = np.asarray(cell_loads, np.float64)
        if cell_loads.shape != (self.k,):
            raise ValueError(
                f"cell_loads shape {cell_loads.shape} != ({self.k},)")
        return np.bincount(self.table, weights=cell_loads,
                           minlength=self.n_devices)

    def imbalance(self, cell_loads: np.ndarray) -> float:
        """max/mean physical device load (1.0 = perfectly balanced)."""
        loads = self.device_loads(cell_loads)
        return float(loads.max() / max(loads.mean(), 1e-12))


def modulo_placement(k: int, n_devices: int) -> CellPlacement:
    """Oblivious wrap: cell c -> device c % n_devices (the fallback/baseline).

    When k == n_devices this is the identity — the pre-folding executor's
    behavior, bit-for-bit.
    """
    check_fold(k, n_devices)
    return CellPlacement(np.arange(k, dtype=np.int32) % n_devices,
                         n_devices, "modulo")


def lpt_placement(cell_loads: np.ndarray, n_devices: int,
                  devices: list[int] | None = None) -> CellPlacement:
    """Greedy LPT bin packing of cells onto devices by estimated load.

    Cells are placed in decreasing load order (ties broken by cell id, so the
    table is deterministic), each onto the device with the smallest current
    load; equal loads break toward the device holding fewer cells, then the
    lower device id — so zero-load cells spread round-robin instead of piling
    onto device 0, and the table is fully deterministic.

    `devices` restricts the pack to a subset of the mesh — the degraded-mode
    re-fold after a device failure/eviction (ft/): the table still indexes
    the FULL [0, n_devices) id space (the mesh does not shrink), but only the
    surviving devices receive cells, so an evicted device gets zero data
    while still participating in the collective.
    """
    loads = np.asarray(cell_loads, np.float64)
    if loads.ndim != 1:
        raise ValueError("cell_loads must be 1-D (one entry per logical cell)")
    k = loads.size
    check_fold(k, n_devices)
    if devices is None:
        devices = list(range(n_devices))
    else:
        devices = sorted(set(int(d) for d in devices))
        if not devices:
            raise ValueError("lpt_placement needs at least one target device")
        if devices[0] < 0 or devices[-1] >= n_devices:
            raise ValueError(
                f"target devices {devices} outside [0, {n_devices})")
        if k < len(devices):
            raise ValueError(
                f"k={k} logical cells < {len(devices)} target devices")
    order = np.argsort(-loads, kind="stable")       # decreasing, id tie-break
    heap = [(0.0, 0, d) for d in devices]           # (load, n_cells, device)
    heapq.heapify(heap)
    table = np.zeros(k, np.int32)
    for c in order:
        load, n_cells, d = heapq.heappop(heap)
        table[c] = d
        heapq.heappush(heap, (load + float(loads[c]), n_cells + 1, d))
    return CellPlacement(table, n_devices, "lpt")


def place_cells(cell_loads: np.ndarray | None, k: int, n_devices: int,
                strategy: str = "lpt",
                devices: list[int] | None = None) -> CellPlacement:
    """Build a placement for k cells; `cell_loads` may be None (-> modulo).

    The planner-facing entry point: pass `SkewJoinPlan.cell_loads(data)` (or
    the executor session's on-device routing histogram) for skew-aware LPT,
    or nothing for the oblivious modulo wrap.  `devices` restricts LPT to a
    survivor subset of the mesh (degraded mode — see `lpt_placement`);
    modulo ignores it (the oblivious wrap has no notion of failed devices).
    """
    if strategy == "modulo" or cell_loads is None:
        return modulo_placement(k, n_devices)
    if strategy != "lpt":
        raise ValueError(f"unknown placement strategy {strategy!r}")
    loads = np.asarray(cell_loads, np.float64)
    if loads.size != k:
        raise ValueError(f"cell_loads has {loads.size} entries, expected k={k}")
    return lpt_placement(loads, n_devices, devices)


def placement_gain(cell_loads: np.ndarray, placement: CellPlacement,
                   devices: list[int] | None = None) -> tuple[float, float]:
    """(current, best) max/mean device imbalance of `cell_loads` under the
    existing placement vs a fresh LPT pack over the same (or a survivor
    subset of) devices.

    The re-placement value signal for the adaptive loop (core/adapt.py):
    drift says the load DISTRIBUTION moved, this says whether moving cells
    can actually flatten the makespan — current/best close to 1 means the
    observed loads are already near-optimally folded and a re-placement
    would churn the table for nothing."""
    cur = placement.imbalance(cell_loads)
    best = lpt_placement(cell_loads, placement.n_devices,
                         devices).imbalance(cell_loads)
    return cur, best


def check_fold(k: int, n_devices: int) -> None:
    """The folding contract: power-of-two k, at least one cell per device.
    (k need not be a multiple of n_devices — LPT doesn't care.)  Shared by
    the placement constructors here and `ShardedJoinExecutor.__init__`."""
    if k < n_devices:
        raise ValueError(
            f"k={k} logical cells < n_devices={n_devices}: folding maps many "
            f"cells per device, never many devices per cell — plan with "
            f"k >= n_devices (idle devices want a smaller mesh, not a "
            f"stretched plan)")
    if k & (k - 1):
        raise ValueError(
            f"k={k} is not a power of two (hypercube shares are powers of "
            f"two and the modulo wrap of the logical cell space requires it)")
