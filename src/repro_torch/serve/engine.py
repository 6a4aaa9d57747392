"""Serving engines: continuous-batching decode + the self-healing join loop.

`ServingEngine` — a fixed pool of B sequence slots runs one decode step per
tick; requests are admitted into free slots as others finish (continuous
batching).  Prompt ingestion replays prompt tokens through the same decode
step (one step function serves both phases; `build_prefill` is the
bulk-prompt path).  Greedy sampling; per-request max_new_tokens;
deterministic given (params, prompts).  Slot bookkeeping is host-side
numpy; the device state is the KV cache.  On the card the decode step is
a CUDA graph (`serve_step.py`), fed the tokens and positions from the
engine's pinned host buffers; a tick reads the next tokens back once.

`SelfHealingSession` — the fault-tolerant loop around a join
`ExecutorSession`: capacity overflow heals by bounded retry on the
capacity grid; device loss (missed heartbeats) and persistent stragglers
heal by evicting the device and re-folding the logical cells over the
survivors; with `adapt=AdaptPolicy(...)` skew drift heals by re-placing
the cells on the observed loads or re-planning from the sketched heavy
hitters (core/adapt.py).  Over an executor on a mesh of ranks the same loop
runs on every rank, each taking the same decision in the same batch.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Mapping

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import ArchConfig
from ..core.adapt import AdaptPolicy, DriftDetector
from ..core.executor import (DeviceLossError, ExecutorSession, RetryPolicy,
                             ShardedJoinExecutor, _struct_key)
from ..core.placement import lpt_placement
from ..core.skewjoin import fills_pruned, plan_from_hhs, pruned_combos
from ..ft import ChaosInjector, HealthMonitor, StragglerWatchdog

if TYPE_CHECKING:
    from .serve_step import ServeFns


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    out: list[int] = field(default_factory=list)
    done: bool = False


class ServingEngine:
    """B slots over one KV cache (bf16, as the reference's), on the card
    unless the caller asks for the CPU.

    Over a mesh (`mesh=`, a DeviceMesh of `launch.mesh.make_lm_mesh`; the
    reference's `ServingEngine(cfg, mesh, ...)`) the decode step is
    `build_decode_step(mesh=)`'s, the parameters become DTensors of its
    placements (from a one-process model or the reference's numpy tree)
    and the cache DTensors of its `cache_placements`, on the rank's device
    unless `device` is given.
    Every rank runs this same host loop with the same requests, in the
    same order: its decisions read only the host's state and the next
    tokens, which the step gives every rank alike, so every rank issues
    the same collectives in the same order."""

    def __init__(self, cfg: ArchConfig, batch_slots: int, max_seq: int,
                 params, fns: ServeFns | None = None, *, mesh=None,
                 device=None):
        from ..models import api
        from .serve_step import (_device, build_decode_step, mesh_cache,
                                 mesh_params)
        self.cfg = cfg
        self.B, self.max_seq = batch_slots, max_seq
        self.mesh = mesh
        self.device = _device(mesh, device)
        self.fns = fns or build_decode_step(cfg, batch_slots, max_seq,
                                            mesh=mesh, device=self.device)
        if self.fns.mesh is not mesh:
            raise ValueError("the decode step was built over another mesh")
        if mesh is None:
            self.params = params.to(self.device)
            self.cache = api.init_cache(cfg, batch_slots, max_seq,
                                        device=self.device)
        else:
            self.params = mesh_params(cfg, params, self.fns)
            self.cache = mesh_cache(cfg, self.fns)
        self.queue: list[Request] = []
        self.waiting: deque[Request] = deque()   # FIFO of unadmitted requests
        self.slots: list[Request | None] = [None] * batch_slots
        # Per-slot host state.  `pos` and `next_tok` are numpy views of the
        # step's host inputs, pinned on the card, so that a graph step's
        # copies of them are asynchronous; a tick's read of the next tokens
        # waits for the step, so the host writes them only after it.
        pin = self.device.type == "cuda"
        self._pos_in = torch.zeros(batch_slots, dtype=torch.int32,
                                   pin_memory=pin)
        self._tok_in = torch.zeros((batch_slots, 1), dtype=torch.int32,
                                   pin_memory=pin)
        self.pos = self._pos_in.numpy()
        self.pending = [[] for _ in range(batch_slots)]   # prompt tokens left
        self.next_tok = self._tok_in.numpy()[:, 0]
        self.ticks = 0
        self.tokens_out = 0

    # -- public ---------------------------------------------------------------
    def submit(self, prompt: list[int], max_new_tokens: int) -> Request:
        req = Request(len(self.queue), list(prompt), max_new_tokens)
        self.queue.append(req)
        self.waiting.append(req)
        return req

    def run(self, max_ticks: int = 10_000) -> list[Request]:
        while (any(not r.done for r in self.queue)) and self.ticks < max_ticks:
            self._admit()
            self._tick()
        return self.queue

    def occupancy(self) -> float:
        return sum(s is not None for s in self.slots) / self.B

    # -- internals --------------------------------------------------------------
    def _admit(self) -> None:
        # Each request is popped at most once: no per-tick rescan.
        for i in range(self.B):
            if self.slots[i] is not None:
                continue
            while self.waiting:
                req = self.waiting.popleft()
                if req.done:                      # cancelled before admission
                    continue
                self.slots[i] = req
                self.pos[i] = 0
                self.pending[i] = list(req.prompt)
                self.next_tok[i] = self.pending[i].pop(0)
                self._reset_slot(i)
                break

    def _reset_slot(self, i: int) -> None:
        """Zero slot i's state in place, through the whole (nested) cache
        (KV rows are masked by position, but SSM states carry over).  The
        reference's convention: batch axis 1 for rank≥3 leaves ((L,B,...)
        stacked), 0 below.  It zeroes column i of the rank-3 `enc_out` and
        `vis` ((B, rows, d)), not slot i; the engine never prefills, so
        those leaves stay zeros (ROADMAP §3), and an index past their rows
        is dropped, as JAX drops an update out of bounds.  Over a mesh the
        rank whose block holds that index zeroes it there."""
        from ..models.common import local_block, to_local

        def zero(a):
            if isinstance(a, dict):
                for v in a.values():
                    zero(v)
                return
            if a is None or a.dim() == 0:
                return
            axis = 1 if a.dim() >= 3 else 0
            local, at = to_local(a), i
            if self.mesh is not None:
                at -= local_block(a.shape, a.placements, self.mesh)[1][axis]
            if 0 <= at < local.shape[axis]:
                local.select(axis, at).zero_()

        zero(self.cache)

    def _tick(self) -> None:
        # Feed: prompt token if any pending, else the last generated token.
        nxt, self.cache = self.fns.decode(self.params, self.cache,
                                          self._tok_in, self._pos_in)
        nxt = nxt.cpu().numpy()
        self.ticks += 1
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.pos[i] += 1
            if self.pending[i]:                       # still ingesting prompt
                self.next_tok[i] = self.pending[i].pop(0)
                continue
            req.out.append(int(nxt[i]))
            self.tokens_out += 1
            self.next_tok[i] = int(nxt[i])
            if (len(req.out) >= req.max_new_tokens
                    or self.pos[i] >= self.max_seq - 1):
                req.done = True
                self.slots[i] = None                  # slot freed; cache rows
                # are overwritten by the next admit (pos resets to 0).


def _agreed(ex: ShardedJoinExecutor, values: list[float]) -> list[float]:
    """Rank 0's `values` on every rank of `ex`'s mesh: one broadcast."""
    t = torch.tensor(values, dtype=torch.float64, device=ex.device)
    dist.broadcast(t, src=dist.get_global_rank(ex.group, 0), group=ex.group)
    return t.tolist()


class _MeshClock:
    """The HealthMonitor's clock over a mesh without a chaos injector:
    rank 0's `time.monotonic()` as last agreed (`agree`, one broadcast
    over the session's executor's mesh)."""

    def __init__(self, session: "SelfHealingSession"):
        self._session = session
        self.agree()

    def agree(self) -> None:
        self._now, = _agreed(self._session.executor, [time.monotonic()])

    def __call__(self) -> float:
        return self._now


class SelfHealingSession:
    """Fault-tolerant run loop around a join `ExecutorSession`, on the
    executor's device.  One response per fault class:

      overflow    -> `ExecutorSession.run_with_retry`: bounded retry, only
                     the failing caps escalate, on the capacity grid (a
                     ladder the executor has walked builds no step);
      device loss -> `HealthMonitor` heartbeats per completed batch; a
                     device silent past the timeout is evicted: LPT over
                     the survivors, then `ExecutorSession.refold` (a new
                     placement table, a step argument, so no step is
                     built); the device keeps its slot and receives no
                     cell, and rows stay exact;
      stragglers  -> per-device step times feed `StragglerWatchdog`;
                     `evict_after` consecutive strikes evict the device
                     through the same re-fold;
      skew drift  -> with `adapt=AdaptPolicy(...)` every executed batch
                     feeds a `DriftDetector` (core/adapt.py): one more
                     counting pass over the batch already on the card
                     (`count_batch`) gives its per-cell loads, the raw
                     join columns feed windowed Misra–Gries sketches on
                     the host.  Mild drift re-runs LPT on the OBSERVED
                     loads and swaps the placement table (`force_replace`:
                     no step built, as the eviction re-fold);
                     threshold-crossing drift or a sketch-proven new heavy
                     hitter re-derives the residual plan from the sketched
                     HH set (`force_replan`): executors are cached by
                     (k, route specs), and the new session inherits the
                     old one's caps, so a plan with unchanged routing
                     costs one prepare on the warm step cache.  `stats`
                     counts `replacements` / `replans` and, in
                     `replace_compiles` / `replan_compiles`, those whose
                     step-cache key is new (0 on stable structure; a new
                     HH set builds a step, counted, never hidden).  A
                     re-plan sizes its plan from one batch, and prunes
                     each type combination that batch left empty in some
                     relation; before a batch runs, one that fills a
                     combination the current plan pruned (rows the plan
                     would route nowhere) re-plans on itself with the
                     plan's HHs, counted in `replans`.
                     Adaptation re-plans from the planner's plan, so an
                     executor made by `from_specs` (no plan) refuses it.

    One card runs the n_dev logical devices in one step, so it yields no
    per-device times: `timing_fn(wall_s) -> (n_devices,) seconds` defaults
    to the batch's wall time for every device, and a `ChaosInjector`
    supplies the faults deterministically (delays, dropped heartbeats,
    squeezed caps, corrupted rows) and the virtual clock the HealthMonitor
    runs on, advanced `step_seconds` a batch.

    Over a mesh of ranks (an executor made with `mesh=`) every rank builds
    the session with the same arguments (the chaos schedule and its seed
    too) and calls it in the same order, and every rank takes the same
    decision in the same batch: the same retry, eviction, re-placement and
    re-plan.  A decision reads only what is equal everywhere: the chaos
    injector's virtual clock and delays, the counters and count matrices
    the executor all-gathers, and the host's data (every rank holds the
    same).  The two rank-local readings are agreed by one broadcast of rank
    0's each time they are read: the batch's wall time (`timing_fn`'s
    argument, which must then give the same times on every rank) and,
    without a chaos injector, the HealthMonitor's clock (`time.monotonic`).
    An evicted logical device keeps its place in the mesh and receives no
    cell, and its rank still joins every collective; a rank's loss is the
    eviction of its L devices in one re-fold (`evict_rank`).  Re-plans
    build their executors over the same mesh, in the same order on every
    rank, and so share its process group."""

    def __init__(self, executor: ShardedJoinExecutor,
                 retry: RetryPolicy | None = None,
                 chaos: ChaosInjector | None = None,
                 heartbeat_timeout_s: float = 30.0,
                 suspect_timeout_s: float = 10.0,
                 straggler_threshold: float = 1.5,
                 evict_after: int = 5,
                 step_seconds: float = 1.0,
                 timing_fn: Callable[[float], np.ndarray] | None = None,
                 adapt: AdaptPolicy | None = None):
        if adapt is not None and executor.plan is None:
            raise ValueError(
                "SelfHealingSession(adapt=...): adaptation re-plans from the "
                "planner's plan, and an executor made by from_specs has no "
                "plan; build it from a SkewJoinPlan")
        self.executor = executor
        self.session: ExecutorSession = executor.session()
        self.retry = retry or RetryPolicy()
        self.chaos = chaos
        n = executor.n_devices
        # Over a mesh without chaos the monitor reads rank 0's clock.
        self._mesh_clock = (_MeshClock(self) if chaos is None
                            and executor.mesh is not None else None)
        clock = (chaos.clock if chaos is not None
                 else self._mesh_clock or time.monotonic)
        self.health = HealthMonitor(n, heartbeat_timeout_s,
                                    suspect_timeout_s, clock=clock)
        self.watchdog = StragglerWatchdog(n, threshold=straggler_threshold,
                                          evict_after=evict_after)
        self.alive: list[int] = list(range(n))
        self.evicted: list[int] = []
        self.refolds = 0
        self.refold_compiles = 0        # refolds whose caps left the bucket
        self.step_seconds = float(step_seconds)
        self.timing_fn = timing_fn
        # -- the adaptation axis (core/adapt.py) --
        self.adapt = adapt
        self.detector: DriftDetector | None = None
        self.replacements = 0
        self.replace_compiles = 0       # re-placements that left the bucket
        self.replans = 0
        self.replan_compiles = 0        # re-plans that missed the step cache
        # Executors keyed by (k, route specs): a re-derived plan with the
        # same HH set and residual structure maps to the SAME executor (and
        # its warm step cache) instead of a new one.
        self._plan_cache: dict[tuple, ShardedJoinExecutor] = {}
        self._prepared_data: Mapping[str, np.ndarray] | None = None
        self._last_data: Mapping[str, np.ndarray] | None = None
        self._last_counts: list[np.ndarray] | None = None
        self._retired_stats: dict | None = None   # superseded sessions' sums
        self._pruned: tuple | None = None   # (plan, its HHs, its pruned combos)

    def prepare(self, data: Mapping[str, np.ndarray], **kw
                ) -> "SelfHealingSession":
        """Prepare the wrapped session (chaos cap squeezes apply here) and,
        under `adapt=`, the drift detector around its cell loads."""
        self.session.prepare(data, **kw)
        if self.chaos is not None and self.session.caps:
            self.session.caps = self.chaos.squeeze(self.session.caps)
        self._prepared_data = data
        self._last_data = data
        if self.adapt is not None and self.executor.plan.residuals:
            plan = self.executor.plan
            attrs = tuple(plan.query.join_attributes())
            self.detector = DriftDetector(
                self.session.cell_loads(), self.adapt, attrs=attrs,
                hh_frac=self.adapt.hh_threshold_factor / plan.k,
                known_hhs={a: plan.hhs.values(a) for a in attrs})
            self._plan_cache[_struct_key(plan)] = self.executor
        return self

    @property
    def stats(self) -> dict:
        """The session's fault counters plus the loop's own.  A re-plan
        retires the wrapped session; its counters are folded in here, so
        the loop's history never resets."""
        s = {**self.session.stats}
        if self._retired_stats is not None:
            for key in ("batches", "retries", "escalations"):
                s[key] += self._retired_stats[key]
            for key in ("shuffle_overflow", "join_overflow"):
                s[key] = s[key] + self._retired_stats[key]
        return {**s,
                "evicted": list(self.evicted),
                "refolds": self.refolds,
                "refold_compiles": self.refold_compiles,
                "replacements": self.replacements,
                "replace_compiles": self.replace_compiles,
                "replans": self.replans,
                "replan_compiles": self.replan_compiles}

    def run_batch(self, chunks: Mapping[str, np.ndarray] | None = None):
        """One healed batch: evict the dead, run (retrying overflow), feed
        the monitors, evict fresh stragglers.  Returns the executor's
        result, free of overflow unless the retry budget raised."""
        ses, ex = self.session, self.executor
        if self.chaos is not None:
            chunks = self.chaos.mangle(chunks)
        # Failures detected since the last batch (heartbeats aged out).
        if self._mesh_clock is not None:
            self._mesh_clock.agree()
        self._evict([d for d in self.health.failed_nodes()
                     if d in self.alive])
        if self.detector is not None:
            self._replan_if_pruned(chunks if chunks is not None
                                   else self._prepared_data)
            ses, ex = self.session, self.executor
        t0 = time.perf_counter()
        try:
            res = ses.run_with_retry(chunks, self.retry)
        finally:
            # Virtual time passes even for a failed batch: a scheduled
            # fault fires once at its step.
            if self.chaos is not None:
                self.chaos.advance(self.step_seconds)
        wall = max(time.perf_counter() - t0, 1e-9)
        if ex.mesh is not None:
            wall, = _agreed(ex, [wall])
            if self._mesh_clock is not None:
                self._mesh_clock.agree()
        times = (self.timing_fn(wall) if self.timing_fn is not None
                 else np.full(ex.n_devices, wall))
        if self.chaos is not None:
            times = self.chaos.step_times(times)
        self.watchdog.record_step(times)
        beating = set(self.alive)
        if self.chaos is not None:
            beating -= self.chaos.dropped_heartbeats()
        for d in beating:
            self.health.heartbeat(d)
        self._evict([d for d in self.watchdog.to_evict()
                     if d in self.alive])
        if self.detector is not None:
            self._last_data = (chunks if chunks is not None
                               else self._prepared_data)
            self._observe_and_adapt()
        return res

    def evict_device(self, device: int) -> None:
        """Evict one device by hand (an operator's drain, an outside
        detector)."""
        self.evict_devices([device])

    def evict_devices(self, devices) -> None:
        """Evict several devices by hand in one re-fold."""
        for device in devices:
            if device not in self.alive:
                raise DeviceLossError(
                    f"device {device} is not alive (alive={self.alive}, "
                    f"evicted={self.evicted})")
        self._evict(list(devices))

    def evict_rank(self, rank: int) -> None:
        """A rank's loss over a mesh: its L logical devices [rank·L,
        (rank+1)·L) evicted in one re-fold, those already evicted left as
        they are.  The rank keeps running and joins every collective; it
        receives no cell."""
        ex = self.executor
        if ex.mesh is None:
            raise ValueError("evict_rank needs an executor over a mesh")
        if not 0 <= rank < ex.world:
            raise ValueError(f"rank {rank} outside [0, {ex.world})")
        lo = rank * ex.n_local
        self._evict(list(range(lo, lo + ex.n_local)))

    def _evict(self, devices: list[int]) -> None:
        devices = [d for d in devices if d in self.alive]
        if not devices:
            return
        survivors = [d for d in self.alive if d not in devices]
        if not survivors:
            raise DeviceLossError(
                f"cannot evict {sorted(devices)}: no surviving devices left "
                f"to re-fold {self.executor.k} cells onto")
        ses, ex = self.session, self.executor
        placement = lpt_placement(ses.cell_loads(), ex.n_devices,
                                  devices=survivors)
        ses.refold(placement)
        # The re-fold builds no step; caps leaving their bucket would, on
        # the next batch: counted here, by the step cache's key.
        if self._step_key(ses) not in ex._step_cache:
            self.refold_compiles += 1
        self.alive = survivors
        self.evicted.extend(sorted(devices))
        self.refolds += 1

    @staticmethod
    def _step_key(ses: ExecutorSession) -> tuple:
        """The step-cache key `ses`'s next batch looks up."""
        return (ses._shapes,
                tuple(ses.caps[r.name] for r in ses.executor.query.relations),
                ses.cap_out)

    # -- the adaptation axis (drift -> re-place -> re-plan) -------------------

    def _join_columns(self, data: Mapping[str, np.ndarray]
                      ) -> dict[str, dict[str, np.ndarray]]:
        """Per join attribute, the raw column of EACH relation holding it:
        one Misra–Gries stream per (attr, relation), as the exact
        detector thresholds each relation against its own size."""
        q = self.executor.plan.query
        return {a: {rel.name: np.asarray(data[rel.name])[:, rel.attrs.index(a)]
                    for rel in q.relations if a in rel.attrs}
                for a in self.detector.attrs}

    def _observe_and_adapt(self) -> None:
        """Feed the drift detector one executed batch and act on its
        verdict.  `count_batch` (one counting pass over the batch on the
        card) gives the per-cell loads; the raw join columns feed the
        sketches.  `assess` advances the patience streaks, so this runs
        exactly once a `run_batch`."""
        det = self.detector
        counts = self.session.count_batch()
        if not counts:
            return
        self._last_counts = counts
        loads = np.sum([c.sum(axis=0) for c in counts], axis=0)
        det.observe_loads(loads)
        if self._last_data is not None:
            det.observe_values(self._join_columns(self._last_data))
        action = det.assess()
        if action == "replace":
            self.force_replace()
        elif action == "replan":
            self.force_replan()

    @staticmethod
    def _refold_keep_warm(ses: ExecutorSession, placement,
                          counts: list[np.ndarray] | None) -> None:
        """Refold `ses` onto `placement`, preferring caps that stay in the
        bucket already built: a cap grows past its old value only when the
        raw worst (source, destination) routed count under the new
        placement exceeds it (the refold's own re-derivation applies
        `capacity_factor` headroom, which can push a cap one bucket up
        though the traffic never left the old one)."""
        ex = ses.executor
        old_caps = dict(ses.caps)
        ses.refold(placement, counts=counts)
        if counts is None:
            counts = ses._count_mats
        if counts is not None:
            fold = np.zeros((ex.k, ex.n_devices), np.int64)
            fold[np.arange(ex.k), placement.table] = 1
            for rel, c in zip(ex.query.relations, counts):
                raw = int((c @ fold).max())
                if rel.name in old_caps and raw <= old_caps[rel.name]:
                    ses.caps[rel.name] = old_caps[rel.name]
                else:
                    ses.caps[rel.name] = max(ses.caps[rel.name],
                                             old_caps.get(rel.name, 0))
        else:
            ses.caps = {name: max(old_caps.get(name, c), c)
                        for name, c in ses.caps.items()}

    def force_replace(self) -> None:
        """Re-run LPT on the OBSERVED cell loads and swap the placement
        table: the mild-drift response.  Caps are re-derived from the
        observed count matrices but never shrink below the ones already
        built, so a re-placement on stable structure builds no step."""
        ses = self.session
        det = self.detector
        loads = None
        if det is not None:
            loads = det.observed_cell_loads()
            if not np.any(loads):
                loads = None
        if loads is None:
            loads = ses.cell_loads()
        placement = lpt_placement(
            loads, self.executor.n_devices,
            devices=self.alive if self.evicted else None)
        had_run = ses._last_args is not None
        self._refold_keep_warm(ses, placement, self._last_counts)
        if had_run and self._step_key(ses) not in self.executor._step_cache:
            self.replace_compiles += 1
        self.replacements += 1
        if det is not None:
            det.rebaseline(loads, action="replace")

    def force_replan(self) -> None:
        """Re-derive the residual plan from the sketched HH set and swap
        the wrapped session: the threshold-drift / new-heavy-hitter
        response.

        The last executed batch sizes the plan.  Executors are cached by
        (k, route specs), so a plan with unchanged routing reuses the SAME
        executor (warm step cache), and the new session inherits the old
        one's caps: one prepare, no step built.  A new plan makes a new
        executor on the old one's device, which builds its step on the next
        batch: counted in `replan_compiles`, never hidden."""
        det = self.detector
        if det is None:
            raise RuntimeError(
                "force_replan needs adapt=AdaptPolicy(...) (no detector)")
        sample = (self._last_data if self._last_data is not None
                  else self._prepared_data)
        if sample is None:
            raise RuntimeError("force_replan before prepare()")
        self._replan(sample, det.sketched_hhs())

    def _replan_if_pruned(self, data: Mapping[str, np.ndarray]) -> None:
        """Before a batch runs: if every relation of `data` has rows in a
        type combination the current plan pruned (its sample had none of
        them in some relation, so the plan has no residual join for them
        and its routing would drop them), re-plan on `data` with the
        plan's own HHs, counted in `replans`."""
        plan = self.executor.plan
        if self._pruned is None or self._pruned[0] is not plan:
            self._pruned = (plan, *pruned_combos(plan))
        _, hh, pruned = self._pruned
        if len(pruned) and fills_pruned(plan.query, data, hh, pruned):
            self._replan(data, plan.hhs)

    def _replan(self, sample: Mapping[str, np.ndarray], hhs) -> None:
        """Plan on `sample` (its sizes) with the HH set `hhs` and swap the
        wrapped session (see `force_replan`)."""
        ses, ex = self.session, self.executor
        det = self.detector
        plan = ex.plan
        new_plan = plan_from_hhs(plan.query, sample, plan.k, hhs)
        key = _struct_key(new_plan)
        ex2 = self._plan_cache.get(key)
        if ex2 is None:
            ex2 = ShardedJoinExecutor(new_plan, ex.n_devices, ex.config,
                                      device=ex.device, mesh=ex.mesh)
            self._plan_cache[key] = ex2
        ses2 = ex2.session()
        # Prepare on the ORIGINAL prepared data, so the session shapes (the
        # step-cache key's first part) are the old session's and chunks pad
        # up to them as before.  `sample` only sized the plan.
        anchor = (self._prepared_data if self._prepared_data is not None
                  else sample)
        ses2.prepare(anchor, caps=dict(ses.caps) or None)
        ses2.cap_out = ses.cap_out
        # Re-place the new session for the traffic that triggered the
        # re-plan.  With unchanged routing (a plan-cache hit) the observed
        # window lives in the same cell space, so the OBSERVED loads drive
        # LPT; otherwise a warm re-plan would reset the fold to the anchor
        # data's.  A new plan redefines the cells: only the anchor's loads
        # under the new routing mean anything then.
        alive = self.alive if self.evicted else None
        obs_loads = det.observed_cell_loads()
        if ex2 is ex and np.any(obs_loads):
            self._refold_keep_warm(
                ses2, lpt_placement(obs_loads, ex2.n_devices, devices=alive),
                self._last_counts)
        elif self.evicted:
            # Degraded mode survives the re-plan: fold the new plan's cells
            # over the survivors only, keeping inherited caps warm.
            self._refold_keep_warm(
                ses2, lpt_placement(ses2.cell_loads(), ex2.n_devices,
                                    devices=self.alive), None)
        if ses2._shapes is not None and ses2._shapes != ():
            if self._step_key(ses2) not in ex2._step_cache:
                self.replan_compiles += 1
        # Retire the old session's counters so `stats` stays cumulative.
        old = ses.stats
        if self._retired_stats is None:
            self._retired_stats = {
                "batches": 0, "retries": 0, "escalations": 0,
                "shuffle_overflow": np.zeros_like(old["shuffle_overflow"]),
                "join_overflow": np.zeros_like(old["join_overflow"]),
            }
        for name in ("batches", "retries", "escalations", "shuffle_overflow",
                     "join_overflow"):
            self._retired_stats[name] += old[name]
        warm_hit = ex2 is ex
        self.session, self.executor = ses2, ex2
        self._last_counts = None        # the old plan's routing
        self.replans += 1
        # New baseline: with unchanged routing (a cache hit) the observed
        # window is in the right cell space and IS the best estimate of
        # current traffic; rebaselining to the anchor's loads would leave
        # the detector drifted against a stream that has shifted (replan
        # thrash).  A new plan redefines the cells: the anchor's loads
        # under the NEW routing are the only meaningful baseline.
        obs = det.observed_cell_loads()
        base = obs if warm_hit and np.any(obs) else ses2.cell_loads()
        det.rebaseline(
            base, action="replan",
            known_hhs={a: new_plan.hhs.values(a) for a in det.attrs})
