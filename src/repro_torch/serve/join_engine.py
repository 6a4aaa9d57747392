"""Multi-tenant join serving: continuous batching over many live plans.

The paper's machinery optimizes ONE multiway join; "millions of users" is a
stream of many heterogeneous joins.  This module is the serving layer that
keeps many SkewShares plans resident and busy on one card, in the same
continuous-batching idiom as `ServingEngine`'s decode loop:

  admission   `submit(tenant, query, data)` enqueues a `JoinRequest` on the
              tenant's FIFO; the tenant's plan is derived from its first
              request's data (tenants are streams with a stable skew
              profile; following drift is the adaptation axis's job), and
              re-derived only from a request with rows in a type
              combination the plan pruned as empty, which it would
              otherwise drop (per-tenant `replans`);
  bucketing   each request's per-relation row counts are quantized UP onto
              the same geometric grid the capacity bucketing uses
              (`quantize_capacity`), so near-sized requests pad onto one
              prepared shape and share a built step instead of building one
              per exact size;
  caching     `ExecutableCache` — the engine-level generalization of the
              per-executor step cache and the self-healing session's
              route-spec-keyed plan cache.  Two bounded LRUs: executors
              keyed by structural signature `(k, sorted route specs)` (two
              tenants whose plans route identically share one executor and
              its warm step cache), sessions keyed by `(structure, shape
              bucket)` (capacities ride inside the executor's own step-cache
              key, derived at prepare).  Hit/miss/eviction counted;
              evicting a session keeps its executor's steps warm, so a later
              re-prepare of the same bucket builds NOTHING;
  scheduling  `step_round()` admits up to `max_live` tenants with pending
              work in round-robin arrival order, then serves the picked
              batch in LPT order (heaviest prepare-time load first — the
              same greedy that places cells, riding the count-matrix pass
              the session already ran), one request per tenant per round;
  accounting  per-tenant stats split out of the shared sessions by
              before/after snapshots: requests, batches, rows in/out,
              retries, escalations, overflow, compiles, prepares,
              re-placements and re-plans — plus the
              engine-level cache counters a steady-state run gates on
              (zero step builds, hit rate 1.0).

A request's valid rows are compacted on the executor's device before they
are copied to the host, so only they cross PCIe, never the whole
(n_dev·cap_out, w) output.

Over a mesh of W ranks (`mesh=`, from `launch.mesh.make_join_mesh`, W
dividing n_devices) every executor the engine builds runs over it, and
every rank builds the engine with the same arguments and submits the same
requests in the same order.  The pick, round robin, LRU evictions and
per-tenant drift bank read only the requests' data and the counters the
executors all-gather, so every rank takes the same decisions and every
counter of `stats` is equal on every rank (`rows_out` sums the ranks'
rows, one all_reduce a request).  A request's `rows` on a rank
are its own L destinations' valid rows, compacted on its device; put
together in rank order they are the one-process engine's `rows`, bit for
bit (as `BatchResult`'s 'rows' and 'valid').

Optional per-tenant adaptation: pass `adapt=AdaptPolicy(...)` and each
tenant's executed batches feed its own `DriftDetector` in a
`TenantDriftBank` (core/adapt.py); a drifted tenant gets an observed-load
LPT re-placement through the same keep-warm refold the self-healing session
uses — no step built, and one tenant's drift never perturbs another's
baseline.
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist

from ..core.adapt import AdaptPolicy, TenantDriftBank
from ..core.executor import (INVALID, BatchResult, ExecutorConfig,
                             ExecutorSession, RetryPolicy,
                             ShardedJoinExecutor, _struct_key, mesh_device,
                             quantize_capacity, resolve_device)
from ..core.placement import lpt_placement
from ..core.plan import JoinQuery
from ..core.residual import enumerate_combinations
from ..core.skewjoin import (SkewJoinPlan, fills_pruned, plan_skew_join,
                             pruned_combos)
from .engine import SelfHealingSession


@dataclass
class JoinRequest:
    """One tenant's join-the-current-batch request."""
    rid: int
    tenant: str
    query: JoinQuery
    data: Mapping[str, np.ndarray]
    bucket: tuple[int, ...] | None = None   # per-relation padded row counts
    rows: np.ndarray | None = None          # valid join rows, set when done
    latency_s: float = 0.0                  # the run + the rows on the host
    copy_s: float = 0.0                     # of it: the rows' copy to the host
    done: bool = False


def _valid_rows(res) -> np.ndarray:
    """A result's valid rows on the host, compacted where they lie first."""
    if not isinstance(res, BatchResult):         # a provably empty join
        return res["rows"][res["valid"]]
    out, valid = res.tensors[:2]
    return out.reshape(-1, out.shape[-1])[valid.reshape(-1)].cpu().numpy()


def _total_rows(ex: ShardedJoinExecutor, n: int) -> int:
    """A request's valid rows over every rank of `ex`'s mesh (one
    all_reduce), `n` in one process."""
    if ex.mesh is None:
        return n
    t = torch.tensor([n], dtype=torch.int64, device=ex.device)
    dist.all_reduce(t, group=ex.group)
    return int(t.item())


class ExecutableCache:
    """Bounded two-level LRU over prepared sessions and their executors.

    Level 1 (`max_executors`): `ShardedJoinExecutor`s keyed by structural
    signature — each owns the step cache and its counters.  Level 2
    (`max_sessions`): prepared `ExecutorSession`s keyed by `(structure,
    shape bucket)` — relations resident on the device + derived
    placement/capacities, cheap to rebuild while the executor is resident.
    Evicting a session therefore costs one count pass on the next miss but
    ZERO step builds (the executor's step cache still holds the bucket's
    step); evicting an executor is the real cliff and is counted
    separately.  Build/step counters of evicted executors are accumulated
    into `retired_*` so engine-level deltas never go backwards."""

    def __init__(self, max_sessions: int = 8, max_executors: int = 4):
        if max_sessions < 1 or max_executors < 1:
            raise ValueError("cache bounds must be ≥ 1")
        self.max_sessions = int(max_sessions)
        self.max_executors = int(max_executors)
        self._executors: OrderedDict[tuple, ShardedJoinExecutor] = OrderedDict()
        self._sessions: OrderedDict[tuple, ExecutorSession] = OrderedDict()
        self.hits = 0                   # session-level warm lookups
        self.misses = 0                 # session-level prepares
        self.evictions = 0              # sessions dropped by the bound
        self.executor_evictions = 0     # executors dropped (steps lost)
        self.retired_compiles = 0
        self.retired_step_hits = 0
        self.retired_evicted_steps = 0

    # -- executors ------------------------------------------------------------
    def executor(self, key: tuple, build) -> ShardedJoinExecutor:
        ex = self._executors.pop(key, None)
        if ex is None:
            ex = build()
            while len(self._executors) >= self.max_executors:
                old_key, old = self._executors.popitem(last=False)
                self.retired_compiles += old.compile_count
                self.retired_step_hits += old.step_hits
                self.retired_evicted_steps += old.evicted_steps
                self.executor_evictions += 1
                # Sessions of a retired executor would pin it (and its
                # device memory) alive behind the bound's back — drop them.
                for skey in [s for s in self._sessions if s[0] == old_key]:
                    del self._sessions[skey]
                    self.evictions += 1
        self._executors[key] = ex       # (re-)insert at MRU position
        return ex

    # -- sessions -------------------------------------------------------------
    def session(self, key: tuple, prepare) -> tuple[ExecutorSession, bool]:
        """Warm session for `key` = (struct_key, bucket), else `prepare()`d
        fresh one.  Returns (session, was_hit)."""
        ses = self._sessions.pop(key, None)
        if ses is not None:
            self._sessions[key] = ses
            self.hits += 1
            return ses, True
        ses = prepare()
        while len(self._sessions) >= self.max_sessions:
            self._sessions.popitem(last=False)
            self.evictions += 1
        self._sessions[key] = ses
        self.misses += 1
        return ses, False

    # -- accounting -----------------------------------------------------------
    def compile_count(self) -> int:
        """Total steps ever built through this cache (live + retired
        executors) — the steady-state zero-build gate reads deltas of this,
        so it must never decrease."""
        return self.retired_compiles + sum(e.compile_count
                                           for e in self._executors.values())

    @property
    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "sessions": len(self._sessions),
            "executors": len(self._executors),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "executor_evictions": self.executor_evictions,
            "hit_rate": self.hits / total if total else 0.0,
            "compiles": self.compile_count(),
            "step_hits": self.retired_step_hits + sum(
                e.step_hits for e in self._executors.values()),
            "evicted_steps": self.retired_evicted_steps + sum(
                e.evicted_steps for e in self._executors.values()),
        }


@dataclass
class _Tenant:
    """Host-side state of one query stream."""
    name: str
    queue: deque = field(default_factory=deque)     # unadmitted JoinRequests
    plan: SkewJoinPlan | None = None
    struct_key: tuple | None = None
    hh_vals: dict = field(default_factory=dict)     # the plan's, sorted
    pruned: np.ndarray | None = None                # its pruned combinations
    load_estimate: float = 0.0      # prepare-time routed-copy load (LPT key)
    stats: dict = field(default_factory=lambda: {
        "requests": 0, "batches": 0, "rows_in": 0, "rows_out": 0,
        "retries": 0, "escalations": 0, "overflow": 0,
        "compiles": 0, "prepares": 0, "replacements": 0, "replans": 0})


class JoinServingEngine:
    """Continuous-batching front-end over `ExecutorSession`s on one device.

    `submit()` requests from any number of tenants, then `run()` (or
    `step_round()` under external control).  One engine = n_devices
    logical servers on one device = one `ExecutorConfig`; `k` (the plans'
    logical cells) defaults to n_devices.  Runs on the card unless given
    `device="cpu"`, and every executor it builds gets that device.  With
    `mesh=` the n_devices logical servers run over the mesh's W ranks (W
    dividing n_devices; the device defaults to the rank's), and a request's
    `rows` are the rank's own destinations' (module docstring).  See the
    module docstring for the architecture and `ExecutableCache` for what is
    shared between tenants."""

    def __init__(self, n_devices: int = 8,
                 config: ExecutorConfig = ExecutorConfig(),
                 retry: RetryPolicy | None = None,
                 k: int | None = None,
                 shape_bucket: float = 2.0,
                 max_live: int = 4,
                 max_sessions: int = 8,
                 max_executors: int = 4,
                 adapt: AdaptPolicy | None = None,
                 *, device=None, mesh=None):
        self.n_devices, self.config = int(n_devices), config
        self.mesh = mesh
        if mesh is not None:
            if self.n_devices % mesh.size():
                raise ValueError(
                    f"{mesh.size()} ranks do not divide n_devices="
                    f"{self.n_devices}: each rank holds n_devices / W "
                    f"logical devices")
            if device is None:
                device = mesh_device(mesh)
        self.device = resolve_device(device)
        self.retry = retry or RetryPolicy()
        self.k = int(k) if k is not None else self.n_devices
        self.shape_bucket = float(shape_bucket)
        self.max_live = int(max_live)
        self.cache = ExecutableCache(max_sessions, max_executors)
        self.tenants: dict[str, _Tenant] = {}
        self._arrival: list[str] = []   # tenant names in first-seen order
        self._rr = 0                    # round-robin rotation pointer
        self.adapt = TenantDriftBank(adapt) if adapt is not None else None
        self.rounds = 0
        self.requests = 0
        self._next_rid = 0

    # -- admission ------------------------------------------------------------
    def submit(self, tenant: str, query: JoinQuery,
               data: Mapping[str, np.ndarray]) -> JoinRequest:
        t = self.tenants.get(tenant)
        if t is None:
            t = _Tenant(tenant)
            self.tenants[tenant] = t
            self._arrival.append(tenant)
        if t.plan is not None and t.plan.query != query:
            raise ValueError(
                f"tenant {tenant!r} switched query structure "
                f"({t.plan.query} -> {query}); use a new tenant id per "
                f"query shape")
        req = JoinRequest(self._next_rid, tenant, query, dict(data))
        self._next_rid += 1
        t.queue.append(req)
        return req

    def _bucket(self, query: JoinQuery, data: Mapping[str, np.ndarray]
                ) -> tuple[int, ...]:
        """Quantize per-relation row counts UP onto the geometric shape grid
        (same grid discipline as capacity bucketing): requests whose sizes
        fall in one bucket pad onto one prepared shape."""
        return tuple(quantize_capacity(max(len(data[r.name]), 1),
                                       self.shape_bucket)
                     for r in query.relations)

    def _ensure_plan(self, t: _Tenant, req: JoinRequest) -> None:
        """Plan the tenant on its first request; re-plan it on a request
        with rows in a type combination its plan pruned (the plan has no
        residual join for them and would drop them), counted in the
        tenant's `replans`."""
        if t.plan is not None:
            if not fills_pruned(req.query, req.data, t.hh_vals, t.pruned):
                return
            t.stats["replans"] += 1
            if self.adapt is not None:      # the cells are the new plan's
                self.adapt.detectors.pop(t.name, None)
        t.plan = plan_skew_join(req.query, req.data, self.k)
        t.struct_key = _struct_key(t.plan)
        t.hh_vals, t.pruned = pruned_combos(t.plan)

    def _session_for(self, t: _Tenant, req: JoinRequest
                     ) -> tuple[ExecutorSession, tuple]:
        self._ensure_plan(t, req)
        req.bucket = self._bucket(req.query, req.data)
        skey = (t.struct_key, req.bucket)
        ex = self.cache.executor(
            t.struct_key,
            lambda: ShardedJoinExecutor(t.plan, self.n_devices, self.config,
                                        device=self.device, mesh=self.mesh))

        def prepare() -> ExecutorSession:
            # Pad each relation with INVALID rows up to the bucket: invalid
            # rows route nowhere, so the prepared placement/capacities are
            # those of the real data, at the bucket's warm shape.
            padded = {}
            for i, rel in enumerate(t.plan.query.relations):
                arr = np.asarray(req.data[rel.name])
                n_pad = req.bucket[i] - len(arr)
                if n_pad > 0:
                    pad = np.full((n_pad, arr.shape[1]), INVALID, arr.dtype)
                    arr = np.concatenate([arr, pad])
                padded[rel.name] = arr
            ses = ex.session().prepare(padded)
            t.stats["prepares"] += 1
            if t.plan.residuals:
                t.load_estimate = float(ses.cell_loads().sum())
            return ses

        ses, _ = self.cache.session(skey, prepare)
        return ses, skey

    # -- serving --------------------------------------------------------------
    def _serve(self, t: _Tenant, req: JoinRequest) -> None:
        ses, _ = self._session_for(t, req)
        s0 = ses.stats
        snap = (s0["batches"], s0["retries"], s0["escalations"],
                int(s0["shuffle_overflow"].sum() + s0["join_overflow"].sum()))
        c0 = self.cache.compile_count()
        t0 = time.perf_counter()
        res = ses.run_with_retry(req.data, self.retry)
        t1 = time.perf_counter()        # overflow read: the run has ended
        rows = _valid_rows(res)
        req.latency_s = time.perf_counter() - t0
        req.copy_s = req.latency_s - (t1 - t0)
        req.rows, req.done = rows, True
        s1 = ses.stats
        st = t.stats
        st["requests"] += 1
        st["batches"] += s1["batches"] - snap[0]
        st["retries"] += s1["retries"] - snap[1]
        st["escalations"] += s1["escalations"] - snap[2]
        st["overflow"] += int(s1["shuffle_overflow"].sum()
                              + s1["join_overflow"].sum()) - snap[3]
        st["compiles"] += self.cache.compile_count() - c0
        st["rows_in"] += sum(len(req.data[r.name])
                             for r in req.query.relations)
        st["rows_out"] += _total_rows(ses.executor, len(rows))
        self.requests += 1
        if self.adapt is not None:
            self._observe(t, ses, req)

    def _observe(self, t: _Tenant, ses: ExecutorSession,
                 req: JoinRequest) -> None:
        """Feed the tenant's drift detector one executed batch; a drifted
        tenant gets an observed-load LPT re-placement through the keep-warm
        refold (no step built) — per tenant, so one stream's drift never
        rebaselines another's detector."""
        if not t.plan.residuals:
            return
        det = self.adapt.get(t.name)
        if det is None:
            # Lazy per-tenant registration at first observation — a tenant
            # whose requests only ever HIT another tenant's cached session
            # never runs prepare, so the baseline is the serving session's
            # prepare-time loads (same cell space: shared structure).
            plan = t.plan
            attrs = tuple(plan.query.join_attributes())
            det = self.adapt.register(
                t.name, ses.cell_loads(), attrs=attrs,
                hh_frac=self.adapt.policy.hh_threshold_factor / plan.k,
                known_hhs={a: plan.hhs.values(a) for a in attrs})
        counts = ses.count_batch()
        if not counts:
            return
        loads = np.sum([c.sum(axis=0) for c in counts], axis=0)
        cols = {a: {rel.name: np.asarray(req.data[rel.name])[
                        :, rel.attrs.index(a)]
                    for rel in t.plan.query.relations if a in rel.attrs}
                for a in det.attrs}
        verdict = self.adapt.observe(t.name, loads, cols)
        if verdict == "stable":
            return
        obs = det.observed_cell_loads()
        placement = lpt_placement(obs, ses.executor.n_devices)
        SelfHealingSession._refold_keep_warm(ses, placement, counts)
        t.stats["replacements"] += 1
        t.load_estimate = float(obs.sum())
        self.adapt.rebaseline(t.name, obs, action=verdict)

    # -- scheduling -----------------------------------------------------------
    def _pick(self) -> list[_Tenant]:
        """Up to `max_live` tenants with pending work, round-robin from the
        rotation pointer (admission fairness), then LPT-ordered (heaviest
        prepare-time load first) for execution."""
        names = self._arrival
        if not names:
            return []
        picked: list[_Tenant] = []
        for i in range(len(names)):
            t = self.tenants[names[(self._rr + i) % len(names)]]
            if t.queue:
                picked.append(t)
                if len(picked) >= self.max_live:
                    break
        self._rr = (self._rr + 1) % len(names)
        picked.sort(key=lambda t: -t.load_estimate)
        return picked

    def step_round(self) -> int:
        """Serve one request from each scheduled tenant; returns how many."""
        picked = self._pick()
        for t in picked:
            req = t.queue.popleft()
            self._serve(t, req)
        if picked:
            self.rounds += 1
        return len(picked)

    def run(self, max_rounds: int = 10_000) -> None:
        """Drain every tenant queue (bounded by `max_rounds`)."""
        for _ in range(max_rounds):
            if self.step_round() == 0:
                return

    @property
    def stats(self) -> dict:
        return {
            "requests": self.requests,
            "rounds": self.rounds,
            "compiles": self.cache.compile_count(),
            "cache": self.cache.stats,
            "tenants": {name: dict(t.stats)
                        for name, t in self.tenants.items()},
        }
