"""Serving engines: continuous-batching decode + the self-healing join loop.

`ServingEngine` — a fixed pool of B sequence slots runs one decode step per
tick; requests are admitted into free slots as others finish (continuous
batching).  Prompt ingestion replays prompt tokens through the same decode
step (one step function serves both phases; `build_prefill` is the
bulk-prompt path).  Greedy sampling; per-request max_new_tokens;
deterministic given (params, prompts).  Slot bookkeeping is host-side
numpy; the device state is the KV cache.

`SelfHealingSession` — the fault-tolerant loop around a join
`ExecutorSession`: capacity overflow heals by bounded retry on the
capacity grid; device loss (missed heartbeats) and persistent stragglers
heal by evicting the device and re-folding the logical cells over the
survivors.  Drift adaptation (the reference's `adapt=`) is still to be
ported (ROADMAP item 6).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Mapping

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.executor import (DeviceLossError, ExecutorSession, RetryPolicy,
                             ShardedJoinExecutor, resolve_device)
from ..core.placement import lpt_placement
from ..ft import ChaosInjector, HealthMonitor, StragglerWatchdog
from ..models import api
from .serve_step import ServeFns, build_decode_step


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    out: list[int] = field(default_factory=list)
    done: bool = False


class ServingEngine:
    """B slots over one KV cache (bf16, as the reference's), on the card
    unless the caller asks for the CPU."""

    def __init__(self, cfg: ArchConfig, batch_slots: int, max_seq: int,
                 params, fns: ServeFns | None = None, *, device=None):
        self.cfg = cfg
        self.B, self.max_seq = batch_slots, max_seq
        self.device = resolve_device(device)
        self.fns = fns or build_decode_step(cfg, batch_slots, max_seq,
                                            device=self.device)
        self.params = params.to(self.device)
        self.cache = api.init_cache(cfg, batch_slots, max_seq,
                                    device=self.device)
        self.queue: list[Request] = []
        self.waiting: deque[Request] = deque()   # FIFO of unadmitted requests
        self.slots: list[Request | None] = [None] * batch_slots
        # Per-slot host state.
        self.pos = np.zeros(batch_slots, np.int32)
        self.pending = [[] for _ in range(batch_slots)]   # prompt tokens left
        self.next_tok = np.zeros(batch_slots, np.int32)
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
        """Zero slot i's state in place (KV rows are masked by position;
        the reference zeroes them all the same).  Convention: batch axis is
        1 for rank≥3 cache leaves ((L,B,...) stacked), 0 for rank≤2."""
        for a in self.cache.values():
            if a.dim() >= 3:
                a[:, i] = 0
            elif a.dim() >= 1:
                a[i] = 0

    def _tick(self) -> None:
        # Feed: prompt token if any pending, else the last generated token.
        toks = torch.from_numpy(self.next_tok[:, None].copy())
        pos = torch.from_numpy(self.pos.copy())
        nxt, self.cache = self.fns.decode(self.params, self.cache, toks, pos)
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
                     through the same re-fold.

    One card runs the n_dev logical devices in one step, so it yields no
    per-device times: `timing_fn(wall_s) -> (n_devices,) seconds` defaults
    to the batch's wall time for every device, and a `ChaosInjector`
    supplies the faults deterministically (delays, dropped heartbeats,
    squeezed caps, corrupted rows) and the virtual clock the HealthMonitor
    runs on, advanced `step_seconds` a batch.  `adapt=` (drift adaptation)
    is not ported yet and raises."""

    def __init__(self, executor: ShardedJoinExecutor,
                 retry: RetryPolicy | None = None,
                 chaos: ChaosInjector | None = None,
                 heartbeat_timeout_s: float = 30.0,
                 suspect_timeout_s: float = 10.0,
                 straggler_threshold: float = 1.5,
                 evict_after: int = 5,
                 step_seconds: float = 1.0,
                 timing_fn: Callable[[float], np.ndarray] | None = None,
                 adapt=None):
        if adapt is not None:
            raise NotImplementedError(
                "SelfHealingSession(adapt=...): drift adaptation is not "
                "ported yet (ROADMAP item 6)")
        self.executor = executor
        self.session: ExecutorSession = executor.session()
        self.retry = retry or RetryPolicy()
        self.chaos = chaos
        n = executor.n_devices
        clock = chaos.clock if chaos is not None else time.monotonic
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

    def prepare(self, data: Mapping[str, np.ndarray], **kw
                ) -> "SelfHealingSession":
        """Prepare the wrapped session (chaos cap squeezes apply here)."""
        self.session.prepare(data, **kw)
        if self.chaos is not None and self.session.caps:
            self.session.caps = self.chaos.squeeze(self.session.caps)
        return self

    @property
    def stats(self) -> dict:
        """The session's fault counters plus the loop's own."""
        return {**self.session.stats,
                "evicted": list(self.evicted),
                "refolds": self.refolds,
                "refold_compiles": self.refold_compiles}

    def run_batch(self, chunks: Mapping[str, np.ndarray] | None = None):
        """One healed batch: evict the dead, run (retrying overflow), feed
        the monitors, evict fresh stragglers.  Returns the executor's
        result, free of overflow unless the retry budget raised."""
        ses, ex = self.session, self.executor
        if self.chaos is not None:
            chunks = self.chaos.mangle(chunks)
        # Failures detected since the last batch (heartbeats aged out).
        self._evict([d for d in self.health.failed_nodes()
                     if d in self.alive])
        t0 = time.perf_counter()
        try:
            res = ses.run_with_retry(chunks, self.retry)
        finally:
            # Virtual time passes even for a failed batch: a scheduled
            # fault fires once at its step.
            if self.chaos is not None:
                self.chaos.advance(self.step_seconds)
        wall = max(time.perf_counter() - t0, 1e-9)
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
        return res

    def evict_device(self, device: int) -> None:
        """Evict one device by hand (an operator's drain, an outside
        detector)."""
        if device not in self.alive:
            raise DeviceLossError(
                f"device {device} is not alive (alive={self.alive}, "
                f"evicted={self.evicted})")
        self._evict([device])

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
        key = (ses._shapes,
               tuple(ses.caps[r.name] for r in ex.query.relations),
               ses.cap_out)
        if key not in ex._step_cache:
            self.refold_compiles += 1
        self.alive = survivors
        self.evicted.extend(sorted(devices))
        self.refolds += 1
