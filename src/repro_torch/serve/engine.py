"""Continuous-batching decode engine.

`ServingEngine` — a fixed pool of B sequence slots runs one decode step per
tick; requests are admitted into free slots as others finish (continuous
batching).  Prompt ingestion replays prompt tokens through the same decode
step (one step function serves both phases; `build_prefill` is the
bulk-prompt path).  Greedy sampling; per-request max_new_tokens;
deterministic given (params, prompts).  Slot bookkeeping is host-side
numpy; the device state is the KV cache.

The reference's `SelfHealingSession` (the fault-tolerant join loop) is
still to be ported (ROADMAP item 5).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.executor import resolve_device
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
