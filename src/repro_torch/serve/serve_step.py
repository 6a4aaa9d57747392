"""Serve-step builders: prefill and batched greedy decode on one device.

`build_decode_step` / `build_prefill` return the functions the serving
engine calls, with the device they run on.  The reference also builds
mesh shardings for parameters and caches; on one card there are none.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..configs.base import ArchConfig
from ..core.executor import resolve_device
from ..models import api


@dataclass
class ServeFns:
    decode: Callable | None
    prefill: Callable | None
    device: torch.device
    batch: int | None = None       # decode: the slots the cache holds
    max_seq: int | None = None     # decode: the cache's length


def build_decode_step(cfg: ArchConfig, batch: int, max_seq: int, *,
                      device=None) -> ServeFns:
    """decode(params, cache, tokens (B,1), pos (B,)) -> (next token (B,)
    int32, cache): one step of every slot, greedy on the last position.
    The cache ((L, batch, max_seq, ...) leaves) is updated in place."""
    dev = resolve_device(device)
    api.family_module(cfg)

    def decode(params, cache, tokens, pos):
        if tuple(cache["k"].shape[1:3]) != (batch, max_seq):
            raise ValueError(f"cache holds {tuple(cache['k'].shape[1:3])} "
                             f"(slots, positions); the step was built for "
                             f"{(batch, max_seq)}")
        lg, cache = api.decode_step(params, cfg, cache,
                                    {"tokens": tokens.to(dev)}, pos.to(dev))
        # Greedy sampling on the card: serving returns token ids, not logits.
        next_tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)
        return next_tok, cache

    return ServeFns(decode=decode, prefill=None, device=dev, batch=batch,
                    max_seq=max_seq)


def build_prefill(cfg: ArchConfig, *, device=None) -> ServeFns:
    """prefill(params, batch) -> last-position logits (B, padded_vocab): a
    full forward over the prompts that never makes full-sequence logits."""
    dev = resolve_device(device)
    api.family_module(cfg)

    def prefill_fn(params, batch):
        batch = {k: v.to(dev) for k, v in batch.items()}
        logits, _ = api.forward(params, cfg, batch, last_only=True)
        return logits[:, -1]

    return ServeFns(decode=None, prefill=prefill_fn, device=dev)
