"""Model API over the ported families (so far: "moe").

Every entry point takes a `batch` dict, as the reference's does
(`batch["tokens"]` (B, S) int32), so serving code never branches on family:

  forward(...) -> (logits, aux) with aux the MoE stats (aux_loss,
  expert_load).

The dense, ssm, hybrid, encdec and vlm families are still to be ported
(ROADMAP item 9): asking for one raises NotImplementedError.
"""
from __future__ import annotations

from typing import Any

import torch

from .common import Layout, init_params
from . import moe

_FAMILIES = {"moe": moe}


def family_module(cfg):
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported yet "
            f"(ROADMAP item 9); ported: {sorted(_FAMILIES)}") from None


def layout(cfg) -> Layout:
    return family_module(cfg).layout(cfg)


def build(cfg, tensors: dict):
    """The family's model over a layout-shaped tree of tensors."""
    return family_module(cfg).build(cfg, tensors)


def init_model(cfg, generator: torch.Generator, *, device=None,
               dtype: torch.dtype = torch.bfloat16):
    """A model with random parameters from `generator` (see
    common.init_params), on the card unless the caller asks for the CPU."""
    return build(cfg, init_params(layout(cfg), generator, device=device,
                                  dtype=dtype))


def forward(params, cfg, batch: dict, last_only: bool = False
            ) -> tuple[torch.Tensor, dict[str, Any]]:
    return family_module(cfg).forward(params, cfg, batch["tokens"],
                                      last_only=last_only)


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device=None):
    return family_module(cfg).init_cache(cfg, batch, max_seq, dtype,
                                         device=device)


def decode_step(params, cfg, cache, batch: dict, pos):
    return family_module(cfg).decode_step(params, cfg, cache, batch["tokens"],
                                          pos)


def prefill(params, cfg, batch: dict, cache):
    return family_module(cfg).prefill(params, cfg, batch["tokens"], cache)
