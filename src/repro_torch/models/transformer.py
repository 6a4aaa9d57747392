"""Dense decoder-only transformer: so far only its KV cache, which the MoE
family shares (`moe.init_cache` delegates here).  The dense family's
layers, forward, prefill and decode are still to be ported (ROADMAP
item 9)."""
from __future__ import annotations

import torch

from ..core.executor import resolve_device


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device=None) -> dict:
    """Zeroed KV cache {"k", "v"}, each (n_layers, batch, max_seq,
    n_kv_heads, head_dim), on the card unless the caller asks for the
    CPU."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd())
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}
