"""Architecture registry + input_specs for every (arch x shape) cell.

A copy of the reference package's `configs/` (plain dataclasses).
`input_specs(cfg, shape)` returns meta tensors (shapes and dtypes, no
storage) for every model input of that cell, where the reference returns
`jax.ShapeDtypeStruct`s for its dry run.
"""
from __future__ import annotations

import torch

from .base import SHAPES, ArchConfig, ShapeCell, cell_applicable
from . import (kimi_k2_1t_a32b, llama_3_2_vision_90b, mamba2_370m,
               mixtral_8x22b, phi3_medium_14b, qwen2_0_5b, qwen3_14b,
               seamless_m4t_medium, starcoder2_15b, zamba2_7b)

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG for m in (
        qwen2_0_5b, starcoder2_15b, phi3_medium_14b, qwen3_14b,
        llama_3_2_vision_90b, mixtral_8x22b, kimi_k2_1t_a32b,
        seamless_m4t_medium, mamba2_370m, zamba2_7b)
}


def get(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}") from None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: str) -> dict:
    """Meta tensors for one (arch, shape) cell.

    train:   {tokens, labels [, frames | vision_emb]}
    prefill: {tokens [, frames | vision_emb]}
    decode:  {tokens (B,1), pos (B,)}: the cache is made apart
             (`models.api.init_cache(..., device="meta")`).
    """
    cell = SHAPES[shape]
    B, S = cell.global_batch, cell.seq_len
    out: dict = {}
    if cell.kind == "train":
        out["tokens"] = _meta((B, S), torch.int32)
        out["labels"] = _meta((B, S), torch.int32)
    elif cell.kind == "prefill":
        out["tokens"] = _meta((B, S), torch.int32)
    else:  # decode: one new token against a seq_len-deep cache
        out["tokens"] = _meta((B, 1), torch.int32)
        out["pos"] = _meta((B,), torch.int32)
    if cfg.family == "encdec" and cell.kind != "decode":
        out["frames"] = _meta((B, max(S // cfg.enc_ratio, 1), cfg.d_model),
                              torch.bfloat16)
    if cfg.family == "vlm" and cell.kind != "decode":
        out["vision_emb"] = _meta((B, cfg.vision_tokens, cfg.vision_dim),
                                  torch.bfloat16)
    return out


__all__ = ["ARCHS", "get", "input_specs", "SHAPES", "ArchConfig", "ShapeCell",
           "cell_applicable"]
