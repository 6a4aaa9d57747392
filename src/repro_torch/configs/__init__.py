"""Architecture registry: every supported `ArchConfig` by name.

A copy of the reference package's `configs/` (plain dataclasses).  Its
`input_specs`, which builds the dry run's abstract inputs, has no
counterpart here.
"""
from __future__ import annotations

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


__all__ = ["ARCHS", "get", "SHAPES", "ArchConfig", "ShapeCell",
           "cell_applicable"]
