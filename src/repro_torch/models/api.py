"""Unified model API over all families.

Every entry point takes a `batch` dict, as the reference's does, so train
and serve code never branch on family:

  batch["tokens"]      (B, S) int32           — all families
  batch["labels"]      (B, S) int32           — training
  batch["frames"]      (B, S_enc, d) bf16     — encdec (stub frontend)
  batch["vision_emb"]  (B, T_vis, d_vis) bf16 — vlm   (stub frontend)

forward(...) -> (logits, aux) where aux = {} or MoE stats (aux_loss enters the
training loss; expert_load feeds the SkewShares re-planner).  Over a mesh
`forward`, `decode_step` and `prefill` take a `common.ShardCtx` (`shd`) and
every family runs on the model's DTensors, the frontend's input (frames,
vision embeddings) among them, plain tensors (positions, masks) taken as
replicated.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Any

import torch
from torch.distributed.tensor.experimental import implicit_replication

from .common import NO_SHARD, Layout, ShardCtx, init_params
from . import encdec, hybrid, moe, ssm, transformer, vlm

_FAMILIES = {
    "dense": transformer,
    "moe": moe,
    "ssm": ssm,
    "hybrid": hybrid,
    "encdec": encdec,
    "vlm": vlm,
}


def family_module(cfg):
    return _FAMILIES[cfg.family]


def layout(cfg) -> Layout:
    return family_module(cfg).layout(cfg)


def build(cfg, tensors: dict):
    """The family's model over a layout-shaped tree of tensors."""
    return family_module(cfg).build(cfg, tensors)


def init_model(cfg, generator: torch.Generator, *, device=None,
               dtype: torch.dtype = torch.bfloat16, placements=None,
               mesh=None):
    """A model with random parameters from `generator` (see
    common.init_params), on the card unless the caller asks for the CPU;
    over a `mesh`, DTensors of `placements` (a train step's
    `param_placements`)."""
    return build(cfg, init_params(layout(cfg), generator, device=device,
                                  dtype=dtype, placements=placements,
                                  mesh=mesh))


def _frontend(cfg, batch: dict) -> tuple:
    """The stub frontend's input of the family, if it takes one."""
    if cfg.family == "encdec":
        return (batch["frames"],)
    if cfg.family == "vlm":
        return (batch["vision_emb"],)
    return ()


def forward(params, cfg, batch: dict, last_only: bool = False,
            shd: ShardCtx = NO_SHARD) -> tuple[torch.Tensor, dict[str, Any]]:
    m = family_module(cfg)
    with mesh_context(shd):
        if cfg.family == "moe":
            return m.forward(params, cfg, batch["tokens"], last_only=last_only,
                             shd=shd)
        return m.forward(params, cfg, batch["tokens"], *_frontend(cfg, batch),
                         last_only=last_only, shd=shd), {}


def mesh_context(shd: ShardCtx):
    """Over a mesh, plain tensors meeting DTensors count as replicated
    (`implicit_replication`); without one, nothing."""
    return implicit_replication() if shd.mesh is not None else nullcontext()


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device=None):
    return family_module(cfg).init_cache(cfg, batch, max_seq, dtype,
                                         device=device)


def decode_step(params, cfg, cache, batch: dict, pos,
                shd: ShardCtx = NO_SHARD):
    """One decode step: (logits (B,1,V), cache).  Over a mesh
    the cache is DTensors of `serve_step.cache_placements` and the tokens
    and positions DTensors split as the cache's rows."""
    with mesh_context(shd):
        return family_module(cfg).decode_step(params, cfg, cache,
                                              batch["tokens"], pos, shd=shd)


def prefill(params, cfg, batch: dict, cache, shd: ShardCtx = NO_SHARD):
    with mesh_context(shd):
        return family_module(cfg).prefill(params, cfg, batch["tokens"],
                                          *_frontend(cfg, batch), cache,
                                          shd=shd)
