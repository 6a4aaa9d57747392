"""Zamba2-style hybrid: Mamba2 backbone + a SHARED attention block.

Structure: groups of `attn_every` Mamba2 blocks, each group followed by one
application of a single shared transformer block (attention + SwiGLU with the
SAME parameters every application — zamba2's parameter-sharing trick).  With
n_layers = 81, attn_every = 6: 11 groups of (6 mamba + 1 shared application)
plus 4 tail mamba blocks = 81 block applications.  The shared block uses
sliding-window attention; decode keeps its keys and values in a ring of
min(max_seq, window) slots.

Group g's Mamba blocks are layers g·attn_every + j of the stacked
`mamba_blocks` (views of it, no copy); the shared block's parameters gather
their gradient from every application.  Remat is nested as in the
reference: each Mamba block inside its group, then the group.

Over a mesh (`shd`) the Mamba blocks run as the SSM family's do
(`ssm.mamba_block`; in decode `ssm.decode_over_mesh` on each rank's block
of the groups' and the tail's states), the shared attention and SwiGLU as
the dense family's, and decode writes the ring through
`layers.decode_attention_over_mesh` at slot pos % window, masked by the
written slots.
"""
from __future__ import annotations

import torch

from ..core.executor import resolve_device
from . import layers as L
from . import ssm as M
from . import transformer as TF
from .common import NO_SHARD, Layout, Model, ShardCtx, stack_layers


def group_counts(cfg) -> tuple[int, int]:
    """(n_groups, n_tail_mamba): n_layers = n_groups·(attn_every+1) + tail."""
    per = cfg.attn_every + 1
    n_groups = cfg.n_layers // per
    tail = cfg.n_layers - n_groups * per
    return n_groups, tail


def layout(cfg) -> Layout:
    n_groups, tail = group_counts(cfg)
    lay = {
        "embed": L.embed_layout(cfg),
        "mamba_blocks": stack_layers(M.mamba_layout(cfg),
                                     n_groups * cfg.attn_every),
        "shared_attn": L.attention_layout(cfg),
        "shared_mlp": L.swiglu_layout(cfg.d_model, cfg.d_ff),
    }
    if tail:
        lay["tail_blocks"] = stack_layers(M.mamba_layout(cfg), tail)
    return lay


def build(cfg, tensors: dict) -> Model:
    """The model over a layout-shaped tree of tensors; raises on a missing
    key or a shape that is not the layout's."""
    return Model(cfg, layout(cfg), tensors, forward)


def forward(params, cfg, tokens: torch.Tensor, last_only: bool = False,
            shd: ShardCtx = NO_SHARD) -> torch.Tensor:
    B, S = tokens.shape
    n_groups, tail = group_counts(cfg)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = L.embed(params["embed"], cfg, tokens, shd)
    shared_attn, shared_mlp = params["shared_attn"], params["shared_mlp"]
    inner = TF._remat(lambda x, lp: M.mamba_block(lp, cfg, x, shd),
                      cfg.remat)

    def group(x, layers):
        for lp in layers:
            x = inner(x, lp)
        x = L.self_attention(shared_attn, cfg, x, positions, shd)
        return L.swiglu(shared_mlp, x, shd)

    group = TF._remat(group, cfg.remat)
    blocks = params["mamba_blocks"]
    for g in range(n_groups):
        x = group(x, [blocks[g * cfg.attn_every + j]
                      for j in range(cfg.attn_every)])
    if tail:
        for lp in params["tail_blocks"]:
            x = inner(x, lp)
    if last_only:
        x = x[:, -1:]
    return L.logits(params["embed"], cfg, x, shd)


# ---------------------------------------------------------------------------
# Serving: mamba states + windowed KV for the shared block applications.
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device=None) -> dict:
    """{'mamba': the groups' Mamba states (stacked), 'tail': the tail's
    (None without a tail), 'attn_k' / 'attn_v': (n_groups, batch, window,
    n_kv_heads, head_dim) rings}, window = min(max_seq, sliding_window);
    on the card unless the caller asks for the CPU."""
    n_groups, tail = group_counts(cfg)
    dev = resolve_device(device)
    window = (min(max_seq, cfg.sliding_window) if cfg.sliding_window
              else max_seq)
    shape = (n_groups, batch, window, cfg.n_kv_heads, cfg.hd())
    return {
        "mamba": M.init_block_state(cfg, batch, dtype, device=dev,
                                    n=n_groups * cfg.attn_every),
        "tail": (M.init_block_state(cfg, batch, dtype, device=dev, n=tail)
                 if tail else None),
        "attn_k": torch.zeros(shape, dtype=dtype, device=dev),
        "attn_v": torch.zeros(shape, dtype=dtype, device=dev),
    }


def cache_axes(cfg) -> dict:
    """The logical axes of `init_cache`'s leaves (the reference's)."""
    mamba = M.cache_axes(cfg)
    attn = ("layers", "batch", None, "kv_heads", None)
    return {"mamba": mamba, "tail": mamba if group_counts(cfg)[1] else None,
            "attn_k": attn, "attn_v": attn}


def decode_step(params, cfg, cache: dict, tokens, pos,
                shd: ShardCtx = NO_SHARD):
    """Windowed KV: slot = pos % window (ring buffer); masking handles the
    wrap.  Every state and ring is written in place (over a mesh, each
    rank's block of it); returns (logits (B,1,V), cache)."""
    n_groups, tail = group_counts(cfg)
    x = L.embed(params["embed"], cfg, tokens, shd)
    window = cache["attn_k"].shape[2]
    ring_pos = pos % window
    # Slot s holds a token iff it has been written: s <= pos before the first
    # wrap, every slot afterwards (all within the sliding window by then).
    slots = torch.arange(window, device=x.device)[None, :]
    kv_valid = (slots <= pos[:, None]) | (pos[:, None] >= window)
    shared_attn, shared_mlp = params["shared_attn"], params["shared_mlp"]
    blocks = params["mamba_blocks"]

    def mamba(lp, x, states, i):
        if shd.mesh is None:
            return M.decode_into(lp, cfg, x, states, i)
        return M.decode_over_mesh(lp, cfg, x, states, i, shd)

    for g in range(n_groups):
        for j in range(cfg.attn_every):
            i = g * cfg.attn_every + j
            x = mamba(blocks[i], x, cache["mamba"], i)
        if shd.mesh is None:
            x, _, _ = L.decode_attention(
                shared_attn, cfg, x, cache["attn_k"][g], cache["attn_v"][g],
                pos, write_pos=ring_pos, kv_valid=kv_valid)
        else:
            x = L.decode_attention_over_mesh(
                shared_attn, cfg, x, cache["attn_k"], cache["attn_v"], g, pos,
                shd, write_pos=ring_pos, kv_valid=kv_valid)
        x = L.swiglu(shared_mlp, x, shd)
    if tail:
        for i, lp in enumerate(params["tail_blocks"]):
            x = mamba(lp, x, cache["tail"], i)
    return L.logits(params["embed"], cfg, x, shd), cache


def prefill(params, cfg, tokens, cache, shd: ShardCtx = NO_SHARD):
    """Last-position logits of the parallel form; the cache comes back as
    it was given (the reference's documented trade-off)."""
    return forward(params, cfg, tokens, last_only=True, shd=shd), cache
