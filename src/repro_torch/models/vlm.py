"""Llama-3.2-Vision-style VLM backbone: decoder with interleaved image
cross-attention layers.

The vision frontend is a STUB, as in the reference: the caller provides
precomputed patch embeddings (B, vision_tokens, vision_dim); a learned
projection lifts them to d_model.  Every `cross_attn_every` self-attention
blocks, one gated cross-attention block attends into the projected vision
tokens — the 100-layer spec = 80 self + 20 cross (cross_attn_every=4).

Group g's self-attention blocks are layers g·cross_attn_every + j of the
stacked `sa_blocks` (views, no copy).  The reference recomputes each group
as one piece in the backward pass; XLA keeps what it saves small, eager
PyTorch keeps every intermediate of the group's blocks at once (at the
published widths, each block's chunked attention saves ~11 GB of float32
probabilities for 4 x 2,048 tokens), so here each self-attention block is
recomputed on its own inside its group as well.  The values are the same.

Over a mesh (`shd`) the self-attention blocks run as the dense family's,
the gated cross-attention as `layers.cross_attention` does over a mesh
(the projected vision tokens' rows over DP), and prefill writes `vis` as
a DTensor of the cache leaf's placements.
"""
from __future__ import annotations

import torch

from ..core.executor import resolve_device
from . import layers as L
from . import transformer as TF
from .common import NO_SHARD, Layout, Model, PDef, ShardCtx, stack_layers


def group_counts(cfg) -> tuple[int, int]:
    """n_layers = n_groups·(cross_attn_every self + 1 cross) + tail self."""
    per = cfg.cross_attn_every + 1
    n_groups = cfg.n_layers // per
    tail = cfg.n_layers - n_groups * per
    return n_groups, tail


def ca_block_layout(cfg) -> Layout:
    return {"xattn": L.cross_attention_layout(cfg),
            "mlp": L.swiglu_layout(cfg.d_model, cfg.d_ff),
            "gate": PDef((1,), (None,), init="zeros")}   # zero-init gated xattn


def layout(cfg) -> Layout:
    n_groups, tail = group_counts(cfg)
    lay = {
        "embed": L.embed_layout(cfg),
        "vision_proj": PDef((cfg.vision_dim, cfg.d_model), (None, "embed")),
        "sa_blocks": stack_layers(TF.block_layout(cfg),
                                  n_groups * cfg.cross_attn_every),
        "ca_blocks": stack_layers(ca_block_layout(cfg), n_groups),
    }
    if tail:
        lay["tail_blocks"] = stack_layers(TF.block_layout(cfg), tail)
    return lay


def build(cfg, tensors: dict) -> Model:
    """The model over a layout-shaped tree of tensors; raises on a missing
    key or a shape that is not the layout's."""
    return Model(cfg, layout(cfg), tensors, forward)


def _apply_ca(p, cfg, x, vis, shd: ShardCtx = NO_SHARD) -> torch.Tensor:
    h = L.cross_attention(p["xattn"], cfg, x, vis, shd)
    x = x + p["gate"] * (h - x)          # gated residual (zero-init = identity)
    return L.swiglu(p["mlp"], x, shd)


def _project(params, vision_emb: torch.Tensor, shd: ShardCtx = NO_SHARD
             ) -> torch.Tensor:
    w = params["vision_proj"]
    return shd.shard(L.dense(vision_emb.to(w.dtype), w), "batch", None, None)


def forward(params, cfg, tokens: torch.Tensor, vision_emb: torch.Tensor,
            last_only: bool = False, shd: ShardCtx = NO_SHARD
            ) -> torch.Tensor:
    """tokens (B,S); vision_emb (B, vision_tokens, vision_dim)."""
    B, S = tokens.shape
    n_groups, tail = group_counts(cfg)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    vis = _project(params, vision_emb, shd)
    x = L.embed(params["embed"], cfg, tokens, shd)
    block = TF._remat(lambda x, lp: TF.block_apply(lp, cfg, x, positions, shd),
                      cfg.remat)

    def group(x, layers, ca):
        for lp in layers:
            x = block(x, lp)
        return _apply_ca(ca, cfg, x, vis, shd)

    group = TF._remat(group, cfg.remat)
    sa, ca = params["sa_blocks"], params["ca_blocks"]
    for g in range(n_groups):
        x = group(x, [sa[g * cfg.cross_attn_every + j]
                      for j in range(cfg.cross_attn_every)], ca[g])
    if tail:
        for lp in params["tail_blocks"]:
            x = block(x, lp)
    if last_only:
        x = x[:, -1:]
    return L.logits(params["embed"], cfg, x, shd)


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device=None) -> dict:
    """{'sa_k', 'sa_v': the groups' self-attention KV (stacked), 'tail_k',
    'tail_v': the tail's (None without a tail), 'vis': (batch,
    vision_tokens, d_model) projected vision tokens}, zeroed, on the card
    unless the caller asks for the CPU."""
    n_groups, tail = group_counts(cfg)
    dev = resolve_device(device)

    def kv(n):
        shape = (n, batch, max_seq, cfg.n_kv_heads, cfg.hd())
        return (torch.zeros(shape, dtype=dtype, device=dev),
                torch.zeros(shape, dtype=dtype, device=dev))

    sk, sv = kv(n_groups * cfg.cross_attn_every)
    tk, tv = kv(tail) if tail else (None, None)
    return {"sa_k": sk, "sa_v": sv, "tail_k": tk, "tail_v": tv,
            "vis": torch.zeros((batch, cfg.vision_tokens, cfg.d_model),
                               dtype=dtype, device=dev)}


def cache_axes(cfg) -> dict:
    """The logical axes of `init_cache`'s leaves (the reference's)."""
    tail = group_counts(cfg)[1]
    attn = ("layers", "batch", None, "kv_heads", None)
    return {"sa_k": attn, "sa_v": attn,
            "tail_k": attn if tail else None,
            "tail_v": attn if tail else None,
            "vis": ("batch", None, None)}


def _decode_block(lp, cfg, x, cache, key: str, i: int, pos,
                  shd: ShardCtx) -> torch.Tensor:
    """Layer i of the stacked caches `cache[key + '_k' | '_v']`."""
    ck, cv = cache[key + "_k"], cache[key + "_v"]
    if shd.mesh is None:
        x, _, _ = L.decode_attention(lp["attn"], cfg, x, ck[i], cv[i], pos)
    else:
        x = L.decode_attention_over_mesh(lp["attn"], cfg, x, ck, cv, i, pos,
                                         shd)
    return L.swiglu(lp["mlp"], x, shd)


def decode_step(params, cfg, cache: dict, tokens, pos,
                shd: ShardCtx = NO_SHARD):
    """One decode step against the cached vision tokens; each layer's new
    key and value go into the cache in place (over a mesh, each rank's
    block of it).  Returns (logits (B,1,V), cache)."""
    n_groups, tail = group_counts(cfg)
    x = L.embed(params["embed"], cfg, tokens, shd)
    vis = cache["vis"]
    sa, ca = params["sa_blocks"], params["ca_blocks"]
    for g in range(n_groups):
        for j in range(cfg.cross_attn_every):
            i = g * cfg.cross_attn_every + j
            x = _decode_block(sa[i], cfg, x, cache, "sa", i, pos, shd)
        x = _apply_ca(ca[g], cfg, x, vis, shd)
    if tail:
        for i, lp in enumerate(params["tail_blocks"]):
            x = _decode_block(lp, cfg, x, cache, "tail", i, pos, shd)
    return L.logits(params["embed"], cfg, x, shd), cache


def prefill(params, cfg, tokens, vision_emb, cache: dict,
            shd: ShardCtx = NO_SHARD):
    """The reference's simplified prefill: last-position logits of the
    parallel forward, and `cache['vis']` replaced by the projected vision
    tokens (over a mesh, a DTensor of the cache leaf's placements); the
    self-attention caches are not filled (its documented trade-off)."""
    vis = _project(params, vision_emb, shd).to(cache["vis"].dtype)
    if shd.mesh is not None:
        vis = vis.redistribute(shd.mesh, cache["vis"].placements)
    cache["vis"] = vis
    return forward(params, cfg, tokens, vision_emb, last_only=True,
                   shd=shd), cache
