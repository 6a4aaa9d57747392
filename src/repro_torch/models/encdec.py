"""Encoder-decoder backbone (seamless-m4t-medium).

The audio/text frontend is a STUB, as in the reference: the encoder
consumes precomputed frame embeddings (B, S_enc, d_model), where
S_enc = seq_len // enc_ratio.  Encoder blocks are bidirectional; decoder
blocks are causal self-attention + cross-attention into the encoder output.

Over a mesh (`shd`) the encoder's frames are pinned rows over DP, its
bidirectional attention runs on each rank's rows and heads
(`layers._bidir_over_mesh`), the decoder's self-attention and SwiGLU run
as the dense family's and its cross-attention as `layers.cross_attention`
does over a mesh.  Prefill writes `enc_out` as a DTensor of the cache's
placements and each rank's blocks of the self-attention cache.
"""
from __future__ import annotations

import torch

from ..core.executor import resolve_device
from . import layers as L
from . import transformer as TF
from .common import NO_SHARD, Layout, Model, ShardCtx, stack_layers


def enc_block_layout(cfg) -> Layout:
    return {"attn": L.attention_layout(cfg),
            "mlp": L.swiglu_layout(cfg.d_model, cfg.d_ff)}


def dec_block_layout(cfg) -> Layout:
    return {"self_attn": L.attention_layout(cfg),
            "cross_attn": L.cross_attention_layout(cfg),
            "mlp": L.swiglu_layout(cfg.d_model, cfg.d_ff)}


def layout(cfg) -> Layout:
    return {
        "embed": L.embed_layout(cfg),
        "enc_blocks": stack_layers(enc_block_layout(cfg), cfg.enc_layers),
        "enc_norm": L.rmsnorm_layout(cfg.d_model),
        "dec_blocks": stack_layers(dec_block_layout(cfg), cfg.n_layers),
    }


def build(cfg, tensors: dict) -> Model:
    """The model over a layout-shaped tree of tensors; raises on a missing
    key or a shape that is not the layout's."""
    return Model(cfg, layout(cfg), tensors, forward)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def _bidir_attention(p, cfg, x, positions, shd: ShardCtx = NO_SHARD
                     ) -> torch.Tensor:
    """Encoder self-attention: full (non-causal) visibility."""
    h = L.rmsnorm(x, p["norm"])
    q, k, v = L._qkv(p, cfg, h, positions)
    S = x.shape[1]
    chunk = cfg.attn_chunk if cfg.attn_chunk and S > cfg.attn_chunk else 0
    if shd.mesh is None:
        o = L._bidir(q, k, v, cfg, chunk)
    else:
        q = shd.shard(q, "batch", "act_seq", "act_heads", None)
        o = L._bidir_over_mesh(q, k, v, cfg, shd, chunk)
    o = o.reshape(*x.shape[:2], -1)
    return x + shd.shard(L.dense(o, p["wo"]), "batch", "act_seq", "act_embed")


def encode(params, cfg, frames: torch.Tensor, shd: ShardCtx = NO_SHARD
           ) -> torch.Tensor:
    """frames (B, S_enc, d_model) precomputed frontend embeddings."""
    B, S, _ = frames.shape
    positions = _positions(B, S, frames.device)

    def body(x, lp):
        x = _bidir_attention(lp["attn"], cfg, x, positions, shd)
        return L.swiglu(lp["mlp"], x, shd)

    body = TF._remat(body, cfg.remat)
    x = shd.shard(frames, "batch", "act_seq", "act_embed")
    for lp in params["enc_blocks"]:
        x = body(x, lp)
    return L.rmsnorm(x, params["enc_norm"])


def forward(params, cfg, tokens: torch.Tensor, frames: torch.Tensor,
            last_only: bool = False, shd: ShardCtx = NO_SHARD
            ) -> torch.Tensor:
    """Teacher-forced training pass: (dec tokens, enc frames) -> logits."""
    enc_out = encode(params, cfg, frames, shd)
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    x = L.embed(params["embed"], cfg, tokens, shd)

    def body(x, lp):
        x = L.self_attention(lp["self_attn"], cfg, x, positions, shd)
        x = L.cross_attention(lp["cross_attn"], cfg, x, enc_out, shd)
        return L.swiglu(lp["mlp"], x, shd)

    body = TF._remat(body, cfg.remat)
    for lp in params["dec_blocks"]:
        x = body(x, lp)
    if last_only:
        x = x[:, -1:]
    return L.logits(params["embed"], cfg, x, shd)


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device=None) -> dict:
    """{'k', 'v': (n_layers, batch, max_seq, n_kv_heads, head_dim),
    'enc_out': (batch, max(max_seq // enc_ratio, 1), d_model)}, zeroed, on
    the card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd())
    enc_len = max(max_seq // cfg.enc_ratio, 1)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "enc_out": torch.zeros((batch, enc_len, cfg.d_model), dtype=dtype,
                                   device=dev)}


def cache_axes(cfg) -> dict:
    """The logical axes of `init_cache`'s leaves (the reference's)."""
    attn = ("layers", "batch", None, "kv_heads", None)
    return {"k": attn, "v": attn, "enc_out": ("batch", "act_seq", None)}


def decode_step(params, cfg, cache: dict, tokens, pos,
                shd: ShardCtx = NO_SHARD):
    """Decoder step with the cached encoder output + self-attn KV cache
    (written in place; over a mesh, each rank's block of it); returns
    (logits (B,1,V), cache)."""
    x = L.embed(params["embed"], cfg, tokens, shd)
    enc_out = cache["enc_out"]
    for i, lp in enumerate(params["dec_blocks"]):
        if shd.mesh is None:
            x, _, _ = L.decode_attention(lp["self_attn"], cfg, x,
                                         cache["k"][i], cache["v"][i], pos)
        else:
            x = L.decode_attention_over_mesh(lp["self_attn"], cfg, x,
                                             cache["k"], cache["v"], i, pos,
                                             shd)
        x = L.cross_attention(lp["cross_attn"], cfg, x, enc_out, shd)
        x = L.swiglu(lp["mlp"], x, shd)
    return L.logits(params["embed"], cfg, x, shd), cache


def prefill(params, cfg, tokens: torch.Tensor, frames: torch.Tensor,
            cache: dict, shd: ShardCtx = NO_SHARD):
    """Encode `frames`, fill `cache['k'|'v'][:, :, :S]` in place from the
    prompts (B,S), and replace `cache['enc_out']` by the encoder's output
    (S_enc rows, not the max_seq // enc_ratio of `init_cache`: decode's
    cross-attention sees those rows and no others, as the reference's
    does).  Over a mesh `enc_out` becomes a DTensor of the cache leaf's
    placements and each rank fills its blocks of the self-attention
    cache.  Returns (last-position logits (B,1,V), cache)."""
    enc_out = encode(params, cfg, frames, shd)
    held = enc_out.to(cache["enc_out"].dtype)
    if shd.mesh is not None:
        held = held.redistribute(shd.mesh, cache["enc_out"].placements)
    cache["enc_out"] = held
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    x = L.embed(params["embed"], cfg, tokens, shd)

    def body(x, lp, ck, cv):
        ap = lp["self_attn"]
        h = L.rmsnorm(x, ap["norm"])
        q, k, v = L._qkv(ap, cfg, h, positions)
        ck[:, :S] = k.to(ck.dtype)
        cv[:, :S] = v.to(cv.dtype)
        if cfg.attn_chunk and S > cfg.attn_chunk:
            o = L._sdpa_chunked(q, k, v, 0, 0, cfg.attn_chunk)
        else:
            o = L._sdpa_dense(q, k, v, L._causal_mask(S, S, 0, 0, x.device))
        x = x + o.reshape(B, S, -1) @ ap["wo"]
        x = L.cross_attention(lp["cross_attn"], cfg, x, enc_out)
        return L.swiglu(lp["mlp"], x)

    for i, lp in enumerate(params["dec_blocks"]):
        if shd.mesh is None:
            x = body(x, lp, cache["k"][i], cache["v"][i])
            continue
        x = L.prefill_attention_over_mesh(lp["self_attn"], cfg, x, positions,
                                          cache["k"], cache["v"], i, shd)
        x = L.cross_attention(lp["cross_attn"], cfg, x, enc_out, shd)
        x = L.swiglu(lp["mlp"], x, shd)
    return L.logits(params["embed"], cfg, x[:, -1:], shd), cache
