"""Encoder-decoder backbone (seamless-m4t-medium).

The audio/text frontend is a STUB, as in the reference: the encoder
consumes precomputed frame embeddings (B, S_enc, d_model), where
S_enc = seq_len // enc_ratio.  Encoder blocks are bidirectional; decoder
blocks are causal self-attention + cross-attention into the encoder output.
"""
from __future__ import annotations

import torch

from ..core.executor import resolve_device
from . import layers as L
from . import transformer as TF
from .common import Layout, Model, stack_layers


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


def _bidir_attention(p, cfg, x, positions) -> torch.Tensor:
    """Encoder self-attention: full (non-causal) visibility."""
    h = L.rmsnorm(x, p["norm"])
    q, k, v = L._qkv(p, cfg, h, positions)
    S = x.shape[1]
    if cfg.attn_chunk and S > cfg.attn_chunk:
        o = L._sdpa_chunked(q, k, v, 0, 0, cfg.attn_chunk, causal=False)
    else:
        o = L._sdpa_dense(q, k, v, torch.zeros((S, S), dtype=torch.float32,
                                               device=x.device))
    return x + o.reshape(*x.shape[:2], -1) @ p["wo"]


def encode(params, cfg, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, S_enc, d_model) precomputed frontend embeddings."""
    B, S, _ = frames.shape
    positions = _positions(B, S, frames.device)

    def body(x, lp):
        x = _bidir_attention(lp["attn"], cfg, x, positions)
        return L.swiglu(lp["mlp"], x)

    body = TF._remat(body, cfg.remat)
    x = frames
    for lp in params["enc_blocks"]:
        x = body(x, lp)
    return L.rmsnorm(x, params["enc_norm"])


def forward(params, cfg, tokens: torch.Tensor, frames: torch.Tensor,
            last_only: bool = False) -> torch.Tensor:
    """Teacher-forced training pass: (dec tokens, enc frames) -> logits."""
    enc_out = encode(params, cfg, frames)
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    x = L.embed(params["embed"], cfg, tokens)

    def body(x, lp):
        x = L.self_attention(lp["self_attn"], cfg, x, positions)
        x = L.cross_attention(lp["cross_attn"], cfg, x, enc_out)
        return L.swiglu(lp["mlp"], x)

    body = TF._remat(body, cfg.remat)
    for lp in params["dec_blocks"]:
        x = body(x, lp)
    if last_only:
        x = x[:, -1:]
    return L.logits(params["embed"], cfg, x)


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


def decode_step(params, cfg, cache: dict, tokens, pos):
    """Decoder step with the cached encoder output + self-attn KV cache
    (written in place); returns (logits (B,1,V), cache)."""
    x = L.embed(params["embed"], cfg, tokens)
    enc_out = cache["enc_out"]
    for i, lp in enumerate(params["dec_blocks"]):
        x, _, _ = L.decode_attention(lp["self_attn"], cfg, x, cache["k"][i],
                                     cache["v"][i], pos)
        x = L.cross_attention(lp["cross_attn"], cfg, x, enc_out)
        x = L.swiglu(lp["mlp"], x)
    return L.logits(params["embed"], cfg, x), cache


def prefill(params, cfg, tokens: torch.Tensor, frames: torch.Tensor,
            cache: dict):
    """Encode `frames`, fill `cache['k'|'v'][:, :, :S]` in place from the
    prompts (B,S), and replace `cache['enc_out']` by the encoder's output
    (S_enc rows, not the max_seq // enc_ratio of `init_cache`: decode's
    cross-attention sees those rows and no others, as the reference's
    does).  Returns (last-position logits (B,1,V), cache)."""
    enc_out = encode(params, cfg, frames)
    cache["enc_out"] = enc_out.to(cache["enc_out"].dtype)
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    x = L.embed(params["embed"], cfg, tokens)

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
        x = body(x, lp, cache["k"][i], cache["v"][i])
    return L.logits(params["embed"], cfg, x[:, -1:]), cache
