"""Dense decoder-only transformer (qwen2 / starcoder2 / phi3 / qwen3 family),
and the KV cache, prefill and decode loops the MoE family shares.

Layers run one after another over views of the stacked parameters
(`model.blocks[i]`, see common.py), where the reference scans them; with
`remat="full"` each layer is recomputed in the backward pass
(`torch.utils.checkpoint`, non-reentrant), which keeps activation memory
at one layer's footprint, as the reference's `jax.checkpoint` does.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..core.executor import resolve_device
from . import layers as L
from .common import Layout, Model, TensorView, stack_layers


def block_layout(cfg) -> Layout:
    return {"attn": L.attention_layout(cfg),
            "mlp": L.swiglu_layout(cfg.d_model, cfg.d_ff)}


def layout(cfg) -> Layout:
    return {"embed": L.embed_layout(cfg),
            "blocks": stack_layers(block_layout(cfg), cfg.n_layers)}


def _remat(fn: Callable, mode: str) -> Callable:
    """fn, recomputed in the backward pass under "full".  "dots" (the
    reference's policy that saves the matmuls' outputs) is refused: no
    config uses it.  Outside autograd (grad mode off) fn runs as it is.
    No model draws random numbers in a step, so the recompute keeps no
    generator state (`preserve_rng_state=False`): stashing and restoring
    the card's generator has no place in a captured train step."""
    if mode == "dots":
        raise NotImplementedError(
            'remat="dots" is not ported; use "full" or "none"')
    if mode != "full":
        return fn

    def recomputed(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)

    return recomputed


class Attention(TensorView):
    """wq, wk, wv, wo, norm (+ bq, bk, bv / q_norm, k_norm)."""

    def __init__(self, cfg, tensors: dict):
        super().__init__(tensors)
        self.cfg = cfg

    def __call__(self, x, positions):
        return L.self_attention(self, self.cfg, x, positions)


class Block(TensorView):
    """One layer: attn, mlp (w1, w3, w2, norm: SwiGLU)."""

    def __init__(self, cfg, tensors: dict):
        super().__init__({"attn": Attention(cfg, tensors["attn"]),
                          "mlp": TensorView(tensors["mlp"])})
        self.cfg = cfg

    def __call__(self, x, positions):
        return block_apply(self, self.cfg, x, positions)


def block_apply(p, cfg, x, positions) -> torch.Tensor:
    x = L.self_attention(p["attn"], cfg, x, positions)
    return L.swiglu(p["mlp"], x)


def build(cfg, tensors: dict) -> Model:
    """The model over a layout-shaped tree of tensors (`blocks` stacked on a
    leading layer axis, as `init_params` makes it).  Raises on a missing
    key or a shape that is not the layout's."""
    return Model(cfg, layout(cfg), tensors, forward,
                 {"blocks": partial(Block, cfg)})


def forward(params, cfg, tokens: torch.Tensor, last_only: bool = False
            ) -> torch.Tensor:
    """tokens (B,S) int32 -> logits (B,S,padded_vocab), (B,1,·) if last_only
    — prefill never materializes full-sequence logits."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = L.embed(params["embed"], cfg, tokens)
    body = _remat(lambda x, lp: block_apply(lp, cfg, x, positions), cfg.remat)
    for lp in params["blocks"]:
        x = body(x, lp)
    if last_only:
        x = x[:, -1:]
    return L.logits(params["embed"], cfg, x)


# ---------------------------------------------------------------------------
# Serving: KV cache, prefill, decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device=None) -> dict:
    """Zeroed KV cache {"k", "v"}, each (n_layers, batch, max_seq,
    n_kv_heads, head_dim), on the card unless the caller asks for the
    CPU."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd())
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def decode_layers(params, cfg, cache: dict, tokens, pos, ffn: Callable
                  ) -> tuple[torch.Tensor, dict]:
    """One decode step through every layer (attention against the cache,
    then `ffn(layer, x)`); each layer's new key and value go into `cache`
    in place.  Returns (logits (B,1,V), cache)."""
    x = L.embed(params["embed"], cfg, tokens)
    for i, lp in enumerate(params["blocks"]):
        x, _, _ = L.decode_attention(lp["attn"], cfg, x, cache["k"][i],
                                     cache["v"][i], pos)
        x = ffn(lp, x)
    return L.logits(params["embed"], cfg, x), cache


def prefill_layers(params, cfg, tokens, cache: dict, ffn: Callable
                   ) -> tuple[torch.Tensor, dict]:
    """Fill `cache[:, :, :S]` in place from whole prompts (B,S) through
    every layer (attention, then `ffn(layer, x)`); returns (last-position
    logits (B,1,V), cache)."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = L.embed(params["embed"], cfg, tokens)
    for i, lp in enumerate(params["blocks"]):
        ap = lp["attn"]
        h = L.rmsnorm(x, ap["norm"])
        q, k, v = L._qkv(ap, cfg, h, positions)
        cache["k"][i, :, :S] = k.to(cache["k"].dtype)
        cache["v"][i, :, :S] = v.to(cache["v"].dtype)
        if cfg.attn_chunk and S > cfg.attn_chunk:
            o = L._sdpa_chunked(q, k, v, 0, cfg.sliding_window, cfg.attn_chunk)
        else:
            o = L._sdpa_dense(q, k, v, L._causal_mask(S, S, 0,
                                                      cfg.sliding_window,
                                                      tokens.device))
        x = x + o.reshape(B, S, -1) @ ap["wo"]
        x = ffn(lp, x)
    return L.logits(params["embed"], cfg, x[:, -1:]), cache


def decode_step(params, cfg, cache, tokens, pos):
    """tokens (B,1), pos (B,) -> (logits (B,1,V), cache)."""
    return decode_layers(params, cfg, cache, tokens, pos,
                         lambda lp, x: L.swiglu(lp["mlp"], x))


def prefill(params, cfg, tokens, cache):
    """Fill `cache[:, :, :S]` in place from a whole prompt (B,S); returns
    (last-position logits (B,1,V), cache)."""
    return prefill_layers(params, cfg, tokens, cache,
                          lambda lp, x: L.swiglu(lp["mlp"], x))
