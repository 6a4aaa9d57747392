"""Shared transformer primitives: RMSNorm, RoPE, GQA attention, embeddings.

Plain functions over tensors and a parameter mapping `p` (`p["wq"]`: a
dict of tensors or a module of `models/moe.py`), in the reference
package's layouts: activations (B, S, d), heads (B, S, H, hd), KV caches
(B, Smax, KV, hd).  Causal self-attention supports grouped-query heads,
optional QKV bias and q/k RMSNorm, sliding windows, dense or chunked
(online-softmax) prefill, and decode steps against a preallocated KV
cache.  Cross-attention and SwiGLU come with the families that use them.

Computation runs in the parameters' dtype with float32 softmax and
normalisation accumulators, as the reference does; where JAX promotes two
dtypes on its own (an f32 query against a bf16 cache), the cast is written
out.  Matrix products go to torch (cuBLAS on the card), as the reference
leaves them to XLA.
"""
from __future__ import annotations

from typing import Any

import torch

from .common import PDef

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_layout(dim: int) -> PDef:
    return PDef((dim,), ("embed",), init="ones")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """Normalised in float32, cast back to x's dtype, then scaled."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Each head
    splits into halves (not interleaved pairs)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)        # (hd/2,)
    angles = positions[..., None].float() * freqs                  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                          # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention_layout(cfg) -> dict[str, Any]:
    d, hd = cfg.d_model, cfg.hd()
    lay = {
        "wq": PDef((d, cfg.n_heads * hd), ("embed", "heads")),
        "wk": PDef((d, cfg.n_kv_heads * hd), ("embed", "kv_heads")),
        "wv": PDef((d, cfg.n_kv_heads * hd), ("embed", "kv_heads")),
        "wo": PDef((cfg.n_heads * hd, d), ("heads", "embed")),
        "norm": rmsnorm_layout(d),
    }
    if cfg.qkv_bias:
        lay["bq"] = PDef((cfg.n_heads * hd,), ("heads",), init="zeros")
        lay["bk"] = PDef((cfg.n_kv_heads * hd,), ("kv_heads",), init="zeros")
        lay["bv"] = PDef((cfg.n_kv_heads * hd,), ("kv_heads",), init="zeros")
    if cfg.qk_norm:
        lay["q_norm"] = PDef((hd,), (None,), init="ones")
        lay["k_norm"] = PDef((hd,), (None,), init="ones")
    return lay


def _qkv(p, cfg, x, positions):
    B, S, _ = x.shape
    hd = cfg.hd()
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _group_q(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B,S,H,hd) -> (B,S,kv,rep,hd): query heads grouped by their KV head."""
    B, S, H, hd = q.shape
    return q.reshape(B, S, n_kv, H // n_kv, hd)


def _causal_mask(Sq: int, Skv: int, q_offset, window: int, device=None
                 ) -> torch.Tensor:
    """(Sq, Skv) additive float32 mask: causal (+ optional sliding window)."""
    qpos = q_offset + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    ok = kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, NEG_INF)


def _sdpa_dense(q, k, v, mask) -> torch.Tensor:
    """Grouped-query SDPA: q:(B,Sq,H,hd) k,v:(B,Skv,KV,hd) mask:(Sq,Skv).

    KV heads are contracted via grouped einsums — the KV tensors are never
    expanded to H heads."""
    B, Sq, H, hd = q.shape
    kv = k.shape[2]
    qg = _group_q(q, kv)                                   # (B,Sq,kv,rep,hd)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k).float()
    logits = logits / (hd ** 0.5) + mask[None, None, None]
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bgrqk,bkgd->bqgrd", probs, v)
    return o.reshape(B, Sq, H, hd)


def _sdpa_chunked(q, k, v, q_offset, window: int, chunk: int
                  ) -> torch.Tensor:
    """Flash-style causal online softmax over KV chunks, O(S·chunk) memory.

    q:(B,Sq,H,hd); k,v:(B,Skv,KV,hd) — grouped-query, no KV expansion;
    causal, with an optional sliding window.  (The reference's
    bidirectional arm, `causal=False`, serves cross-attention, which is not
    ported.)
    A row with no visible key in the chunks so far carries exp(0) = 1 for
    its masked logits, as the reference's scan does; the first visible key
    scales that away (corr = exp(NEG_INF - m) = 0).
    """
    B, Sq, H, hd = q.shape
    Skv, kv = k.shape[1], k.shape[2]
    dev = q.device
    qg = _group_q(q, kv)                                    # (B,Sq,kv,rep,hd)
    n_chunks = -(-Skv // chunk)
    qpos = q_offset + torch.arange(Sq, device=dev)
    rep = H // kv
    acc = torch.zeros((B, Sq, kv, rep, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, kv, rep, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, kv, rep, Sq), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        # The last chunk is short where the reference pads it; the pads it
        # masks add nothing to a row that has seen a visible key, and each
        # causal row sees its own key by its own chunk.
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        kpos = ci * chunk + torch.arange(kb.shape[1], device=dev)
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, kb).float()
        logits = logits / (hd ** 0.5)
        ok = kpos[None, :] <= qpos[:, None]
        if window:
            ok &= kpos[None, :] > qpos[:, None] - window
        logits = torch.where(ok[None, None, None], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = (acc * corr.permute(0, 3, 1, 2)[..., None]
               + torch.einsum("bgrqk,bkgd->bqgrd", p.to(q.dtype), vb))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def self_attention(p, cfg, x, positions) -> torch.Tensor:
    """Full-sequence causal self-attention (training / prefill)."""
    h = rmsnorm(x, p["norm"])
    q, k, v = _qkv(p, cfg, h, positions)
    S = x.shape[1]
    if cfg.attn_chunk and S > cfg.attn_chunk:
        o = _sdpa_chunked(q, k, v, 0, cfg.sliding_window, cfg.attn_chunk)
    else:
        mask = _causal_mask(S, S, 0, cfg.sliding_window, x.device)
        o = _sdpa_dense(q, k, v, mask)
    o = o.reshape(x.shape[0], S, -1)
    return x + o @ p["wo"]


def decode_attention(p, cfg, x, cache_k, cache_v, pos
                     ) -> tuple[torch.Tensor, ...]:
    """One-token decode: x (B,1,d); cache (B,Smax,kv,hd); pos (B,) int32,
    the absolute position (RoPE) and the cache slot.  The new key and value
    are written into the caches in place (cast to the caches' dtype);
    returns (y, cache_k, cache_v).  (The reference's ring-buffer arguments,
    `write_pos` and `kv_valid`, serve the hybrid family, which is not
    ported.)
    """
    B = x.shape[0]
    hd = cfg.hd()
    h = rmsnorm(x, p["norm"])
    q, k, v = _qkv(p, cfg, h, pos[:, None])
    bidx = torch.arange(B, device=x.device)
    cache_k[bidx, pos.long()] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, pos.long()] = v[:, 0].to(cache_v.dtype)
    Smax = cache_k.shape[1]
    kpos = torch.arange(Smax, device=x.device)[None, :]
    ok = kpos <= pos[:, None]
    if cfg.sliding_window:
        ok &= kpos > (pos[:, None] - cfg.sliding_window)
    # JAX promotes an f32 query against a bf16 cache to f32; so does this.
    ct = torch.promote_types(q.dtype, cache_k.dtype)
    qg = _group_q(q, cfg.n_kv_heads)                   # (B,1,kv,rep,hd)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.to(ct), cache_k.to(ct)
                          ).float() / (hd ** 0.5)
    logits = torch.where(ok[:, None, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    pt = torch.promote_types(probs.dtype, cache_v.dtype)
    o = torch.einsum("bgrqk,bkgd->bqgrd", probs.to(pt), cache_v.to(pt))
    return x + o.reshape(B, 1, -1) @ p["wo"], cache_k, cache_v


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def embed_layout(cfg) -> dict[str, Any]:
    vp = cfg.padded_vocab()
    lay = {
        "tok": PDef((vp, cfg.d_model), ("vocab", "embed"), scale=0.01),
        "final_norm": rmsnorm_layout(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        lay["unembed"] = PDef((cfg.d_model, vp), ("embed", "vocab"),
                              scale=0.01)
    return lay


def embed(p, cfg, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens.long()]


def logits(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """(B,S,d) -> (B,S,padded_vocab); pad columns masked to NEG_INF."""
    h = rmsnorm(x, p["final_norm"])
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    out = h @ w
    if cfg.logits_fp32:
        out = out.float()
    vp = cfg.padded_vocab()
    if vp != cfg.vocab:
        col = torch.arange(vp, device=out.device)
        out = torch.where(col < cfg.vocab, out, NEG_INF)
    return out
