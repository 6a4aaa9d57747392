"""Shared transformer primitives: RMSNorm, RoPE, GQA attention, embeddings.

Plain functions over tensors and a parameter mapping `p` (`p["wq"]`: a
dict of tensors or a module of `models/moe.py`), in the reference
package's layouts: activations (B, S, d), heads (B, S, H, hd), KV caches
(B, Smax, KV, hd).  Causal self-attention supports grouped-query heads,
optional QKV bias and q/k RMSNorm, sliding windows, dense or chunked
(online-softmax) prefill, and decode steps against a preallocated KV
cache (with the ring buffer of the hybrid family's windowed cache);
bidirectional attention (the encoder's) and cross-attention (enc-dec and
VLM image layers); the SwiGLU MLP.

Over a mesh the tensors are DTensors and `shd` (a `common.ShardCtx`) pins
the activations at the reference's seven sites (the query heads, each
block's output, the gated MLP hidden, the embedding, the logits); every
`shd` defaults to `NO_SHARD`, which pins nothing.

Computation runs in the parameters' dtype with float32 softmax and
normalisation accumulators, as the reference does; where JAX promotes two
dtypes on its own (an f32 query against a bf16 cache), the cast is written
out.  Matrix products go to torch (cuBLAS on the card), as the reference
leaves them to XLA.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.nn import functional as F

from .common import NO_SHARD, PDef, ShardCtx, local_block, to_local

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# Products
# ---------------------------------------------------------------------------

def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w (d, f).  Over a mesh, where x (a DTensor) is sharded
    along a leading dimension past the batch (the sequence, under sequence
    parallelism), that dimension is gathered first, as a sequence-parallel
    layer gathers its sequence before a projection: the product flattens
    the leading dimensions, which DTensor (torch 2.11) cannot do across a
    sharded inner one."""
    if isinstance(x, DTensor) and any(
            pl.is_shard() and 0 < pl.dim < x.ndim - 1 for pl in x.placements):
        x = x.redistribute(x.device_mesh, tuple(
            Replicate() if pl.is_shard() and 0 < pl.dim < x.ndim - 1 else pl
            for pl in x.placements))
    return x @ w


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
    q = dense(x, p["wq"])
    k = dense(x, p["wk"])
    v = dense(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _split_heads(q, cfg.n_heads, hd)
    k = _split_heads(k, cfg.n_kv_heads, hd)
    v = _split_heads(v, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n·hd) -> (B, S, n, hd).  Over a mesh, where a mesh dimension
    splits the last dimension but not into whole heads (2 KV heads over 4
    ranks), that dimension is gathered first: DTensor cannot unflatten a
    dimension split unevenly."""
    if isinstance(t, DTensor) and any(
            pl.is_shard(t.ndim - 1) and n % t.device_mesh.size(i)
            for i, pl in enumerate(t.placements)):
        t = t.redistribute(t.device_mesh, tuple(
            Replicate() if pl.is_shard(t.ndim - 1) and n % t.device_mesh.size(i)
            else pl for i, pl in enumerate(t.placements)))
    return t.reshape(*t.shape[:-1], n, hd)


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


def _sdpa_chunked(q, k, v, q_offset, window: int, chunk: int,
                  causal: bool = True) -> torch.Tensor:
    """Flash-style online softmax over KV chunks, O(S·chunk) memory.

    q:(B,Sq,H,hd); k,v:(B,Skv,KV,hd) — grouped-query, no KV expansion;
    causal with an optional sliding window, or bidirectional
    (`causal=False`: the encoder's self-attention and cross-attention),
    which masks nothing: the reference masks only the pads of its last
    chunk, and here the last chunk is short instead.
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
        if causal:
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


def _key_heads(q, k, v, cfg, kv_head: int) -> tuple:
    """k and v cut to the key heads of q's heads, the grouped heads of k's
    heads from kv_head on (all of them where q holds every head)."""
    rep = cfg.n_heads // cfg.n_kv_heads
    lo = kv_head
    hi = lo + max(q.shape[2] // rep, 1)
    if (lo, hi) != (0, k.shape[2]):
        k, v = k[:, :, lo:hi], v[:, :, lo:hi]
    return k, v


def _causal(q, k, v, cfg, q_offset: int = 0, kv_head: int = 0
            ) -> torch.Tensor:
    """Causal attention of queries q (B,Sq,H,hd) at positions q_offset +
    [0, Sq) over every key (B,Skv,KV,hd); q's heads are the grouped heads
    of k's heads from kv_head on.  Chunked past `attn_chunk` keys."""
    Skv = k.shape[1]
    k, v = _key_heads(q, k, v, cfg, kv_head)
    if cfg.attn_chunk and Skv > cfg.attn_chunk:
        return _sdpa_chunked(q, k, v, q_offset, cfg.sliding_window,
                             cfg.attn_chunk)
    mask = _causal_mask(q.shape[1], Skv, q_offset, cfg.sliding_window,
                        q.device)
    return _sdpa_dense(q, k, v, mask)


def _bidir(q, k, v, cfg, chunk: int, kv_head: int = 0) -> torch.Tensor:
    """Bidirectional attention of q (B,Sq,H,hd) over every key
    (B,Skv,KV,hd), q's heads mapped to k's as in `_causal`: the online
    softmax over chunks of `chunk` keys where `chunk` is not 0, else
    dense.  The caller decides the chunking from the global shapes."""
    k, v = _key_heads(q, k, v, cfg, kv_head)
    if chunk:
        return _sdpa_chunked(q, k, v, 0, 0, chunk, causal=False)
    return _sdpa_dense(q, k, v, torch.zeros((q.shape[1], k.shape[1]),
                                            dtype=torch.float32,
                                            device=q.device))


def _causal_over_mesh(q, k, v, cfg, shd: ShardCtx) -> torch.Tensor:
    """`_causal` on each rank's own queries (`_attend_over_mesh`); under
    sequence parallelism a rank's queries start at its sequence offset."""
    return _attend_over_mesh(q, k, v, cfg, shd, lambda q, k, v, q_off, kv_head:
                             _causal(q, k, v, cfg, q_off, kv_head))


def _bidir_over_mesh(q, k, v, cfg, shd: ShardCtx, chunk: int
                     ) -> torch.Tensor:
    """`_bidir` on each rank's own queries (`_attend_over_mesh`): the
    encoder's self-attention and cross-attention.  `chunk` is the one
    `_bidir` takes in one process, from the global shapes, so a rank
    chunks exactly where one process does."""
    return _attend_over_mesh(q, k, v, cfg, shd, lambda q, k, v, _, kv_head:
                             _bidir(q, k, v, cfg, chunk, kv_head))


class _DenseGrad(torch.autograd.Function):
    """The identity, whose gradient leaves contiguous: the attention's
    einsums give its inputs' gradients in permuted layouts, and DTensor
    (torch 2.13) views a block so laid out where its global layout allows
    it (the projections' backward), which the block's own does not ("view
    size is not compatible"; KV heads split over "model").  Applied only
    to the blocks of a split tensor: a whole one keeps the one-process
    layout, and with it the one-process products' bits."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _attend_over_mesh(q, k, v, cfg, shd: ShardCtx, attend) -> torch.Tensor:
    """`attend(q, k, v, q_offset, kv_head)` on each rank's own queries
    (`local_map`: the attention's grouped einsums flatten dimensions that
    DTensor cannot flatten across shards): q as pinned (its rows by
    "batch", its sequence or its heads by "model"); k and v by the same
    rows and, where q's heads are split, by their own heads when those
    divide, else whole; each rank's gradient of a k or v it holds whole
    for queries it does not is a partial sum.  A rank's queries start at
    its sequence offset `q_offset`; under head parallelism its heads map
    to their key heads from `kv_head` on."""
    mesh = shd.mesh
    q_pl = q.placements
    kv_pl, kv_grad = [], []
    for i, pl in enumerate(q_pl):
        whole = Replicate()
        if pl.is_shard(0):
            whole = pl
        elif pl.is_shard(2) and k.shape[2] % mesh.size(i) == 0:
            whole = pl
        kv_pl.append(whole)
        kv_grad.append(Partial() if pl.is_shard() and not whole.is_shard()
                       else whole)
    kv_pl, kv_grad = tuple(kv_pl), tuple(kv_grad)
    q_off = local_block(q.shape, q_pl, mesh)[1]
    kv_off = local_block(k.shape, kv_pl, mesh)[1]
    rep = cfg.n_heads // cfg.n_kv_heads
    kv_head = q_off[2] // rep - kv_off[2]
    split = [any(pl.is_shard() for pl in pls) for pls in (q_pl, kv_pl, kv_pl)]
    return local_map(
        lambda *qkv: attend(*(_DenseGrad.apply(t) if cut else t
                              for t, cut in zip(qkv, split)), q_off[1],
                            kv_head),
        out_placements=(q_pl,), in_placements=(q_pl, kv_pl, kv_pl),
        in_grad_placements=(q_pl, kv_grad, kv_grad), device_mesh=mesh,
        redistribute_inputs=True)(q, k, v)


def self_attention(p, cfg, x, positions, shd: ShardCtx = NO_SHARD
                   ) -> torch.Tensor:
    """Full-sequence causal self-attention (training / prefill)."""
    h = rmsnorm(x, p["norm"])
    q, k, v = _qkv(p, cfg, h, positions)
    q = shd.shard(q, "batch", "act_seq", "act_heads", None)
    S = x.shape[1]
    if shd.mesh is None:
        o = _causal(q, k, v, cfg)
    else:
        o = _causal_over_mesh(q, k, v, cfg, shd)
    o = o.reshape(x.shape[0], S, -1)
    return x + shd.shard(dense(o, p["wo"]), "batch", "act_seq", "act_embed")


def decode_attention(p, cfg, x, cache_k, cache_v, pos, write_pos=None,
                     kv_valid=None) -> tuple[torch.Tensor, ...]:
    """One-token decode: x (B,1,d); cache (B,Smax,kv,hd); pos (B,) int32.

    `pos` is the absolute position (RoPE); `write_pos` the cache slot
    (default `pos`; ring buffers pass pos % window); `kv_valid` (B,Smax)
    overrides the causal slot mask for ring buffers.  The new key and value
    are written into the caches in place (cast to the caches' dtype);
    returns (y, cache_k, cache_v).
    """
    B = x.shape[0]
    if write_pos is None:
        write_pos = pos
    h = rmsnorm(x, p["norm"])
    q, k, v = _qkv(p, cfg, h, pos[:, None])
    _write_rows(cache_k, write_pos.long(), k)
    _write_rows(cache_v, write_pos.long(), v)
    ok = (_decode_mask(cfg, pos, cache_k.shape[1]) if kv_valid is None
          else kv_valid)
    o = _attend_cache(q, cache_k, cache_v, ok, x.dtype)
    return x + o.reshape(B, 1, -1) @ p["wo"], cache_k, cache_v


def _write_rows(cache, at, new, held=None) -> None:
    """cache[b, at[b]] = new[b, 0] (cast to the cache's dtype) for every
    row b, in place; where `held` is given, only the rows it marks (the
    others keep their value)."""
    bidx = torch.arange(cache.shape[0], device=cache.device)
    new = new[:, 0].to(cache.dtype)
    if held is not None:
        new = torch.where(held[:, None, None], new, cache[bidx, at])
    cache[bidx, at] = new


def _decode_mask(cfg, pos, n: int, lo: int = 0) -> torch.Tensor:
    """(B, n): which of the cache positions [lo, lo + n) each row's query
    at `pos` sees (causal, and the sliding window)."""
    kpos = (lo + torch.arange(n, device=pos.device))[None, :]
    ok = kpos <= pos[:, None]
    if cfg.sliding_window:
        ok &= kpos > (pos[:, None] - cfg.sliding_window)
    return ok


def _cache_logits(q, cache_k, ok) -> torch.Tensor:
    """(B, kv, rep, 1, Smax) float32 scaled logits of the queries q
    (B,1,H,hd) against the cache's keys, NEG_INF where `ok` is False.  JAX
    promotes an f32 query against a bf16 cache to f32; so does this."""
    hd = q.shape[-1]
    ct = torch.promote_types(q.dtype, cache_k.dtype)
    qg = _group_q(q, cache_k.shape[2])                 # (B,1,kv,rep,hd)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.to(ct), cache_k.to(ct)
                          ).float() / (hd ** 0.5)
    return torch.where(ok[:, None, None, None, :], logits, NEG_INF)


def _attend_cache(q, cache_k, cache_v, ok, dtype) -> torch.Tensor:
    """Softmax attention of q (B,1,H,hd) over the cache: (B,1,kv,rep,hd),
    the probabilities in `dtype`."""
    probs = torch.softmax(_cache_logits(q, cache_k, ok), dim=-1).to(dtype)
    pt = torch.promote_types(probs.dtype, cache_v.dtype)
    return torch.einsum("bgrqk,bkgd->bqgrd", probs.to(pt), cache_v.to(pt))


def _cache_parts(placements) -> tuple[tuple, tuple, tuple[bool, ...]]:
    """From a stacked cache's placements (L, B, Smax, kv, hd), one a mesh
    dimension: a layer's rows placements (B, ...), its query placements
    (B, 1, H, hd; the heads split where the KV heads are) and which mesh
    dimensions split the sequence."""
    rows = tuple(Shard(0) if c.is_shard(1) else Replicate()
                 for c in placements)
    heads = tuple(Shard(2) if c.is_shard(3) else r
                  for c, r in zip(placements, rows))
    return rows, heads, tuple(c.is_shard(2) for c in placements)


def decode_attention_over_mesh(p, cfg, x, cache_k, cache_v, layer: int, pos,
                               shd: ShardCtx, write_pos=None, kv_valid=None
                               ) -> torch.Tensor:
    """`decode_attention` over a mesh: x (B,1,d) and pos (B,) DTensors;
    cache_k and cache_v the stacked caches (L,B,Smax,kv,hd), DTensors of
    the placements `serve_step.cache_placements` gives them (rows over DP,
    the KV heads over "model" or, where those cannot take it, the
    sequence).  `write_pos` (B,) and `kv_valid` (B,Smax), DTensors split
    as pos, are `decode_attention`'s (a ring buffer's slot and written
    slots); RoPE stays at `pos`.  Each rank writes the new key and value
    of its rows and heads into its block of layer `layer` in place, where
    its block holds the slot, and attends its queries against its block
    (`local_map`s on the blocks: DTensor's indexing of sharded tensors is
    not relied on), masked by its block's columns of `kv_valid` where
    given, else causally.  Over a sequence split each rank's logits go
    through a log-sum-exp combination: their maximum over the split (a
    partial max), then each rank's sum of exp(logit - max) and of the
    values so weighted, partial sums over the split, summed and divided.
    Returns x + the attention's output projected."""
    mesh = shd.mesh
    B = x.shape[0]
    h = rmsnorm(x, p["norm"])
    q, k, v = _qkv(p, cfg, h, pos[:, None])
    lo = local_block(cache_k.shape, cache_k.placements, mesh)[1][2]
    ck, cv = to_local(cache_k)[layer], to_local(cache_v)[layer]
    rows, heads, split = _cache_parts(cache_k.placements)
    # The slots written and, for a ring, the written slots: tensors split
    # as the cache's rows (`valid` empty where the mask is causal).
    at = (pos if write_pos is None else write_pos,)
    valid = () if kv_valid is None else (kv_valid,)
    if not any(split):
        def attend(q, k, v, pos, at, *valid):
            _write_rows(ck, at.long(), k)
            _write_rows(cv, at.long(), v)
            ok = valid[0] if valid else _decode_mask(cfg, pos, ck.shape[1])
            o = _attend_cache(q, ck, cv, ok, x.dtype)
            return o.reshape(*q.shape)

        o = local_map(attend, out_placements=(heads,),
                      in_placements=(heads, heads, heads)
                      + (rows,) * (2 + len(valid)),
                      device_mesh=mesh, redistribute_inputs=True)(
            q, k, v, pos, *at, *valid)
    else:
        o = _split_attention(cfg, q, k, v, (pos, *at, *valid), ck, cv, lo,
                             rows, heads, split, x.dtype, mesh)
    o = o.reshape(B, 1, -1)
    return x + shd.shard(dense(o, p["wo"]), "batch", "act_seq", "act_embed")


def _split_attention(cfg, q, k, v, where, ck, cv, lo: int, rows, heads,
                     split, dtype, mesh):
    """Attention over a cache whose sequence is split (positions [lo, lo +
    ck.shape[1]) on this rank): see `decode_attention_over_mesh`.  `where`
    is (pos, the slots written[, kv_valid])."""
    def over(kv_dim: int, split_as) -> tuple:
        """Placements of a tensor with its rows at dimension 0 and its KV
        heads at `kv_dim`, `split_as` on the dimensions that split the
        sequence."""
        return tuple(split_as if s else Shard(kv_dim) if hp.is_shard(2)
                     else r for s, hp, r in zip(split, heads, rows))

    whole = over(1, Replicate())
    n = ck.shape[1]

    def scores(q, k, v, pos, at, *valid):
        at = at.long() - lo
        held = (at >= 0) & (at < n)
        at = at.clamp(0, n - 1)
        _write_rows(ck, at, k, held)
        _write_rows(cv, at, v, held)
        ok = (valid[0][:, lo:lo + n] if valid
              else _decode_mask(cfg, pos, n, lo))
        lg = _cache_logits(q, ck, ok)
        return lg, lg.amax(dim=-1, keepdim=True)

    logits, m = local_map(
        scores, out_placements=(over(1, Shard(4)),
                                over(1, Partial("max"))),
        in_placements=(heads, heads, heads) + (rows,) * len(where),
        device_mesh=mesh, redistribute_inputs=True)(q, k, v, *where)
    m = m.redistribute(mesh, whole)

    def weigh(lg, m):
        w = torch.exp(lg - m)                   # 0 where masked
        return w.sum(dim=-1), torch.einsum("bgrqk,bkgd->bqgrd", w, cv.float())

    l, o = local_map(weigh, out_placements=(over(1, Partial()),
                                            over(2, Partial())),
                     in_placements=(logits.placements, whole),
                     device_mesh=mesh)(logits, m)
    l = l.redistribute(mesh, over(1, Replicate()))
    o = o.redistribute(mesh, over(2, Replicate()))
    return local_map(
        lambda o, l: (o / l.permute(0, 3, 1, 2)[..., None]).to(dtype).reshape(
            o.shape[0], 1, -1, o.shape[-1]),
        out_placements=(heads,), in_placements=(o.placements, l.placements),
        device_mesh=mesh)(o, l)


def fill_cache_over_mesh(cache, layer: int, new) -> None:
    """cache[layer, :, :S] = new (B,S,kv,hd), a DTensor, over a mesh: each
    rank writes the rows, heads and positions its block of the stacked
    cache (a DTensor of `serve_step.cache_placements`) holds, in place."""
    mesh = cache.device_mesh
    heads = _cache_parts(cache.placements)[1]
    lo = local_block(cache.shape, cache.placements, mesh)[1][2]
    block = to_local(cache)[layer]
    mine = new.redistribute(mesh, heads).to_local()
    hi = min(lo + block.shape[1], new.shape[1])
    if hi > lo:
        block[:, :hi - lo] = mine[:, lo:hi].to(block.dtype)


def prefill_attention_over_mesh(p, cfg, x, positions, cache_k, cache_v,
                                layer: int, shd: ShardCtx) -> torch.Tensor:
    """One layer's causal self-attention of a prefill over a mesh: its keys
    and values written into each rank's blocks of layer `layer` of the
    stacked caches (`fill_cache_over_mesh`), each rank's queries attended
    (`_causal_over_mesh`).  Returns x + the attention's output
    projected."""
    h = rmsnorm(x, p["norm"])
    q, k, v = _qkv(p, cfg, h, positions)
    fill_cache_over_mesh(cache_k, layer, k)
    fill_cache_over_mesh(cache_v, layer, v)
    q = shd.shard(q, "batch", "act_seq", "act_heads", None)
    o = _causal_over_mesh(q, k, v, cfg, shd).reshape(*x.shape[:2], -1)
    return x + shd.shard(dense(o, p["wo"]), "batch", "act_seq", "act_embed")


# ---------------------------------------------------------------------------
# Cross-attention (enc-dec, VLM image layers)
# ---------------------------------------------------------------------------

def cross_attention_layout(cfg) -> dict[str, Any]:
    lay = attention_layout(cfg)
    for key in ("bq", "bk", "bv"):
        lay.pop(key, None)
    return lay


def cross_attention(p, cfg, x, kv_src, shd: ShardCtx = NO_SHARD
                    ) -> torch.Tensor:
    """x: (B,Sq,d) queries; kv_src: (B,Skv,d) encoder/vision states (no
    RoPE).  The KV side is chunked (bidirectional online softmax) when
    Sq·Skv passes attn_chunk², in chunks of min(attn_chunk, Skv).  Over a
    mesh the queries' heads go over "model"; kv_src comes with its rows
    over DP (the encoder's output, the projected vision tokens or a cache
    leaf) and is not pinned again: a pin per layer would regroup the
    gradient sums of a source every layer reads, and with them the
    one-process bits.  The keys' and values' heads split where they
    divide (`_split_heads`), and each rank attends its rows and heads
    (`_bidir_over_mesh`)."""
    B, Sq, _ = x.shape
    Skv = kv_src.shape[1]
    hd = cfg.hd()
    h = rmsnorm(x, p["norm"])
    q = _split_heads(dense(h, p["wq"]), cfg.n_heads, hd)
    # JAX promotes a bf16 source (a serving cache) against f32 weights to
    # f32; so does this.
    ct = torch.promote_types(kv_src.dtype, p["wk"].dtype)
    kv_src = kv_src.to(ct)
    k = _split_heads(dense(kv_src, p["wk"].to(ct)), cfg.n_kv_heads, hd)
    v = _split_heads(dense(kv_src, p["wv"].to(ct)), cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q, k = rmsnorm(q, p["q_norm"]), rmsnorm(k, p["k_norm"])
    chunk = (min(cfg.attn_chunk, Skv)
             if cfg.attn_chunk and Sq * Skv > cfg.attn_chunk ** 2 else 0)
    if shd.mesh is None:
        o = _bidir(q, k, v, cfg, chunk)
    else:
        q = shd.shard(q, "batch", "act_seq", "act_heads", None)
        o = _bidir_over_mesh(q, k, v, cfg, shd, chunk)
    return x + shd.shard(dense(o.reshape(B, Sq, -1), p["wo"]), "batch",
                         "act_seq", "act_embed")


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def swiglu_layout(d_model: int, d_ff: int) -> dict[str, Any]:
    return {
        "w1": PDef((d_model, d_ff), ("embed", "ffn")),
        "w3": PDef((d_model, d_ff), ("embed", "ffn")),
        "w2": PDef((d_ff, d_model), ("ffn", "embed")),
        "norm": rmsnorm_layout(d_model),
    }


def swiglu(p, x: torch.Tensor, shd: ShardCtx = NO_SHARD) -> torch.Tensor:
    h = rmsnorm(x, p["norm"])
    g = F.silu(dense(h, p["w1"])) * dense(h, p["w3"])
    g = shd.shard(g, "batch", "act_seq", "act_heads")
    return x + shd.shard(dense(g, p["w2"]), "batch", "act_seq", "act_embed")


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


def embed(p, cfg, tokens: torch.Tensor, shd: ShardCtx = NO_SHARD
          ) -> torch.Tensor:
    if shd.mesh is None:
        return p["tok"][tokens.long()]
    return shd.shard(_embed_over_mesh(p["tok"], tokens, shd), "batch",
                     "act_seq", "act_embed")


def _embed_rows(table, ids, lo: int) -> torch.Tensor:
    """Rows ids of a table holding rows [lo, lo + its length); an id
    outside them gives zeros."""
    idx = ids.long() - lo
    mine = (idx >= 0) & (idx < table.shape[0])
    return torch.where(mine[..., None], table[torch.where(mine, idx, 0)], 0)


def _embed_over_mesh(tok, tokens, shd: ShardCtx) -> torch.Tensor:
    """The embedding lookup on each rank's rows (`local_map`: DTensor's
    backward of an index on a sharded table fails in torch 2.11), vocab
    parallel: the table's embedding axis is gathered (FSDP), its
    vocabulary stays split, each rank looks up the ids its shard holds and
    the parts are summed over the vocabulary's mesh axis.  Each rank's
    gradient of the table, from its own rows, is a partial sum over the
    data ranks."""
    mesh = shd.mesh
    rows = shd.placements(tokens.shape, "batch", None)
    tab = tuple(t if t.is_shard(0) and not r.is_shard() else Replicate()
                for t, r in zip(tok.placements, rows))
    out = tuple(Partial() if t.is_shard() else r for t, r in zip(tab, rows))
    grad = tuple(Partial() if r.is_shard() else t for t, r in zip(tab, rows))
    lo = local_block(tok.shape, tab, mesh)[1][0]
    return local_map(
        lambda t, ids: _embed_rows(t, ids, lo), out_placements=(out,),
        in_placements=(tab, rows), in_grad_placements=(grad, rows),
        device_mesh=mesh, redistribute_inputs=True)(tok, tokens)


def logits(p, cfg, x: torch.Tensor, shd: ShardCtx = NO_SHARD
           ) -> torch.Tensor:
    """(B,S,d) -> (B,S,padded_vocab); pad columns masked to NEG_INF."""
    h = rmsnorm(x, p["final_norm"])
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    out = dense(h, w)
    if cfg.logits_fp32:
        out = out.float()
    vp = cfg.padded_vocab()
    if vp != cfg.vocab:
        col = torch.arange(vp, device=out.device)
        out = torch.where(col < cfg.vocab, out, NEG_INF)
    return shd.shard(out, "batch", "act_seq", "act_vocab")
