"""Mamba2 (SSD — state-space duality) blocks: mamba2-370m and the zamba2 hybrid.

Training/prefill uses the chunked SSD algorithm (arXiv:2405.21060 §6): the
sequence splits into chunks; within a chunk the duality gives a masked
attention-like einsum, across chunks a small recurrent state (B, H, N, P)
carries over.  Decode is the classical single-step SSM update — constant
memory.

Layout and arithmetic follow the reference's (`repro/models/ssm.py`):
fused in_proj -> [z, x, B, C, dt], depthwise causal conv over (x, B, C) by
shifted adds in the activations' dtype, the SSD in float32 (dt, B and C
cast up), gated RMSNorm, out_proj.  One difference: the intra-chunk decay
masks its exponent before the `exp` (`exp(where(causal, Δcum, -inf))`),
where the reference takes `exp(Δcum)` of every (q, k) pair and masks the
product afterwards.  For k > q, Δcum is positive and over a chunk of 128
or 256 rows it overflows to inf: the reference's forward is still right
(the mask picks 0), but its backward multiplies the zero cotangent by inf
(ROADMAP §3).  Here the forward is the reference's and the gradient is
finite.

Over a mesh (`shd`, a `common.ShardCtx`) the projections are DTensor
products with `ssm_inner` over "model", each rank's rows keep the whole
in-projection for the split and the conv (run on the rank's rows), the
chunked SSD runs on each rank's own rows and heads (`local_map`: its
grouped reshapes and the carried state have no DTensor strategies), and
the block's output is pinned at the reference's one site.

The model is a `common.Model`: `blocks` stacked on a leading layer axis,
`model.blocks[i]` layer i.  `decode_step` writes each layer's `ssm` and
`conv` state into the stacked cache in place; over a mesh each rank its
block of them (`decode_over_mesh`).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.nn import functional as F

from ..core.executor import resolve_device
from . import layers as L
from . import transformer as TF
from .common import (NO_SHARD, Layout, Model, PDef, ShardCtx, local_block,
                     stack_layers, to_local)


def dims(cfg) -> tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_dim = d_inner + 2 * N
    return d_inner, H, N, conv_dim


def mamba_layout(cfg) -> Layout:
    d_inner, H, N, conv_dim = dims(cfg)
    return {
        "in_proj": PDef((cfg.d_model, 2 * d_inner + 2 * N + H),
                        ("embed", "ssm_inner")),
        "conv_w": PDef((cfg.ssm_conv, conv_dim), ("conv_k", None), scale=0.1),
        "conv_b": PDef((conv_dim,), (None,), init="zeros"),
        "A_log": PDef((H,), (None,), init="zeros"),
        "D": PDef((H,), (None,), init="ones"),
        "dt_bias": PDef((H,), (None,), init="zeros"),
        "out_norm": PDef((d_inner,), (None,), init="ones"),
        "out_proj": PDef((d_inner, cfg.d_model), ("ssm_inner", "embed")),
        "norm": L.rmsnorm_layout(cfg.d_model),
    }


def layout(cfg) -> Layout:
    return {"embed": L.embed_layout(cfg),
            "blocks": stack_layers(mamba_layout(cfg), cfg.n_layers)}


def _split_proj(p, cfg, h, shd: ShardCtx = NO_SHARD):
    d_inner, H, N, conv_dim = dims(cfg)
    # Over a mesh each rank's rows keep the whole projection, which the
    # split and the depthwise conv cut across the "ssm_inner" shards.
    zxbcdt = shd.shard(L.dense(h, p["in_proj"]), "batch", None, None)
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt = zxbcdt[..., d_inner + conv_dim:]
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv via shifted adds (kernel size is tiny), in
    xBC's dtype."""
    K, S = w.shape[0], xBC.shape[1]
    out = torch.zeros_like(xBC)
    for i in range(K):
        shift = K - 1 - i
        piece = xBC if shift == 0 else F.pad(xBC, (0, 0, shift, 0))[:, :S]
        out = out + piece * w[i]
    return F.silu(out + b)


# Elements of one group's (B, chunks, Q, Q, H) decay tensor: the chunks of
# a group are computed at once (a float32 tensor of 256 MB at most), the
# groups one after another, so that memory stays bounded at long sequences
# while a 4 x 2,048 sequence takes one or two groups' launches, not a
# chunk's each.
_SSD_GROUP_ELEMS = 1 << 26


def _ssd_chunks(state, xc, dtc, A, Bc, Cc):
    """G chunks of Q rows: the intra-chunk (dual, attention-like) terms of
    all of them at once, then the recurrent state carried through them in
    order.  state (B,H,N,P) f32, entering the first; xc (B,G,Q,H,P); dtc
    (B,G,Q,H), Bc, Cc (B,G,Q,N) f32.  Returns (the state leaving the last,
    y (B,G,Q,H,P) f32).  Per chunk the arithmetic is the reference's
    `chunk_step`."""
    G, Q = xc.shape[1], xc.shape[2]
    dA = dtc * A                                         # (B,G,Q,H) ≤ 0
    cum = torch.cumsum(dA, dim=2)
    xdt = xc.float() * dtc[..., None]                    # (B,G,Q,H,P)
    CB = torch.einsum("bgqn,bgkn->bgqk", Cc, Bc)         # (B,G,Q,Q)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    # The exponent is masked before the exp (module docstring).
    delta = torch.where(causal[:, :, None],
                        cum[:, :, :, None, :] - cum[:, :, None, :, :],
                        -torch.inf)
    M = CB[..., None] * torch.exp(delta)                 # (B,G,Q,K,H)
    y_diag = torch.einsum("bgqkh,bgkhp->bgqhp", M, xdt)
    decay_last = torch.exp(cum[:, :, -1:, :] - cum)      # (B,G,Q,H)
    s_c = torch.einsum("bgkn,bgkh,bgkhp->bghnp", Bc, decay_last, xdt)
    chunk_decay = torch.exp(cum[:, :, -1])[..., None, None]   # (B,G,H,1,1)
    entering = []
    for g in range(G):
        entering.append(state)
        state = s_c[:, g] + state * chunk_decay[:, g]
    y_off = torch.einsum("bgqn,bgqh,bghnp->bgqhp", Cc, torch.exp(cum),
                         torch.stack(entering, dim=1))
    return state, y_diag + y_off


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk: int) -> torch.Tensor:
    """Chunked SSD scan.

    xh (B,S,H,P); dt (B,S,H) [post-softplus]; A (H,) negative;
    Bm, Cm (B,S,N) (single group, shared across heads).
    Returns y (B,S,H,P) in xh's dtype.  The full chunks go in groups
    (`_SSD_GROUP_ELEMS`); the last chunk is short where the reference pads
    it: its pad rows (dt = 0) reach only their own outputs and the final
    state, which the reference drops.  No chunk is recomputed on its own in
    the backward pass (the reference wraps each in `jax.checkpoint`):
    under remat "full" a block's chunks are recomputed together, one block
    at a time.
    """
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    state = torch.zeros((Bsz, H, N, P), dtype=torch.float32,
                        device=xh.device)
    n_full = S // chunk
    per_group = max(1, _SSD_GROUP_ELEMS // (Bsz * chunk * chunk * H))
    spans = [(c, min(per_group, n_full - c), chunk)
             for c in range(0, n_full, per_group)]
    if S % chunk:
        spans.append((n_full, 1, S % chunk))
    ys = []
    for c, g, q in spans:
        rows = slice(c * chunk, c * chunk + g * q)

        def grouped(t):
            return t[:, rows].reshape(Bsz, g, q, *t.shape[2:])

        state, y = _ssd_chunks(state, grouped(xh), grouped(dt).float(), A,
                               grouped(Bm).float(), grouped(Cm).float())
        ys.append(y.reshape(Bsz, g * q, H, P))
    return torch.cat(ys, dim=1).to(xh.dtype)


def _conv_over_rows(shd: ShardCtx, xBC, w, b) -> torch.Tensor:
    """`_causal_conv` on each rank's rows (`local_map`: DTensor's backward
    of the shifts' pad fails in torch 2.11); each rank's gradient of the
    replicated kernel and bias, from its own rows, is a partial sum over
    the data ranks."""
    if shd.mesh is None:
        return _causal_conv(xBC, w, b)
    rows = shd.placements(xBC.shape, "batch", None, None)
    whole = (Replicate(),) * shd.mesh.ndim
    grad = tuple(Partial() if r.is_shard() else Replicate() for r in rows)
    return local_map(
        _causal_conv, out_placements=(rows,),
        in_placements=(rows, whole, whole),
        in_grad_placements=(rows, grad, grad), device_mesh=shd.mesh,
        redistribute_inputs=True)(xBC, w, b)


def _ssd_over_heads(shd: ShardCtx, xs, dt, A, Bm, Cm, chunk: int):
    """`_ssd_chunked` on each rank's rows and heads: xs (B,S,H,P) and dt
    (B,S,H) by ("batch", "ssm_heads"), A (H,) by "ssm_heads", Bm and Cm
    (B,S,N) by rows alone (each rank's gradient of them covers its heads:
    a partial sum over the heads' mesh axis)."""
    if shd.mesh is None:
        return _ssd_chunked(xs, dt, A, Bm, Cm, chunk)
    heads = shd.placements(xs.shape, "batch", None, "ssm_heads", None)
    per_head = shd.placements(dt.shape, "batch", None, "ssm_heads")
    a_heads = shd.placements(A.shape, "ssm_heads")
    rows = shd.placements(Bm.shape, "batch", None, None)
    a_grad = tuple(Partial() if isinstance(r, Shard) else a
                   for r, a in zip(rows, a_heads))
    bc_grad = tuple(Partial() if isinstance(h, Shard) and isinstance(r, Replicate)
                    else r for r, h in zip(rows, heads))
    return local_map(
        lambda *t: _ssd_chunked(*t, chunk), out_placements=(heads,),
        in_placements=(heads, per_head, a_heads, rows, rows),
        in_grad_placements=(heads, per_head, a_grad, bc_grad, bc_grad),
        device_mesh=shd.mesh, redistribute_inputs=True)(xs, dt, A, Bm, Cm)


def mamba_block(p, cfg, x: torch.Tensor, shd: ShardCtx = NO_SHARD
                ) -> torch.Tensor:
    """Full-sequence Mamba2 block (training / prefill)."""
    d_inner, H, N, conv_dim = dims(cfg)
    h = L.rmsnorm(x, p["norm"])
    z, xBC, dt = _split_proj(p, cfg, h, shd)
    xBC = _conv_over_rows(shd, xBC, p["conv_w"], p["conv_b"])
    xs = xBC[..., :d_inner].reshape(*x.shape[:2], H, cfg.ssm_head_dim)
    Bm = xBC[..., d_inner:d_inner + N]
    Cm = xBC[..., d_inner + N:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    y = _ssd_over_heads(shd, xs, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + xs * p["D"][None, None, :, None].to(xs.dtype)
    y = y.reshape(*x.shape[:2], d_inner)
    y = L.rmsnorm(y * F.silu(z), p["out_norm"])
    return x + shd.shard(L.dense(y, p["out_proj"]), "batch", "act_seq",
                         "act_embed")


# ---------------------------------------------------------------------------
# Decode: constant-size recurrent state.
# ---------------------------------------------------------------------------

def init_block_state(cfg, batch: int, dtype=torch.bfloat16, *, device=None,
                     n: int | None = None) -> dict:
    """{'ssm': (B,H,N,P) f32, 'conv': (B,K-1,conv_dim) dtype}, zeroed, each
    with a leading axis of `n` layers when `n` is given."""
    d_inner, H, N, conv_dim = dims(cfg)
    dev = resolve_device(device)
    lead = () if n is None else (n,)
    return {
        "ssm": torch.zeros(lead + (batch, H, N, cfg.ssm_head_dim),
                           dtype=torch.float32, device=dev),
        "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=dtype, device=dev),
    }


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device=None) -> dict:
    """Every layer's zeroed state, stacked: {'ssm': (L,B,H,N,P) f32,
    'conv': (L,B,K-1,conv_dim)}, on the card unless the caller asks for
    the CPU."""
    return init_block_state(cfg, batch, dtype, device=device,
                            n=cfg.n_layers)


def cache_axes(cfg) -> dict:
    """The logical axes of `init_cache`'s leaves."""
    return {"ssm": ("layers", "batch", "ssm_heads", None, None),
            "conv": ("layers", "batch", None, "ssm_inner")}


def mamba_decode(p, cfg, x, state: dict) -> tuple[torch.Tensor, dict]:
    """x (B,1,d); state {'ssm': (B,H,N,P) f32, 'conv': (B,K-1,conv_dim)}.
    Returns (y, new state); `state` is not written."""
    d_inner, H, N, conv_dim = dims(cfg)
    B = x.shape[0]
    h = L.rmsnorm(x, p["norm"])
    z, xBC, dt = _split_proj(p, cfg, h)
    window = torch.cat([state["conv"], xBC.to(state["conv"].dtype)],
                       dim=1)                              # (B, K, conv_dim)
    conv_out = torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float())
    xBC1 = F.silu(conv_out + p["conv_b"].float()).to(x.dtype)  # (B, conv_dim)
    xs = xBC1[:, :d_inner].reshape(B, H, cfg.ssm_head_dim)
    Bt = xBC1[:, d_inner:d_inner + N].float()
    Ct = xBC1[:, d_inner + N:].float()
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"])     # (B,H)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt1 * A[None, :])                       # (B,H)
    xdt = xs.float() * dt1[..., None]
    ssm = state["ssm"] * dA[:, :, None, None] + torch.einsum(
        "bn,bhp->bhnp", Bt, xdt)
    y = torch.einsum("bn,bhnp->bhp", Ct, ssm).to(x.dtype)
    y = y + xs * p["D"][None, :, None].to(xs.dtype)
    y = y.reshape(B, 1, d_inner)
    y = L.rmsnorm(y * F.silu(z), p["out_norm"])
    return x + y @ p["out_proj"], {"ssm": ssm, "conv": window[:, 1:]}


def decode_into(p, cfg, x, states: dict, i: int) -> torch.Tensor:
    """One Mamba decode step of layer `i` of the stacked `states`
    ({'ssm', 'conv'}, (L, B, ...)), its new state written in place."""
    x, new = mamba_decode(p, cfg, x, {k: v[i] for k, v in states.items()})
    for k, v in new.items():
        states[k][i] = v
    return x


def decode_over_mesh(p, cfg, x, states: dict, i: int, shd: ShardCtx
                     ) -> torch.Tensor:
    """`decode_into` over a mesh: `states` DTensors of the cache's
    placements (`ssm` (L,B,H,N,P) over "ssm_heads", `conv` (L,B,K-1,
    conv_dim) over "ssm_inner", rows over DP).  Each rank updates its own
    block of layer i's states in place (`local_map`s on the blocks): the
    conv window on its columns, whose outputs are gathered over the mesh,
    and the SSM state on its heads, whose outputs are gathered likewise.
    The arithmetic is `mamba_decode`'s."""
    d_inner, H, N, conv_dim = dims(cfg)
    mesh = shd.mesh
    B = x.shape[0]
    h = L.rmsnorm(x, p["norm"])
    z, xBC, dt = _split_proj(p, cfg, h, shd)
    rows3 = shd.placements(xBC.shape, "batch", None, None)
    rows2 = shd.placements((B, conv_dim), "batch", None)
    conv, ssm = states["conv"], states["ssm"]
    c0 = local_block(conv.shape, conv.placements, mesh)[1][3]
    h0 = local_block(ssm.shape, ssm.placements, mesh)[1][2]
    conv_l, ssm_l = to_local(conv)[i], to_local(ssm)[i]
    whole = (Replicate(),) * mesh.ndim

    def conv_step(xBC, w, b):
        cols = slice(c0, c0 + conv_l.shape[-1])
        window = torch.cat([conv_l, xBC[:, :, cols].to(conv_l.dtype)],
                           dim=1)                         # (B, K, cols)
        out = torch.einsum("bkc,kc->bc", window.float(), w[:, cols].float())
        conv_l.copy_(window[:, 1:])
        return F.silu(out + b[cols].float()).to(x.dtype)

    col_pl = tuple(Shard(1) if c.is_shard(3) else r
                   for c, r in zip(conv.placements, rows2))
    xBC1 = local_map(conv_step, out_placements=(col_pl,),
                     in_placements=(rows3, whole, whole), device_mesh=mesh,
                     redistribute_inputs=True)(
        xBC, p["conv_w"], p["conv_b"]).redistribute(mesh, rows2)
    xs = xBC1[:, :d_inner].reshape(B, H, cfg.ssm_head_dim)
    Bt = xBC1[:, d_inner:d_inner + N].float()
    Ct = xBC1[:, d_inner + N:].float()
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"])     # (B,H)
    A = -torch.exp(p["A_log"].float())

    def ssm_step(xs, dt1, A, Bt, Ct):
        hs = slice(h0, h0 + ssm_l.shape[1])
        dA = torch.exp(dt1[:, hs] * A[None, hs])
        xdt = xs[:, hs].float() * dt1[:, hs, None]
        new = ssm_l * dA[:, :, None, None] + torch.einsum("bn,bhp->bhnp",
                                                          Bt, xdt)
        ssm_l.copy_(new)
        return torch.einsum("bn,bhnp->bhp", Ct, new).to(x.dtype)

    rows_h = shd.placements(xs.shape, "batch", None, None)
    head_pl = tuple(Shard(1) if c.is_shard(2) else r
                    for c, r in zip(ssm.placements, rows_h))
    rows_bh = shd.placements(dt1.shape, "batch", None)
    y = local_map(ssm_step, out_placements=(head_pl,),
                  in_placements=(rows_h, rows_bh, whole, rows_bh, rows_bh),
                  device_mesh=mesh, redistribute_inputs=True)(
        xs, dt1, A, Bt, Ct).redistribute(mesh, rows_h)
    y = y + xs * p["D"][None, :, None].to(xs.dtype)
    y = y.reshape(B, 1, d_inner)
    y = L.rmsnorm(y * F.silu(z), p["out_norm"])
    return x + shd.shard(L.dense(y, p["out_proj"]), "batch", "act_seq",
                         "act_embed")


# ---------------------------------------------------------------------------
# Whole-model entry points (mamba2-370m).
# ---------------------------------------------------------------------------

def build(cfg, tensors: dict) -> Model:
    """The model over a layout-shaped tree of tensors; raises on a missing
    key or a shape that is not the layout's."""
    return Model(cfg, layout(cfg), tensors, forward)


def forward(params, cfg, tokens: torch.Tensor, last_only: bool = False,
            shd: ShardCtx = NO_SHARD) -> torch.Tensor:
    """tokens (B,S) -> logits (B,S,padded_vocab), (B,1,·) if last_only."""
    x = L.embed(params["embed"], cfg, tokens, shd)
    body = TF._remat(lambda x, lp: mamba_block(lp, cfg, x, shd), cfg.remat)
    for lp in params["blocks"]:
        x = body(x, lp)
    if last_only:
        x = x[:, -1:]
    return L.logits(params["embed"], cfg, x, shd)


def decode_step(params, cfg, cache: dict, tokens, pos,
                shd: ShardCtx = NO_SHARD):
    """tokens (B,1), pos (B,) (unused: the state carries the position) ->
    (logits (B,1,V), cache), each layer's state written in place (over a
    mesh, each rank's block of it)."""
    x = L.embed(params["embed"], cfg, tokens, shd)
    for i, lp in enumerate(params["blocks"]):
        if shd.mesh is None:
            x = decode_into(lp, cfg, x, cache, i)
        else:
            x = decode_over_mesh(lp, cfg, x, cache, i, shd)
    return L.logits(params["embed"], cfg, x, shd), cache


def prefill(params, cfg, tokens, cache, shd: ShardCtx = NO_SHARD):
    """Last-position logits of the parallel form; the cache comes back as
    it was given (the reference's documented trade-off: its decode state
    is not rebuilt from the prompt)."""
    return forward(params, cfg, tokens, last_only=True, shd=shd), cache
