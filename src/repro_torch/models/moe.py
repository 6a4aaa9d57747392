"""MoE transformer (mixtral-8x22b, kimi-k2) with SkewShares expert dispatch.

The FFN is a top-k mixture of experts routed through the paper's machinery
(core.moe_shares): experts own *physical slots*; hot experts hold 2^j replica
slots and their tokens hash-split across replicas — Example 1.2's grid applied
to expert parallelism.  Dispatch is sort-based (a stable sort by slot, a
capacity clamp, a scatter into (B, n_slots, cap, d)), per sequence.

Per-expert token loads are counted on the card by the `segment_histogram`
kernel (kernels/csrc/segment_histogram.cu) in every `moe_ffn` call.
`forward` returns them summed over layers; `prefill` and `decode_step` drop
them, as the reference does.

The model is a `common.Model` whose parameters are the layout's tree
(`blocks` stacked on a leading layer axis); `model.blocks[i]` is layer i
(`Block` → `attn` (`transformer.Attention`), `moe` (`MoEFFN`)), views
of the stacked tensors.  The functions below take it where the reference
takes its parameter dict: `forward(params, cfg, tokens)`, with the same
`cfg` or a variant of it.  `model.use_kernels` is the dispatch knob of the
executor's config of the same name: False runs the histogram's plain
version on any device.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch
from torch.nn import functional as F

from ..core.moe_shares import MoEDispatchPlan, plan_dispatch, route_tokens
from ..kernels import ops
from . import layers as L
from . import transformer as TF
from .common import Layout, Model, PDef, TensorView, stack_layers


def moe_layout(cfg) -> Layout:
    n_slots = cfg.n_slots()
    return {
        "router": PDef((cfg.d_model, cfg.n_experts), ("embed", None), scale=0.01),
        "w1": PDef((n_slots, cfg.d_model, cfg.d_ff), ("experts", "embed", "expert_ffn")),
        "w3": PDef((n_slots, cfg.d_model, cfg.d_ff), ("experts", "embed", "expert_ffn")),
        "w2": PDef((n_slots, cfg.d_ff, cfg.d_model), ("experts", "expert_ffn", "embed")),
        "norm": L.rmsnorm_layout(cfg.d_model),
    }


def block_layout(cfg) -> Layout:
    return {"attn": L.attention_layout(cfg), "moe": moe_layout(cfg)}


def layout(cfg) -> Layout:
    return {"embed": L.embed_layout(cfg),
            "blocks": stack_layers(block_layout(cfg), cfg.n_layers)}


def build_plan(cfg, loads: np.ndarray | None = None) -> MoEDispatchPlan:
    """Static dispatch plan; `loads` from trainer metrics enables re-planning."""
    if loads is None:
        loads = np.ones(cfg.n_experts)
    return plan_dispatch(loads, cfg.n_slots())


def top_experts(gates: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(weights, int32 expert ids) of the k largest gates of each row, in
    descending order with ties to the lower expert index, as
    `jax.lax.top_k`'s.  A stable descending sort gives that order;
    `torch.topk` documents none (on the CPU it gives the higher index)."""
    w, i = torch.sort(gates, dim=-1, descending=True, stable=True)
    return w[..., :k], i[..., :k].to(torch.int32)


def moe_ffn(p, cfg, plan: MoEDispatchPlan, x: torch.Tensor, *,
            use_kernels: bool = True) -> tuple[torch.Tensor, dict]:
    """x (B,S,d) -> (x + y (B,S,d), {'aux_loss': (), 'expert_load': (E,)
    int32, 'dropped_tokens': ()}).

    Dispatch is per sequence: each row's S·K assignments sort by slot
    (stably), the first `cap` of each slot pack into (n_slots, cap, d), and
    the rest drop (their expert output is zero).
    """
    B, S, d = x.shape
    K = cfg.topk
    n_slots = plan.n_slots
    dev = x.device
    h = L.rmsnorm(x, p["norm"])                                   # (B,S,d)

    # Router (fp32 for stable softmax).
    logits = h.float() @ p["router"].float()
    gates = torch.softmax(logits, dim=-1)                         # (B,S,E)
    weights, eidx = top_experts(gates, K)                         # (B,S,K)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)

    # Aux load-balancing loss (switch-style) + the on-card load histogram.
    frac_prob = gates.mean(dim=(0, 1))                            # (E,)
    onehot_top1 = F.one_hot(eidx[..., 0].long(), cfg.n_experts).float()
    frac_tok = onehot_top1.mean(dim=(0, 1))
    aux = cfg.n_experts * (frac_prob * frac_tok).sum()
    load = ops.segment_histogram(eidx.reshape(-1), cfg.n_experts,
                                 use_kernels=use_kernels)

    # SkewShares slot routing: hot experts' tokens hash-split across replicas
    # (hash of the in-sequence position splits evenly within every sequence).
    pos_ids = torch.arange(S, dtype=torch.int32, device=dev)[None, :, None]
    pos_ids = pos_ids.expand(B, S, K)
    slots = route_tokens(plan, eidx.reshape(-1),
                         pos_ids.reshape(-1)).reshape(B, S * K)

    cap = max(1, int(np.ceil(S * K / n_slots * cfg.moe_capacity_factor)))
    n = S * K
    trash = n_slots * cap              # the one row that dropped copies hit
    s_sorted, order = torch.sort(slots, dim=1, stable=True)
    start = torch.searchsorted(s_sorted, s_sorted, right=False)
    pos = torch.arange(n, device=dev) - start
    keep = pos < cap
    flat_idx = torch.where(keep, s_sorted.long() * cap + pos, trash)
    rows = torch.gather(h, 1, (order // K)[..., None].expand(B, n, d))
    buf = h.new_zeros(B, trash + 1, d)
    buf.scatter_(1, flat_idx[..., None].expand(B, n, d), rows)
    xe = buf[:, :trash].reshape(B, n_slots, cap, d)
    dropped = (~keep).sum()

    # Expert FFN, batched over (batch, slots).
    g = F.silu(torch.einsum("becd,edf->becf", xe, p["w1"]))
    g = g * torch.einsum("becd,edf->becf", xe, p["w3"])
    ye = torch.einsum("becf,efd->becd", g, p["w2"]).reshape(B, trash, d)

    # Combine: back to (token, k) order through the inverse of `order`.
    safe = torch.where(keep, flat_idx, 0)
    y_sorted = torch.gather(ye, 1, safe[..., None].expand(B, n, d))
    y_sorted = torch.where(keep[..., None], y_sorted, 0)
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=dev).expand(B, n))
    y_tok_k = torch.gather(y_sorted, 1, inv[..., None].expand(B, n, d))
    y_tok_k = y_tok_k.reshape(B, S, K, d)
    y = (y_tok_k * weights[..., None].to(x.dtype)).sum(dim=2)
    return x + y, {"aux_loss": aux, "expert_load": load,
                   "dropped_tokens": dropped}


def block_apply(p, cfg, plan, x, positions, *, use_kernels: bool = True
                ) -> tuple[torch.Tensor, dict]:
    x = L.self_attention(p["attn"], cfg, x, positions)
    return moe_ffn(p["moe"], cfg, plan, x, use_kernels=use_kernels)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class MoEFFN(TensorView):
    """router, w1, w3, w2 (one matrix per slot), norm."""

    def __init__(self, cfg, tensors: dict):
        super().__init__(tensors)
        self.cfg = cfg

    def __call__(self, x, plan, use_kernels: bool = True):
        return moe_ffn(self, self.cfg, plan, x, use_kernels=use_kernels)


class Block(TensorView):
    """One layer: attn, moe."""

    def __init__(self, cfg, tensors: dict):
        super().__init__({"attn": TF.Attention(cfg, tensors["attn"]),
                          "moe": MoEFFN(cfg, tensors["moe"])})
        self.cfg = cfg

    def __call__(self, x, positions, plan, use_kernels: bool = True):
        return block_apply(self, self.cfg, plan, x, positions,
                           use_kernels=use_kernels)


def build(cfg, tensors: dict) -> Model:
    """The model over a layout-shaped tree of tensors (`blocks` stacked on a
    leading layer axis, as `init_params` makes it); its layers are views of
    the stacked tensors.  Raises on a missing key or a shape that is not the
    layout's."""
    return Model(cfg, layout(cfg), tensors, forward,
                 {"blocks": partial(Block, cfg)})


def forward(params, cfg, tokens: torch.Tensor, plan: MoEDispatchPlan | None = None,
            last_only: bool = False) -> tuple[torch.Tensor, dict]:
    """tokens (B,S) -> (logits (B,S,padded_vocab), or (B,1,·) if last_only;
    {'aux_loss', 'expert_load' (E,) int32 summed over layers}).  Under
    `remat="full"` with autograd on, each layer runs again in the backward
    pass, its `segment_histogram` too."""
    plan = plan or build_plan(cfg)
    B, S = tokens.shape
    dev = tokens.device
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    x = L.embed(params["embed"], cfg, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    loads = torch.zeros(cfg.n_experts, dtype=torch.int32, device=dev)
    body = TF._remat(lambda x, lp: block_apply(
        lp, cfg, plan, x, positions, use_kernels=params.use_kernels), cfg.remat)
    for lp in params["blocks"]:
        x, stats = body(x, lp)
        aux = aux + stats["aux_loss"]
        loads = loads + stats["expert_load"]
    if last_only:
        x = x[:, -1:]
    lg = L.logits(params["embed"], cfg, x)
    return lg, {"aux_loss": aux / cfg.n_layers, "expert_load": loads}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device=None) -> dict:
    return TF.init_cache(cfg, batch, max_seq, dtype, device=device)


def decode_step(params, cfg, cache, tokens, pos,
                plan: MoEDispatchPlan | None = None):
    """tokens (B,1), pos (B,) -> (logits (B,1,V), cache).  Each layer's new
    key and value go into `cache` in place."""
    plan = plan or build_plan(cfg)
    return TF.decode_layers(params, cfg, cache, tokens, pos, lambda lp, x: moe_ffn(
        lp["moe"], cfg, plan, x, use_kernels=params.use_kernels)[0])


def prefill(params, cfg, tokens, cache, plan: MoEDispatchPlan | None = None):
    """Fill `cache[:, :, :S]` in place from a whole prompt (B,S); returns
    (last-position logits (B,1,V), cache)."""
    plan = plan or build_plan(cfg)
    return TF.prefill_layers(params, cfg, tokens, cache, lambda lp, x: moe_ffn(
        lp["moe"], cfg, plan, x, use_kernels=params.use_kernels)[0])
