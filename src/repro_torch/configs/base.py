"""ArchConfig: one dataclass describing every supported architecture family.

Exact published dimensions live in the per-arch files of this package; smoke
tests use `reduced()` to shrink any config to CPU scale while preserving the
family's structure (GQA ratios, expert counts > topk, SSM state, etc.).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False      # qwen2
    qk_norm: bool = False       # qwen3
    rope_theta: float = 10_000.0
    sliding_window: int = 0     # 0 = full attention; >0 = SWA window
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    topk: int = 0
    # SkewShares dispatch: physical slots = round(n_experts · slot_factor);
    # hot experts get replica slots per core.moe_shares.plan_dispatch.
    moe_slot_factor: float = 1.0
    moe_capacity_factor: float = 1.25

    # SSM (Mamba2 SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256

    # hybrid (zamba2): one shared attention block applied every N ssm blocks
    attn_every: int = 0

    # enc-dec (seamless): encoder layers (n_layers = decoder layers)
    enc_layers: int = 0
    # frontend stub: encoder sees precomputed frame embeddings seq/enc_ratio long
    enc_ratio: int = 4

    # vlm (llama-3.2-vision): cross-attn layer every N self-attn layers
    cross_attn_every: int = 0
    vision_tokens: int = 1601   # stub patch-embedding count per image
    vision_dim: int = 1280      # stub frontend output dim

    # numerics / execution
    param_dtype: str = "bfloat16"
    remat: str = "full"         # none | full | dots
    scan_layers: bool = True
    attn_chunk: int = 0         # 0 = dense attention; >0 = chunked (flash-style)
    logits_fp32: bool = True
    # Per-arch sharding-rule overrides applied on top of default_rules
    # (name, mesh-axis-or-None); e.g. sequence parallelism for archs whose
    # head counts don't divide the TP axis (§Perf qwen2/phi3 iterations).
    sharding_hints: tuple[tuple[str, str | None], ...] = ()

    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def n_slots(self) -> int:
        return int(round(self.n_experts * self.moe_slot_factor))

    def padded_vocab(self) -> int:
        """Embedding tables pad to a 128 multiple so the vocab axis always
        shards over the 16-way TP axis (odd vocabs like seamless's 256206
        otherwise replicate — a 67 GB fp32 logits tensor at 32k prefill; see
        EXPERIMENTS.md §Perf).  Padded logit columns are masked to -inf, so
        softmax/argmax semantics are exactly the logical vocab's."""
        return -(-self.vocab // 128) * 128

    def is_decoder_only(self) -> bool:
        return self.family in ("dense", "moe", "ssm", "hybrid", "vlm")

    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence scaling: SSM and hybrid (windowed attn) only."""
        return self.family in ("ssm", "hybrid")

    def reduced(self) -> "ArchConfig":
        """CPU-scale config of the same family for smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=(min(max(self.n_kv_heads * 4 // self.n_heads, 1), 4)
                        if self.n_heads else 0),
            d_ff=256 if self.d_ff else 0,
            head_dim=32 if self.n_heads else 0,
            vocab=512,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            topk=min(self.topk, 2) if self.topk else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=16 if self.ssm_state else 256,
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            cross_attn_every=(min(self.cross_attn_every, 2)
                              if self.cross_attn_every else 0),
            vision_tokens=16 if self.family == "vlm" else self.vision_tokens,
            vision_dim=64 if self.family == "vlm" else self.vision_dim,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            attn_chunk=0,
        )


# ---------------------------------------------------------------------------
# Input shape cells (assigned): every arch × its four shapes.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeCell("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeCell("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeCell("long_500k",   524_288, 1,   "decode"),
}


def cell_applicable(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """(runs?, reason) — the skip rules recorded in DESIGN.md §6."""
    cell = SHAPES[shape]
    if cell.name == "long_500k" and not cfg.supports_long_context():
        return False, ("pure full-attention arch: O(S^2) at 524288 is not "
                       "runnable; skipped per DESIGN.md")
    return True, ""
