"""mixtral-8x22b — 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8 experts top-2, sliding-window attention.  [arXiv:2401.04088; hf]

moe_slot_factor=2: 16 physical expert slots — SkewShares replicates the
hottest experts (core.moe_shares)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=32768, head_dim=128, rope_theta=1e6, sliding_window=4096,
    # 16 slots: divisible by the 16-way EP axis (EXPERIMENTS.md §Perf)
    n_experts=8, topk=2, moe_slot_factor=2.0, attn_chunk=1024,
)
