"""kimi-k2-1t-a32b — 61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840,
MoE 384 experts top-8 (trillion-param).  [arXiv:2501.kimi2; unverified]

d_ff=2048 is the per-expert hidden dim (the paper-table reading).  Deviations
recorded in DESIGN.md: no shared expert / dense first layers.  Memory fit
needs 8-bit optimizer states + the multi-pod mesh (EXPERIMENTS.md)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab=163840, head_dim=112, rope_theta=5e6,
    n_experts=384, topk=8, moe_slot_factor=7/6,  # 448 slots = 28 per 16-way EP axis attn_chunk=1024,
)
