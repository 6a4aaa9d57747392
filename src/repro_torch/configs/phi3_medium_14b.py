"""phi3-medium-14b — 40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
RoPE + SwiGLU + GQA.  [arXiv:2404.14219; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, d_ff=17920,
    vocab=100352, head_dim=128, rope_theta=1e4, attn_chunk=1024,
    # 40 heads / 10 KV heads don't divide the 16-way TP axis: shard the
    # sequence over 'model' instead (§Perf iteration).
    sharding_hints=(("act_seq", "model"),),
)
