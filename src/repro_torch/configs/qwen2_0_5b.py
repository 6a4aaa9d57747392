"""qwen2-0.5b — 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
GQA with QKV bias.  [arXiv:2407.10671; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab=151936, head_dim=64, qkv_bias=True, rope_theta=1e6,
    tie_embeddings=True, attn_chunk=1024,
    # 14 heads / 2 KV heads divide neither mesh axis: shard the SEQUENCE over
    # 'model' and keep the (tiny, 0.5B) weights replicated (§Perf iteration).
    sharding_hints=(("act_seq", "model"), ("embed", None)),
)
