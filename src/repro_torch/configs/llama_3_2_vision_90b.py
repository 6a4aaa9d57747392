"""llama-3.2-vision-90b — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, cross-attn image layers.  [hf:meta-llama/...-Vision; unverified]

100 layers = 20 groups of (4 self-attn + 1 gated image cross-attn); the vision
frontend is a stub (input_specs supplies precomputed patch embeddings)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab=128256, head_dim=128, rope_theta=5e5, cross_attn_every=4,
    vision_tokens=1601, vision_dim=1280, attn_chunk=1024,
)
