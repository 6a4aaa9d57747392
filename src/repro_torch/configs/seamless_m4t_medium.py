"""seamless-m4t-medium — enc-dec 12L+12L d_model=1024 16H (kv=16) d_ff=4096
vocab=256206, multimodal.  [arXiv:2308.11596; hf]

Audio frontend is a stub: the encoder consumes precomputed frame embeddings
of length seq_len // enc_ratio."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, head_dim=64, enc_ratio=4, attn_chunk=1024,
)
