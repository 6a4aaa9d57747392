"""mamba2-370m — 48L d_model=1024 (attention-free) vocab=50280 ssm_state=128.
SSD (state-space duality).  [arXiv:2405.21060; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    ssm_chunk=256, tie_embeddings=True,
)
