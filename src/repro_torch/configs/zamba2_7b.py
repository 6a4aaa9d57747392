"""zamba2-7b — 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000
ssm_state=64; Mamba2 backbone + shared attention blocks.  [arXiv:2411.15242;
unverified]

81 block applications = 11 groups of (6 mamba + 1 shared-attn application)
+ 4 tail mamba.  The shared block uses a 4096 sliding window so long_500k
decode stays sub-quadratic (DESIGN.md §6)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000, head_dim=112, ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    ssm_conv=4, ssm_chunk=128, attn_every=6, sliding_window=4096, attn_chunk=1024,
)
