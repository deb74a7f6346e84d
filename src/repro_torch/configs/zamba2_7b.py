"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention block.
81 layers = 13 x (5 mamba + 1 shared-attn application) + 3 mamba tail.
[arXiv:2411.15242; unverified]"""
from .base import ArchConfig

ARCH = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,          # shared attn block MLP width
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    hybrid_group=5,
    hybrid_tail=3,
    source="arXiv:2411.15242; unverified",
)

SMOKE = ARCH.replace(
    n_layers=9, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, ssm_state=16, ssm_head_dim=16, hybrid_group=2,
    hybrid_tail=3, remat="none",
)
