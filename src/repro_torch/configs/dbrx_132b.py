"""dbrx-132b [moe] — 16 experts top-4, fine-grained.
[hf:databricks/dbrx-base; unverified]"""
from .base import ArchConfig

ARCH = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    n_experts_per_tok=4,
    rope_theta=500_000.0,
    source="hf:databricks/dbrx-base; unverified",
)

SMOKE = ARCH.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=256, n_experts=4, n_experts_per_tok=2, remat="none",
    # generous capacity so smoke-scale consistency tests see no drops
    # (capacity dropping is batch-composition dependent by design)
    capacity_factor=4.0,
)
