"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from .base import ArchConfig

ARCH = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,           # per-expert ffn width (moe_intermediate_size)
    moe_d_ff=1408,
    vocab_size=151936,
    n_experts=60,
    n_experts_per_tok=4,
    n_shared_experts=4,  # shared GLU fused to width 4*1408 = 5632
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
)

SMOKE = ARCH.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=48, moe_d_ff=48,
    vocab_size=256, n_experts=8, n_experts_per_tok=2, n_shared_experts=1,
    remat="none", capacity_factor=4.0,
)
