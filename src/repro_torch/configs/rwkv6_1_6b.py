"""rwkv6-1.6b [ssm] — Finch, data-dependent decay (attention-free).
[arXiv:2404.05892; unverified]"""
from .base import ArchConfig

ARCH = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,          # d_model / rwkv_head_size
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    rwkv_head_size=64,
    norm="layernorm",
    source="arXiv:2404.05892; unverified",
)

SMOKE = ARCH.replace(
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
    vocab_size=256, rwkv_head_size=32, remat="none",
)
