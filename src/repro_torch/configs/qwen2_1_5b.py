"""qwen2-1.5b [dense] — GQA kv=2, QKV bias, tied embeddings.
[arXiv:2407.10671; hf]"""
from .base import ArchConfig

ARCH = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    source="arXiv:2407.10671; hf",
)

SMOKE = ARCH.replace(
    n_layers=2, d_model=60, n_heads=6, n_kv_heads=2, d_ff=128,
    vocab_size=256, remat="none",
)
