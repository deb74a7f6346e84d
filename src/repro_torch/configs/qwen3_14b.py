"""qwen3-14b [dense] — qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]"""
from .base import ArchConfig

ARCH = ArchConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B; hf",
)

SMOKE = ARCH.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, head_dim=16,
    vocab_size=256, remat="none",
)
