"""h2o-danube-3-4b [dense] — llama+mistral mix, sliding-window attention.
[arXiv:2401.16818; unverified]"""
from .base import ArchConfig

ARCH = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=10_000.0,
    source="arXiv:2401.16818; unverified",
)

SMOKE = ARCH.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, sliding_window=16, remat="none",
)
