"""llama-3.2-vision-11b [vlm] — cross-attn image layers.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from .base import ArchConfig

ARCH = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    cross_attn_period=5,  # 8 cross-attn layers of 40
    n_media_tokens=1601,  # one image tile of patch embeddings (stub input)
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)

SMOKE = ARCH.replace(
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, n_media_tokens=8, cross_attn_period=5, remat="none",
)
