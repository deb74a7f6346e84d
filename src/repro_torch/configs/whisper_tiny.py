"""whisper-tiny [audio] — enc-dec, conv frontend STUB (precomputed frame
embeddings).  max_dec_pos raised to cover the assigned 32k shapes
(shape-faithful; semantic ctx limit noted in DESIGN.md).
[arXiv:2212.04356; unverified]"""
from .base import ArchConfig

ARCH = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,           # decoder layers
    encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    gated_mlp=False,
    act="gelu",
    norm="layernorm",
    n_frames=1500,
    max_dec_pos=32768,
    tie_embeddings=True,
    is_encoder_decoder=True,
    source="arXiv:2212.04356; unverified",
)

SMOKE = ARCH.replace(
    n_layers=2, encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, n_frames=16, max_dec_pos=64, remat="none",
)
