"""Architecture configuration schema + registry (the port's copy of the
JAX package's ``configs/base.py``).

One module per assigned architecture lives next to this file; each defines
``ARCH`` (the exact published config) and ``SMOKE`` (a reduced same-family
config for CPU smoke tests).  ``repro_torch.configs.get(name)`` resolves
either.  The dtypes are torch's: compute in bf16, f32 master parameters.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

ARCH_IDS = [
    "llama-3.2-vision-11b",
    "dbrx-132b",
    "qwen2-moe-a2.7b",
    "h2o-danube-3-4b",
    "qwen1.5-0.5b",
    "qwen3-14b",
    "qwen2-1.5b",
    "rwkv6-1.6b",
    "zamba2-7b",
    "whisper-tiny",
]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | vlm | ssm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention features
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int | None = None
    rope_theta: float = 10_000.0
    flash_threshold: int = 4096 * 4096
    flash_block_q: int = 1024
    flash_block_k: int = 1024

    # MLP
    gated_mlp: bool = True
    act: str = "silu"
    norm: str = "rmsnorm"

    # MoE
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int | None = None
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # ssm / rwkv
    rwkv_head_size: int = 64
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1

    # hybrid layout (zamba2): groups of `hybrid_group` mamba blocks + one
    # shared attention application; `hybrid_tail` trailing mamba blocks
    hybrid_group: int = 5
    hybrid_tail: int = 0

    # vlm
    cross_attn_period: int = 5
    n_media_tokens: int = 1024

    # enc-dec (whisper)
    encoder_layers: int = 0
    n_frames: int = 1500
    max_dec_pos: int = 448
    is_encoder_decoder: bool = False

    # embedding / output
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 128

    # numerics / memory
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: str = "full"  # none | full | dots

    # notes for DESIGN/roofline tables
    source: str = ""

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# shapes assigned to the LM pool (seq_len, global_batch, kind)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# archs that can run the 500k decode cell (sub-quadratic decode state)
LONG_CONTEXT_OK = {"rwkv6-1.6b", "zamba2-7b", "h2o-danube-3-4b"}


def get(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")
    return mod.ARCH


def get_smoke(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")
    return mod.SMOKE


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells; honors the long_500k skip rule."""
    out = []
    for a in ARCH_IDS:
        for s in SHAPES.values():
            skip = s.name == "long_500k" and a not in LONG_CONTEXT_OK
            if skip and not include_skipped:
                continue
            out.append((a, s.name, "SKIP(full-attention)" if skip else "RUN"))
    return out
