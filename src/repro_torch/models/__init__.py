"""repro_torch.models — the LM zoo's dense, MoE, vision, ssm (RWKV-6),
hybrid (zamba2: Mamba-2 and a shared attention block) and audio (whisper:
encoder and decoder with cross-attention) families, serving and training
(the port's copy of the JAX package's ``models/``)."""

from .model import (build_model, compute_copy, count_params, init_compute_params, init_params, make_prefill,
                    make_serve_step, make_train_step, model_flops_per_token, xent_loss)

__all__ = ["build_model", "compute_copy", "count_params", "init_compute_params", "init_params", "make_prefill",
           "make_serve_step", "make_train_step", "model_flops_per_token", "xent_loss"]
