"""repro_torch.train — the optimizer of the LM stack's training path (the
port's copy of the JAX package's ``train/``)."""

from .optim import AdamWConfig, adamw_init, adamw_update, compress_int8, global_norm, lr_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "compress_int8", "global_norm", "lr_schedule"]
