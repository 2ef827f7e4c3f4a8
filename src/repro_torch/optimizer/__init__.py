"""Optimizers of the LM substrate, functional over trees of tensors;
counterpart of `repro.optimizer`."""
from repro_torch.optimizer.adamw import AdamWConfig, AdamWState, adamw_init, adamw_update
from repro_torch.optimizer.sgd import SGDState, sgd_init, sgd_update
from repro_torch.optimizer.util import clip_by_global_norm, cosine_schedule, global_norm

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "SGDState",
    "sgd_init",
    "sgd_update",
    "clip_by_global_norm",
    "cosine_schedule",
    "global_norm",
]
