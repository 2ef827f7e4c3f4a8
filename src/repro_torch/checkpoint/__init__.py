"""Checkpoints in the reference's format (`repro.checkpoint`): framed
msgpack of pytrees, GBDT ensembles and self-describing Booster checkpoints,
through this package's own msgpack codec."""
from repro_torch.checkpoint.io import (
    CheckpointError,
    load_booster,
    load_booster_with_resume,
    load_ensemble,
    load_pytree,
    save_booster,
    save_ensemble,
    save_pytree,
)

__all__ = [
    "CheckpointError",
    "save_pytree",
    "load_pytree",
    "save_ensemble",
    "load_ensemble",
    "save_booster",
    "load_booster",
    "load_booster_with_resume",
]
