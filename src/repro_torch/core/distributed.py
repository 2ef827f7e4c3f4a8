"""Shim: the multi-device training round lives in `repro_torch.dist`, as
`repro.core.distributed` re-exports `repro.dist`; new code imports
`repro_torch.dist`."""
from repro_torch.dist.runner import (  # noqa: F401
    RoundInputs,
    make_chunk_runner,
    make_distributed_round,
    train_distributed,
)

__all__ = [
    "RoundInputs",
    "make_chunk_runner",
    "make_distributed_round",
    "train_distributed",
]
