"""Where the port runs: the card, unless the caller asks for the CPU."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None, *, meta: bool = False) -> torch.device:
    """`None` means `"cuda"`. A CUDA device without a card raises: nothing
    carries on on the CPU unless the caller passed `device="cpu"`. With
    `meta=True` the meta device is accepted too, for shape work only (the
    LM's dry run builds its parameters, optimizer state and caches there)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    allowed = ("cuda", "cpu", "meta") if meta else ("cuda", "cpu")
    if dev.type not in allowed:
        raise ValueError(f"device must be one of {allowed}, got {dev}")
    return dev


def as_tensor(v, device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A numpy array, list or tensor as a tensor of `dtype` on `device`."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    a = np.asarray(v)
    if not a.flags.writeable:  # torch wraps numpy memory and wants it writable
        a = a.copy()
    return torch.as_tensor(a, device=device).to(dtype)
