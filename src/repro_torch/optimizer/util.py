"""Shared optimizer utilities; counterpart of `repro.optimizer.util`."""
from __future__ import annotations

import math

import torch

from repro_torch.pytree import leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in float32, the leaves
    added in the reference's order."""
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    # a true division (torch's `float / tensor` multiplies by a reciprocal)
    scale = torch.clamp(torch.tensor(float(max_norm), dtype=torch.float32, device=norm.device)
                        / (norm + 1e-6), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def cosine_schedule(step, base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    """Linear warmup to base_lr, then cosine decay to min_frac * base_lr at
    `total`; a float32 0-d tensor, on step's device when step is a tensor."""
    step = (step.float() if isinstance(step, torch.Tensor)
            else torch.tensor(float(step), dtype=torch.float32))
    f32 = lambda v: torch.tensor(float(v), dtype=torch.float32, device=step.device)
    warm = base_lr * step / f32(max(warmup, 1))
    prog = torch.clamp((step - warmup) / f32(max(total - warmup, 1)), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)
