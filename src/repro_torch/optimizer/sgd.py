"""SGD with momentum (the baseline optimizer for ablations); counterpart of
`repro.optimizer.sgd`."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.pytree import leaves, tree_map


class SGDState(NamedTuple):
    step: torch.Tensor  # int32, 0-d
    momentum: object


def sgd_init(params) -> SGDState:
    dev = leaves(params)[0].device
    return SGDState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    momentum=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                                      params))


@torch.no_grad()
def sgd_update(params, grads, state: SGDState, lr: float, beta: float = 0.9):
    new_m = tree_map(lambda m, g: beta * m + g.float(), state.momentum, grads)
    new_p = tree_map(lambda p, m: (p.float() - lr * m).to(p.dtype), params, new_m)
    return new_p, SGDState(step=state.step + 1, momentum=new_m)
