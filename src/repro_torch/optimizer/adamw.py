"""AdamW with decoupled weight decay; counterpart of `repro.optimizer.adamw`.

Functional, in the reference's arithmetic order: clip by the global norm
first, bias corrections from a float32 step, the decay inside the bracket,
p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p). (`torch.optim.AdamW`
multiplies the decay in apart, which rounds otherwise, and keeps no
`(step, m, v)` state in the reference's checkpoint layout.) The state
mirrors the parameter tree.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.pytree import leaves, tree_map, unflatten_like


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32, 0-d
    m: object  # tree like params
    v: object


def adamw_init(params) -> AdamWState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, cfg: AdamWConfig, lr=None):
    from repro_torch.optimizer.util import clip_by_global_norm

    if cfg.grad_clip > 0:
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = cfg.lr if lr is None else lr
    stepf = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=step.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=step.device), stepf)

    def upd(p, g, m, v):
        g = g.float()
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat, vhat = m / b1c, v / b2c
        pf = p.float()
        new_p = pf - lr * (mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * pf)
        return new_p.to(p.dtype), m, v

    out = [upd(p, g, m, v) for p, g, m, v in
           zip(leaves(params), leaves(grads), leaves(state.m), leaves(state.v))]
    new_p = unflatten_like(params, [o[0] for o in out])
    new_m = unflatten_like(params, [o[1] for o in out])
    new_v = unflatten_like(params, [o[2] for o in out])
    return new_p, AdamWState(step=step, m=new_m, v=new_v)
