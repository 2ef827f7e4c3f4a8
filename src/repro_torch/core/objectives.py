"""On-device gradient evaluation (paper §2.5); counterpart of
`repro.core.objectives` for the three objectives of this slice:

  * reg:squarederror   g = yhat - y            h = 1
  * binary:logistic    g = sigmoid(m) - y      h = p(1-p)        (eqs 1-2)
  * multi:softmax      g_k = p_k - [y=k]       h_k = p_k(1-p_k)

`grad(margins, y)` returns (n, n_outputs, 2) stacked (g, h). Each objective
names its default eval metric (`core/metrics.py`, where the direction
lives); `config_kwargs(cfg)` gives the config's keywords for metric
functions.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Objective(NamedTuple):
    name: str
    n_outputs: Callable[[int], int]  # n_classes -> margin dims
    init_base_score: Callable[[torch.Tensor], float]  # y -> base score
    grad: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # -> (n, k, 2)
    transform: Callable[[torch.Tensor], torch.Tensor]  # margins -> predictions
    default_metric: str  # metrics.py registry name (direction lives there)


def config_kwargs(cfg) -> dict:
    """Config-derived keywords forwarded to metric functions (alongside
    dataset keywords like `group_ids`)."""
    return {"quantile_alpha": cfg.quantile_alpha}


def _sq_grad(margins, y):
    g = margins[:, 0] - y
    return torch.stack([g, torch.ones_like(g)], dim=-1)[:, None, :]


def _logistic_grad(margins, y):
    p = torch.sigmoid(margins[:, 0])
    return torch.stack([p - y, p * (1.0 - p)], dim=-1)[:, None, :]


def _softmax_grad(margins, y):
    p = torch.softmax(margins, dim=1)
    onehot = torch.nn.functional.one_hot(y.to(torch.int64), margins.shape[1])
    return torch.stack([p - onehot.to(p.dtype), p * (1.0 - p)], dim=-1)


OBJECTIVES: dict[str, Objective] = {
    "reg:squarederror": Objective(
        "reg:squarederror", lambda k: 1, lambda y: float(y.mean()),
        _sq_grad, lambda m: m[:, 0], "rmse",
    ),
    "binary:logistic": Objective(
        "binary:logistic", lambda k: 1, lambda y: 0.0,
        _logistic_grad, lambda m: torch.sigmoid(m[:, 0]), "accuracy",
    ),
    "multi:softmax": Objective(
        "multi:softmax", lambda k: k, lambda y: 0.0,
        _softmax_grad, lambda m: torch.argmax(m, dim=1), "accuracy",
    ),
}

# Objectives of the reference that this port does not have yet.
NOT_PORTED = ("reg:quantile", "reg:pseudohubererror", "count:poisson",
              "rank:pairwise")


def get_objective(name: str) -> Objective:
    obj = OBJECTIVES.get(name)
    if obj is not None:
        return obj
    if name in NOT_PORTED:
        raise NotImplementedError(f"objective {name!r} is not ported yet")
    raise ValueError(f"unknown objective {name!r}; ported: {sorted(OBJECTIVES)}")
