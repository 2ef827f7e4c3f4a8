"""On-device gradient evaluation (paper §2.5) behind an open registry;
counterpart of `repro.core.objectives`:

  * reg:squarederror      g = yhat - y            h = 1
  * binary:logistic       g = sigmoid(m) - y      h = p(1-p)        (eqs 1-2)
  * multi:softmax         g_k = p_k - [y=k]       h_k = p_k(1-p_k)
  * rank:pairwise         LambdaRank-style pairwise logistic in query groups
  * reg:quantile          pinball loss at `quantile_alpha` (unit hessian)
  * reg:pseudohubererror  smooth L1, slope 1
  * count:poisson         log-link Poisson regression

`grad(margins, y, **extra)` returns (n, n_outputs, 2) stacked (g, h) as
plain torch on the margins' device (rank:pairwise's through the pairwise
kernel on the card); the trees grow from it through the same kernels
whatever the objective. An `Objective` names its default eval
metric (`core/metrics.py`, where the direction lives); `config_kwargs(cfg)`
gives the config's keywords for gradient, base-score and metric functions.

Registry surface:

  * `OBJECTIVES` — name -> Objective for the built-ins
  * `register_objective(name, grad, ...)` — user plugins; registered
    objectives checkpoint by name (`checkpoint/io.py`)
  * `get_objective(name)` / `as_objective(spec)` — resolution, including
    bare `(margins, y) -> (g, h)` callables for `Booster.fit(obj=...)`,
    wrapped once and cached by identity
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.metrics import adapt_extra
from repro_torch.kernels import ops as KO


class Objective(NamedTuple):
    name: str
    n_outputs: Callable[[int], int]  # n_classes -> margin dims
    init_base_score: Callable  # (y, **extra) -> float
    grad: Callable  # (margins, y, **extra) -> gh (n, outputs, 2)
    transform: Callable  # margins -> predictions
    default_metric: str  # metrics.py registry name (direction lives there)


OBJECTIVES: dict[str, Objective] = {}


def register_objective(
    name: str,
    grad: Callable,
    *,
    n_outputs: Callable[[int], int] | int = 1,
    init_base_score: Callable | float = 0.0,
    transform: Callable | None = None,
    default_metric: str = "rmse",
    overwrite: bool = False,
) -> Objective:
    """Register a custom training objective under `name`.

    `grad(margins, y, **extra) -> (n, n_outputs, 2)` stacked (g, h), or a
    simpler `(margins, y) -> (g, h)` pair of (n,) / (n, k) tensors.
    Registered objectives round-trip through `Booster.save`/`load` by name.
    Returns the Objective.
    """
    if name in OBJECTIVES and not overwrite:
        raise ValueError(
            f"objective {name!r} is already registered "
            "(pass overwrite=True to replace it)"
        )
    if isinstance(n_outputs, int):
        k_fixed = n_outputs
        n_outputs = lambda k, _k=k_fixed: _k  # noqa: E731
    if callable(init_base_score):
        init_base_score = adapt_extra(init_base_score)
    else:
        base_val = float(init_base_score)
        init_base_score = lambda y, **_: base_val  # noqa: E731
    obj = Objective(
        name=name,
        n_outputs=n_outputs,
        init_base_score=init_base_score,
        grad=_adapt_grad(grad),
        transform=transform if transform is not None else (lambda m: m[:, 0]),
        default_metric=default_metric,
    )
    OBJECTIVES[name] = obj
    return obj


def get_objective(name: str) -> Objective:
    obj = OBJECTIVES.get(name)
    if obj is not None:
        return obj
    raise ValueError(
        f"unknown objective {name!r}; built-ins: {sorted(OBJECTIVES)}. "
        "Custom losses: register_objective(name, grad) or pass a "
        "callable via Booster.fit(obj=...)"
    )


# Bare callables wrapped once and cached by function identity: the SAME
# callable across fits resolves to the identical Objective.
_WRAPPED_OBJECTIVES: dict = {}


def as_objective(spec, n_classes: int = 1) -> Objective:
    """Resolve Booster.fit's `obj=` argument: a registry name, an Objective
    (e.g. the return of register_objective), or a bare callable
    `(margins, y) -> (g, h)`."""
    if isinstance(spec, Objective):
        return spec
    if isinstance(spec, str):
        return get_objective(spec)
    if callable(spec):
        obj = _WRAPPED_OBJECTIVES.get(spec)
        if obj is None:
            obj = Objective(
                name=f"custom:{getattr(spec, '__name__', 'objective')}",
                n_outputs=lambda k: k,
                init_base_score=lambda y, **_: 0.0,
                grad=_adapt_grad(spec),
                transform=lambda m: m[:, 0] if m.shape[1] == 1 else m,
                default_metric="rmse",
            )
            _WRAPPED_OBJECTIVES[spec] = obj
        return obj
    raise TypeError(f"cannot interpret {type(spec)} as an objective")


def _adapt_grad(fn: Callable) -> Callable:
    """Normalise a gradient callable to `(margins, y, **extra) -> (n, k, 2)`.

    User callables may return a `(g, h)` pair of (n,) or (n, k) tensors
    (XGBoost's custom-objective convention) and may take only the keywords
    they care about; the stacked layout passes through untouched.
    """
    filtered = adapt_extra(fn)

    def grad(margins, y, **extra):
        out = filtered(margins, y, **extra)
        if isinstance(out, tuple):
            g, h = (torch.as_tensor(v, device=margins.device) for v in out)
            if g.ndim == 1:
                g = g[:, None]
            if h.ndim == 1:
                h = h[:, None]
            return torch.stack([g, h], dim=-1)
        return out

    return grad


def config_kwargs(cfg) -> dict:
    """Config-derived keywords forwarded to grad / base-score / metric
    functions (alongside dataset keywords like `group_ids`)."""
    return {"quantile_alpha": cfg.quantile_alpha}


# --- built-ins: regression -------------------------------------------------

def _sq_grad(margins, y, **_):
    g = margins[:, 0] - y
    return torch.stack([g, torch.ones_like(g)], dim=-1)[:, None, :]


squared_error = register_objective(
    "reg:squarederror", _sq_grad,
    init_base_score=lambda y, **_: float(y.mean()), default_metric="rmse",
)


def _quantile_grad(margins, y, quantile_alpha=0.5, **_):
    """Pinball loss d/dm: -alpha where the target sits above the prediction,
    (1 - alpha) below; unit hessian, so leaves are plain gradient means
    (XGBoost's reg:quantileerror)."""
    err = margins[:, 0] - y
    g = torch.where(err >= 0.0, 1.0 - quantile_alpha, -quantile_alpha).to(margins.dtype)
    return torch.stack([g, torch.ones_like(g)], dim=-1)[:, None, :]


def _quantile_base_score(y, quantile_alpha=0.5, **_):
    """The label's `quantile_alpha` quantile, interpolated linearly in
    float32 as `jnp.quantile` does (no size limit, unlike `torch.quantile`)."""
    s = torch.sort(y.to(torch.float32)).values
    n = s.shape[0]
    q = torch.tensor(quantile_alpha, dtype=torch.float32) * torch.tensor(
        n - 1, dtype=torch.float32)
    lo, hi = torch.floor(q), torch.ceil(q)
    high_weight = q - lo
    low_weight = 1.0 - high_weight
    lo_v = s[min(max(int(lo), 0), n - 1)].cpu()
    hi_v = s[min(max(int(hi), 0), n - 1)].cpu()
    return float(lo_v * low_weight + hi_v * high_weight)


quantile = register_objective(
    "reg:quantile", _quantile_grad,
    init_base_score=_quantile_base_score, default_metric="quantile",
)


def _pseudohuber_grad(margins, y, **_):
    """Pseudo-Huber with unit slope: sqrt(1 + r^2) - 1, quadratic near 0,
    linear in the tails."""
    r = margins[:, 0] - y
    scale = torch.sqrt(1.0 + r * r)
    g = r / scale
    h = 1.0 / (scale * scale * scale)
    return torch.stack([g, h], dim=-1)[:, None, :]


pseudohuber = register_objective(
    "reg:pseudohubererror", _pseudohuber_grad,
    init_base_score=lambda y, **_: float(y.mean()), default_metric="mphe",
)

# exp(0.7) as the reference's float32 constant: the hessian's inflation
# (XGBoost's max_delta_step guard for sparse counts).
_POISSON_H_SCALE = float(torch.exp(torch.tensor(0.7, dtype=torch.float32)))


def _poisson_grad(margins, y, **_):
    """Poisson regression with log link: nll = exp(m) - y*m, so g = exp(m)-y
    and h = exp(m) * exp(0.7). Margins are clamped to ±30 before the
    exponential, as in the reference, so one runaway leaf cannot overflow
    every later round's gradients."""
    mu = torch.exp(torch.clamp(margins[:, 0], -30.0, 30.0))
    g = mu - y
    h = mu * _POISSON_H_SCALE
    return torch.stack([g, h], dim=-1)[:, None, :]


poisson = register_objective(
    "count:poisson", _poisson_grad,
    init_base_score=lambda y, **_: float(torch.log(torch.clamp(
        y.to(torch.float32).mean(), min=1e-8))),
    transform=lambda m: torch.exp(m[:, 0]), default_metric="poisson-nloglik",
)


# --- built-ins: classification ---------------------------------------------

def _logistic_grad(margins, y, **_):
    p = torch.sigmoid(margins[:, 0])
    return torch.stack([p - y, p * (1.0 - p)], dim=-1)[:, None, :]


logistic = register_objective(
    "binary:logistic", _logistic_grad,
    transform=lambda m: torch.sigmoid(m[:, 0]), default_metric="accuracy",
)


def _softmax_grad(margins, y, **_):
    p = torch.softmax(margins, dim=1)
    onehot = torch.nn.functional.one_hot(y.to(torch.int64), margins.shape[1])
    return torch.stack([p - onehot.to(p.dtype), p * (1.0 - p)], dim=-1)


softmax = register_objective(
    "multi:softmax", _softmax_grad, n_outputs=lambda k: k,
    transform=lambda m: torch.argmax(m, dim=1), default_metric="accuracy",
)


# --- built-ins: ranking ----------------------------------------------------

def _pairwise_grad(margins, y, group_ids=None, **_):
    """LambdaRank pairwise logistic gradients within query groups: for every
    in-group pair with y_i > y_j, rho = sigmoid(s_j - s_i) adds -rho to g_i
    and +rho to g_j, and rho(1-rho) to both hessians; h is floored at 1e-6
    (rows in no comparable pair have none). The reference evaluates a dense
    n x n pair mask; here `ops.query_groups` sorts the rows by group and the
    pairwise kernel (its plain version on the CPU) visits each group's pairs
    only. `group_ids=None` is one query over all rows."""
    s = margins[:, 0].contiguous()
    if group_ids is None:
        group_ids = torch.zeros(s.shape[0], dtype=torch.int32, device=s.device)
    gh = KO.pairwise_grad(s, y, *KO.query_groups(group_ids))
    return gh[:, None, :]


pairwise_rank = register_objective(
    "rank:pairwise", _pairwise_grad, default_metric="ndcg@10",
)
