"""Evaluation metric registry; counterpart of `repro.core.metrics`.

Every metric is a device function `(margins, y, **extra) -> 0-d tensor`
over raw margins, so a fit evaluates it each round without reading it on
the host:

  * margins: (n_rows, n_outputs) raw scores (pre-transform)
  * y:       (n_rows,) labels
  * extra:   dataset/config keywords (`group_ids` for ranking metrics,
             `quantile_alpha` for pinball loss); metrics ignore what they
             don't use.

Each metric carries its own `maximize` direction: early stopping reads it
from the METRIC, never from the objective.

Registry surface:

  * `METRICS` — name -> Metric for the built-ins
  * `register_metric(name, fn, maximize=...)` — user plugins
  * `get_metric(spec)` — resolves str | Metric | callable | (name, fn)
    | (name, fn, maximize); parameterised families like `ndcg@k` are
    constructed on demand and cached, so repeated lookups return the
    identical object.
"""
from __future__ import annotations

import inspect
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as KO


class Metric(NamedTuple):
    name: str
    fn: Callable  # (margins, y, **extra) -> scalar
    maximize: bool = False  # early-stopping / best_iteration direction


METRICS: dict[str, Metric] = {}


def adapt_extra(fn: Callable) -> Callable:
    """Wrap `fn(margins, y, ...)` so surplus `extra` keywords (group_ids,
    quantile_alpha, ...) are filtered down to what the callable's signature
    accepts — inspected once, so plugins can take only the keywords they
    care about. Callables with `**kwargs` pass through untouched."""
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):  # builtins / C callables
        return fn
    if any(p.kind == p.VAR_KEYWORD for p in params):
        return fn
    named = {p.name for p in params
             if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}

    def wrapped(*args, **extra):
        return fn(*args, **{k: v for k, v in extra.items() if k in named})

    return wrapped


def register_metric(name: str, fn: Callable, *, maximize: bool = False,
                    overwrite: bool = False) -> Metric:
    """Register a custom eval metric under `name`.

    `fn(margins, y, **extra) -> scalar` runs on the margins' device once a
    round. `maximize` tells early stopping which direction is better.
    Returns the registered Metric.
    """
    if name in METRICS and not overwrite:
        raise ValueError(
            f"metric {name!r} is already registered "
            "(pass overwrite=True to replace it)"
        )
    m = Metric(name=name, fn=adapt_extra(fn), maximize=maximize)
    METRICS[name] = m
    return m


# User-constructed Metric instances, adapted once (extra-kwarg filtering)
# and memoised by value so repeat fits resolve to the identical object.
_ADAPTED: dict = {}


def get_metric(spec) -> Metric:
    """Resolve a metric spec to a Metric.

    Accepts a registry name (including parameterised `ndcg@k`), a Metric,
    a bare callable (wrapped, minimizing, named after the function), or a
    (name, fn) / (name, fn, maximize) tuple.
    """
    if isinstance(spec, Metric):
        cached = _ADAPTED.get(spec)
        if cached is None:
            fn = adapt_extra(spec.fn)
            cached = spec if fn is spec.fn else spec._replace(fn=fn)
            _ADAPTED[spec] = cached
        return cached
    if isinstance(spec, str):
        m = METRICS.get(spec)
        if m is not None:
            return m
        if "@" in spec:
            base, _, arg = spec.partition("@")
            factory = _PARAMETRIC.get(base)
            if factory is not None:
                m = factory(int(arg))
                METRICS[spec] = m  # cache: same name -> identical object
                return m
        raise ValueError(
            f"unknown eval metric {spec!r}; built-ins: "
            f"{sorted(METRICS)} (+ parameterised {sorted(_PARAMETRIC)}@k); "
            "custom metrics: register_metric(name, fn) or pass a callable"
        )
    if isinstance(spec, (tuple, list)):
        if len(spec) == 2:
            name, fn = spec
            maximize = False
        elif len(spec) == 3:
            name, fn, maximize = spec
        else:
            raise ValueError(
                "metric tuple must be (name, fn) or (name, fn, maximize), "
                f"got length {len(spec)}"
            )
        return _wrap_callable(fn, name=name, maximize=maximize)
    if callable(spec):
        return _wrap_callable(spec)
    raise TypeError(f"cannot interpret {type(spec)} as an eval metric")


def resolve_metrics(spec) -> tuple[Metric, ...]:
    """Resolve `fit(eval_metric=...)`-style input to a Metric tuple:
    None -> (), a single spec (name / Metric / callable / bare
    (name, fn[, maximize]) tuple) -> 1-tuple, a sequence of specs ->
    one Metric each."""
    if spec is None:
        return ()
    if isinstance(spec, (str, Metric)) or callable(spec):
        return (get_metric(spec),)
    if isinstance(spec, (tuple, list)) and len(spec) in (2, 3) \
            and isinstance(spec[0], str) and callable(spec[1]):
        return (get_metric(tuple(spec)),)  # one bare (name, fn[, maximize])
    return tuple(get_metric(s) for s in spec)


# Wrapped callables cached by (fn, name, maximize) identity so a repeated
# fit with the same custom metric resolves to the identical Metric object.
_WRAPPED: dict = {}


def _wrap_callable(fn: Callable, name: str | None = None,
                   maximize: bool = False) -> Metric:
    name = name or getattr(fn, "__name__", "custom_metric")
    key = (fn, name, maximize)
    m = _WRAPPED.get(key)
    if m is None:
        def wrapped(margins, y, **extra):
            return fn(margins, y)

        m = _WRAPPED[key] = Metric(name=name, fn=wrapped, maximize=maximize)
    return m


# --- regression ------------------------------------------------------------

def _rmse(margins, y, **_):
    return torch.sqrt(torch.mean((margins[:, 0] - y) ** 2))


def _mae(margins, y, **_):
    return torch.mean(torch.abs(margins[:, 0] - y))


def _quantile_loss(margins, y, quantile_alpha=0.5, **_):
    """Mean pinball loss at `quantile_alpha` (reg:quantile's default)."""
    err = y - margins[:, 0]
    return torch.mean(torch.maximum(quantile_alpha * err, (quantile_alpha - 1.0) * err))


def _mphe(margins, y, **_):
    """Mean pseudo-Huber error (slope 1), reg:pseudohubererror's default."""
    r = margins[:, 0] - y
    return torch.mean(torch.sqrt(1.0 + r * r) - 1.0)


def _poisson_nloglik(margins, y, **_):
    """Negative Poisson log-likelihood with log link (pred = exp(margin))."""
    return torch.mean(torch.exp(margins[:, 0]) - y * margins[:, 0] + torch.lgamma(y + 1.0))


# --- binary classification -------------------------------------------------

def _logloss(margins, y, **_):
    # softplus(m) - y*m == -[y log p + (1-y) log(1-p)], numerically stable.
    return torch.mean(F.softplus(margins[:, 0]) - y * margins[:, 0])


def _accuracy(margins, y, **_):
    """Classification accuracy; binary on sign(margin), multiclass on
    argmax."""
    if margins.shape[1] == 1:
        hit = (margins[:, 0] > 0.0) == (y > 0.5)
    else:
        hit = torch.argmax(margins, dim=1) == y.to(torch.int64)
    return hit.to(torch.float32).mean()


def _error(margins, y, **_):
    return 1.0 - _accuracy(margins, y)


def _auc(margins, y, **_):
    """ROC AUC via the rank-sum (Mann-Whitney U) identity, with average
    ranks for ties — a sort and two `searchsorted`, all on the device (no
    host read)."""
    s = margins[:, 0].contiguous()
    pos = y > 0.5
    sorted_s = torch.sort(s).values
    lo = torch.searchsorted(sorted_s, s, side="left").to(torch.float32)
    hi = torch.searchsorted(sorted_s, s, side="right").to(torch.float32)
    rank = 0.5 * (lo + hi + 1.0)  # average 1-based rank under ties
    n_pos = pos.to(torch.float32).sum()
    n_neg = s.shape[0] - n_pos
    rank_sum = torch.where(pos, rank, 0.0).sum()
    u = rank_sum - n_pos * (n_pos + 1.0) / 2.0
    return u / torch.clamp(n_pos * n_neg, min=1.0)


# --- multiclass ------------------------------------------------------------

def _merror(margins, y, **_):
    return (torch.argmax(margins, dim=1) != y.to(torch.int64)).to(torch.float32).mean()


def _mlogloss(margins, y, **_):
    lse = torch.logsumexp(margins, dim=1)
    tgt = torch.gather(margins, 1, y.to(torch.int64)[:, None])[:, 0]
    return torch.mean(lse - tgt)


# --- ranking ---------------------------------------------------------------

def _pairwise_acc(margins, y, **_):
    """Global pairwise ordering accuracy — the coarse proxy predating the
    real ndcg@k metric; kept for continuity of recorded histories."""
    s = margins[:, 0]
    better = y[:, None] > y[None, :]
    correct = (s[:, None] > s[None, :]) & better
    denom = torch.clamp(better.sum(), min=1)
    return correct.sum().to(torch.float32) / denom.to(torch.float32)


def _make_ndcg(k: int) -> Metric:
    """NDCG@k averaged over query groups, on the device, by sorts: no pair
    mask, no host read.

    The reference's rank of row i in its group counts the rows j with a
    larger key, or an equal key and j < i: exactly i's position after a
    stable descending sort of the keys, then a stable sort by group
    (`ops.query_groups`), less its group's start. Gains are XGBoost's
    2^rel - 1; a group's DCG and ideal DCG are segment sums (float64 prefix
    sums over the group-sorted rows), and the result is the mean over groups
    of DCG / IDCG, with 1 for a group whose IDCG is 0 (XGBoost's
    convention). Missing `group_ids` treats the whole set as one query.
    """
    if k <= 0:
        raise ValueError(f"ndcg@k needs k >= 1, got {k}")

    def ndcg(margins, y, group_ids=None, **_):
        s = margins[:, 0]
        n = s.shape[0]
        if group_ids is None:
            group_ids = torch.zeros(n, dtype=torch.int32, device=s.device)
        pos = torch.arange(n, device=s.device)
        gain = torch.exp2(y) - 1.0

        def dcg_terms(keys):
            """Each group-sorted position's gain times its discount, and the
            group spans (alike for any keys: the same ids, sorted)."""
            # + 0.0 makes -0.0 a +0.0, which the reference's == ties with it.
            by_key = torch.sort(keys + 0.0, descending=True, stable=True).indices
            order, start, end = KO.query_groups(group_ids[by_key])
            rank = pos - start
            disc = torch.where(rank < k, 1.0 / torch.log2(rank.to(torch.float32) + 2.0), 0.0)
            return (gain[by_key[order.to(torch.int64)]] * disc).to(torch.float64), start, end

        def group_sums(terms, start, end):  # each position's group total
            cs = torch.cat([terms.new_zeros(1), torch.cumsum(terms, dim=0)])
            return cs[end.to(torch.int64)] - cs[start.to(torch.int64)]

        dcg, start, end = dcg_terms(s)
        idcg, _, _ = dcg_terms(y)
        dcg_g, idcg_g = group_sums(dcg, start, end), group_sums(idcg, start, end)
        per_group = torch.where(idcg_g > 0.0, dcg_g / torch.where(idcg_g > 0.0, idcg_g, 1.0),
                                1.0)
        first = start == pos  # one position a group
        return (torch.where(first, per_group, 0.0).sum() / first.sum()).to(torch.float32)

    return Metric(name=f"ndcg@{k}", fn=ndcg, maximize=True)


_PARAMETRIC: dict[str, Callable[[int], Metric]] = {"ndcg": _make_ndcg}


for _name, _fn, _maximize in (
    ("rmse", _rmse, False),
    ("mae", _mae, False),
    ("quantile", _quantile_loss, False),
    ("mphe", _mphe, False),
    ("poisson-nloglik", _poisson_nloglik, False),
    ("logloss", _logloss, False),
    ("error", _error, False),
    ("accuracy", _accuracy, True),
    ("auc", _auc, True),
    ("merror", _merror, False),
    ("mlogloss", _mlogloss, False),
    ("pairwise_acc", _pairwise_acc, True),
):
    register_metric(_name, _fn, maximize=_maximize)
