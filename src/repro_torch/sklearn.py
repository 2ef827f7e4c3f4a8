"""scikit-learn estimators over the port; counterpart of `repro.sklearn`.

`XGBRegressor` / `XGBClassifier` / `XGBRanker` wrap `DeviceDMatrix` +
`Booster` behind sklearn's estimator contract (`get_params` / `set_params`
/ `fit(X, y, eval_set=...)` / `predict` / `predict_proba` / `score`), so
`GridSearchCV`, `cross_val_score` and `Pipeline` drive them.

scikit-learn is optional: when importable, the estimators subclass
`sklearn.base.BaseEstimator` and its mixins; without it (as on the card's
machine), a minimal local base supplies `get_params`/`set_params`/`score`
with the same semantics. `HAVE_SKLEARN` says which.

    from repro_torch.sklearn import XGBClassifier

    clf = XGBClassifier(n_estimators=50, max_depth=4)     # on the card
    clf.fit(xt, yt, eval_set=[(xv, yv)])
    p = clf.predict_proba(xv)

The constructor surface is the reference's, every argument stored verbatim,
plus one keyword the reference lacks: `device=None` (the card) or "cpu",
the device the estimator's matrices and booster live on. `chunk_rows=`
trains through `ExternalDMatrix.from_arrays` (external memory), and
`numeric_check`, `on_oom` and `checkpoint_*` reach the booster as in the
reference. Knobs the port does not have yet raise NotImplementedError
naming them: `mesh`, `collective` and `compression` (through
`Booster.fit`).
"""
from __future__ import annotations

import numpy as np
import torch

try:  # sklearn is optional: estimators degrade to a local base without it
    from sklearn.base import (  # type: ignore
        BaseEstimator,
        ClassifierMixin,
        RegressorMixin,
    )

    HAVE_SKLEARN = True
except ImportError:
    HAVE_SKLEARN = False

    class BaseEstimator:  # minimal stand-in with sklearn's param contract
        @classmethod
        def _get_param_names(cls):
            import inspect

            sig = inspect.signature(cls.__init__)
            return sorted(
                p.name for p in sig.parameters.values()
                if p.name != "self" and p.kind == p.POSITIONAL_OR_KEYWORD
            )

        def get_params(self, deep: bool = True) -> dict:
            return {k: getattr(self, k) for k in self._get_param_names()}

        def set_params(self, **params):
            valid = set(self._get_param_names())
            for k, v in params.items():
                if k not in valid:
                    raise ValueError(
                        f"invalid parameter {k!r} for {type(self).__name__}"
                    )
                setattr(self, k, v)
            return self

    class RegressorMixin:
        def score(self, X, y, sample_weight=None):
            pred = np.asarray(self.predict(X), np.float64)
            y = np.asarray(y, np.float64)
            ss_res = float(np.sum((y - pred) ** 2))
            ss_tot = float(np.sum((y - np.mean(y)) ** 2))
            return 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0

    class ClassifierMixin:
        def score(self, X, y, sample_weight=None):
            return float(np.mean(np.asarray(self.predict(X)) == np.asarray(y)))


from repro_torch.core import Booster, BoosterConfig, DeviceDMatrix, ExternalDMatrix


class _BoosterEstimator(BaseEstimator):
    """Shared constructor + fit plumbing. sklearn introspects this
    `__init__` (inherited by all three estimators), so every argument is
    stored verbatim on self; task-specific behaviour lives in class
    attributes and `_fit_objective`."""

    _default_objective = "reg:squarederror"

    def __init__(
        self,
        n_estimators: int = 100,
        learning_rate: float = 0.3,
        max_depth: int = 6,
        max_bins: int = 256,
        reg_lambda: float = 1.0,
        gamma: float = 0.0,
        min_child_weight: float = 1.0,
        growth: str = "depthwise",
        max_leaves: int = 0,
        objective: str | None = None,
        eval_metric=None,
        early_stopping_rounds: int | None = None,
        quantile_alpha: float = 0.5,
        verbose: int = 0,
        chunk_rows: int | None = None,
        subsample: float = 1.0,
        sampling_method: str = "uniform",
        top_rate: float = 0.2,
        other_rate: float = 0.1,
        colsample_bytree: float = 1.0,
        colsample_bylevel: float = 1.0,
        colsample_bynode: float = 1.0,
        monotone_constraints=None,
        random_state: int = 0,
        numeric_check: str = "off",
        on_oom: str = "raise",
        checkpoint_every: int | None = None,
        checkpoint_path: str | None = None,
        serve: bool = False,
        mesh=None,
        collective: str = "psum",
        compression: str | None = None,
        device=None,
    ):
        self.n_estimators = n_estimators
        self.learning_rate = learning_rate
        self.max_depth = max_depth
        self.max_bins = max_bins
        self.reg_lambda = reg_lambda
        self.gamma = gamma
        self.min_child_weight = min_child_weight
        self.growth = growth
        self.max_leaves = max_leaves
        self.objective = objective
        self.eval_metric = eval_metric
        self.early_stopping_rounds = early_stopping_rounds
        self.quantile_alpha = quantile_alpha
        self.verbose = verbose
        # chunk_rows=None trains in memory; an int routes the training set
        # through ExternalDMatrix.from_arrays (external memory, its "auto"
        # paging: streamed when the stack tops half the card's memory).
        self.chunk_rows = chunk_rows
        self.subsample = subsample
        self.sampling_method = sampling_method
        self.top_rate = top_rate
        self.other_rate = other_rate
        self.colsample_bytree = colsample_bytree
        self.colsample_bylevel = colsample_bylevel
        self.colsample_bynode = colsample_bynode
        self.monotone_constraints = monotone_constraints
        self.random_state = random_state
        self.numeric_check = numeric_check
        self.on_oom = on_oom
        self.checkpoint_every = checkpoint_every
        self.checkpoint_path = checkpoint_path
        # serve=True predicts through repro_torch.serve.PredictEngine (one
        # CUDA graph a bucket on the card). Predictions are identical either way.
        self.serve = serve
        self.mesh = mesh
        self.collective = collective
        self.compression = compression
        # The port's own keyword: None (the card) or "cpu".
        self.device = device

    # --- fit plumbing ------------------------------------------------------
    def _fit_objective(self, y: np.ndarray) -> tuple[str, int, np.ndarray]:
        """(objective name, n_classes, encoded labels) for this task."""
        obj = self.objective or self._default_objective
        return obj, 1, np.asarray(y, np.float32)

    def _config(self, objective: str, n_classes: int) -> BoosterConfig:
        return BoosterConfig(
            n_rounds=self.n_estimators,
            learning_rate=self.learning_rate,
            max_depth=self.max_depth,
            max_bins=self.max_bins,
            reg_lambda=self.reg_lambda,
            gamma=self.gamma,
            min_child_weight=self.min_child_weight,
            growth=self.growth,
            max_leaves=self.max_leaves,
            objective=objective,
            n_classes=n_classes,
            quantile_alpha=self.quantile_alpha,
            subsample=self.subsample,
            sampling_method=self.sampling_method,
            top_rate=self.top_rate,
            other_rate=self.other_rate,
            colsample_bytree=self.colsample_bytree,
            colsample_bylevel=self.colsample_bylevel,
            colsample_bynode=self.colsample_bynode,
            monotone_constraints=(
                None if self.monotone_constraints is None
                else tuple(int(c) for c in self.monotone_constraints)
            ),
            seed=self.random_state,
            numeric_check=self.numeric_check,
        )

    def _fit(self, X, y, eval_set=None, group_ids=None, eval_group_ids=None):
        X = np.asarray(X, np.float32)
        objective, n_classes, y_enc = self._fit_objective(y)
        if self.chunk_rows is not None:
            dtrain = ExternalDMatrix.from_arrays(
                X, y_enc, group_ids=group_ids, chunk_rows=self.chunk_rows,
                max_bins=self.max_bins, device=self.device)
        else:
            dtrain = DeviceDMatrix(X, label=y_enc, group_ids=group_ids,
                                   max_bins=self.max_bins, device=self.device)
        evals = []
        for i, (xv, yv) in enumerate(eval_set or ()):
            gv = None if eval_group_ids is None else eval_group_ids[i]
            evals.append((
                DeviceDMatrix(np.asarray(xv, np.float32),
                              label=self._encode_labels(yv),
                              group_ids=gv, ref=dtrain),
                f"validation_{i}",
            ))
        self.booster_ = Booster(self._config(objective, n_classes)).fit(
            dtrain,
            evals=evals,
            eval_metric=self.eval_metric,
            early_stopping_rounds=self.early_stopping_rounds,
            verbose_every=self.verbose,
            on_oom=self.on_oom,
            checkpoint_every=self.checkpoint_every,
            checkpoint_path=self.checkpoint_path,
            mesh=self.mesh,
            collective=self.collective,
            compression=self.compression,
        )
        self.n_features_in_ = X.shape[1]
        self.evals_result_ = list(self.booster_.history)
        self._engines_ = {}  # serve=True engine cache; stale after refit
        return self

    def _encode_labels(self, y) -> np.ndarray:
        return np.asarray(y, np.float32)

    def _check_fitted(self):
        if not hasattr(self, "booster_"):
            raise RuntimeError(
                f"{type(self).__name__} is not fitted yet — call fit() first"
            )

    # --- serving (serve=True) ----------------------------------------------
    def _serve_engine(self, output_margin: bool):
        """Lazily built PredictEngine per output mode (margins for the
        classifier's decision path, transformed values otherwise)."""
        key = "margin" if output_margin else "value"
        engines = getattr(self, "_engines_", None)
        if engines is None:
            engines = self._engines_ = {}
        if key not in engines:
            from repro_torch.serve import PredictEngine

            engines[key] = PredictEngine(self.booster_, output_margin=output_margin)
        return engines[key]

    def _predict_values(self, X) -> np.ndarray:
        """Transformed predictions, through the serving engine when
        serve=True, else the booster directly."""
        self._check_fitted()
        if self.serve:
            return self._serve_engine(output_margin=False).predict(X)
        return self.booster_.predict(np.asarray(X, np.float32)).cpu().numpy()

    def _margins(self, X) -> torch.Tensor:
        """Margins on the booster's device, from the engine when serve=True
        (bit for bit the booster's), so that a transform of them is the
        same computation either way."""
        self._check_fitted()
        if self.serve:
            m = self._serve_engine(output_margin=True).predict(X)
            return torch.as_tensor(m, device=self.booster_.device)
        return self.booster_.predict_margins(np.asarray(X, np.float32))

    # --- common fitted surface ---------------------------------------------
    @property
    def best_iteration_(self) -> int | None:
        self._check_fitted()
        return self.booster_.best_iteration

    @property
    def best_score_(self) -> float | None:
        self._check_fitted()
        return self.booster_.best_score

    def get_booster(self) -> Booster:
        self._check_fitted()
        return self.booster_

    @property
    def comm_stats_(self) -> dict | None:
        """Communication accounting of the latest fit: None, the
        reference's value for a single-device fit (the only kind here)."""
        self._check_fitted()
        return self.booster_.comm_stats

    @property
    def feature_importances_(self) -> np.ndarray:
        """Gain-based importances normalised to sum 1 (XGBoost's sklearn
        default importance_type="gain"); zeros when the model never split."""
        self._check_fitted()
        imp = self.booster_.feature_importances("gain")
        total = imp.sum()
        return imp / total if total > 0 else imp


class XGBRegressor(RegressorMixin, _BoosterEstimator):
    """sklearn-style regressor.

    `objective=None` means squared error; any registered regression
    objective name works (`reg:quantile` + `quantile_alpha=0.9`,
    `reg:pseudohubererror`, `count:poisson`, a `register_objective` name).
    """

    _default_objective = "reg:squarederror"

    def fit(self, X, y, *, eval_set=None):
        return self._fit(X, y, eval_set=eval_set)

    def predict(self, X) -> np.ndarray:
        return self._predict_values(X)


class XGBClassifier(ClassifierMixin, _BoosterEstimator):
    """sklearn-style classifier: binary logistic for two classes, softmax
    above; `classes_` round-trips arbitrary label values."""

    _default_objective = None  # chosen from the label cardinality

    def _fit_objective(self, y):
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        k = len(self.classes_)
        if k < 2:
            raise ValueError("XGBClassifier needs at least 2 classes")
        objective = self.objective or (
            "binary:logistic" if k == 2 else "multi:softmax"
        )
        return objective, (1 if k == 2 else k), self._encode_labels(y)

    def _encode_labels(self, y) -> np.ndarray:
        y = np.asarray(y)
        idx = np.clip(np.searchsorted(self.classes_, y), 0, len(self.classes_) - 1)
        bad = self.classes_[idx] != y
        if np.any(bad):
            raise ValueError(
                "labels contain classes unseen in the training targets: "
                f"{sorted(set(np.unique(y[bad]).tolist()))}"
            )
        return idx.astype(np.float32)

    def fit(self, X, y, *, eval_set=None):
        return self._fit(X, y, eval_set=eval_set)

    def predict(self, X) -> np.ndarray:
        margins = self._margins(X).cpu().numpy()
        if margins.shape[1] == 1:
            idx = (margins[:, 0] > 0.0).astype(int)
        else:
            idx = np.argmax(margins, axis=1)
        return self.classes_[idx]

    def predict_proba(self, X) -> np.ndarray:
        """(n, n_classes) probabilities, computed on the booster's device:
        column 1 of a binary model is bit for bit `Booster.predict`."""
        margins = self._margins(X)
        if margins.shape[1] == 1:
            p = torch.sigmoid(margins[:, 0])
            return torch.stack([1.0 - p, p], dim=1).cpu().numpy()
        return torch.softmax(margins, dim=1).cpu().numpy()


class XGBRanker(_BoosterEstimator):
    """sklearn-style LambdaRank-pairwise ranker.

    Query structure comes in XGBoost's two equivalent forms: `qid` (one
    query id per row) or `group` (consecutive query sizes). `predict`
    returns raw ranking scores; no `score` method is defined (evaluate with
    `eval_metric=["ndcg@k"]`).
    """

    _default_objective = "rank:pairwise"

    @staticmethod
    def _qid(n_rows: int, qid, group) -> np.ndarray:
        if (qid is None) == (group is None):
            raise ValueError("pass exactly one of qid= or group=")
        if qid is not None:
            q = np.asarray(qid, np.int32)
        else:
            q = np.repeat(np.arange(len(group), dtype=np.int32),
                          np.asarray(group, np.int64))
        if q.shape[0] != n_rows:
            raise ValueError(
                f"query structure covers {q.shape[0]} rows, X has {n_rows}"
            )
        return q

    def fit(self, X, y, *, qid=None, group=None, eval_set=None, eval_qid=None):
        X = np.asarray(X, np.float32)
        gids = self._qid(X.shape[0], qid, group)
        eval_gids = None
        if eval_set:
            if eval_qid is None:
                raise ValueError("eval_set for ranking requires eval_qid")
            eval_gids = [np.asarray(q, np.int32) for q in eval_qid]
        return self._fit(X, y, eval_set=eval_set, group_ids=gids,
                         eval_group_ids=eval_gids)

    def predict(self, X) -> np.ndarray:
        return self._predict_values(X)


__all__ = [
    "HAVE_SKLEARN",
    "XGBClassifier",
    "XGBRanker",
    "XGBRegressor",
]
