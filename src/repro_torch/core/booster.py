"""Gradient boosting — the Figure 1 pipeline; counterpart of `repro.core.booster`.

    dtrain = DeviceDMatrix(x, label=y)                  # cuda by default
    bst = Booster(n_rounds=10, objective="binary:logistic").fit(dtrain)
    p = bst.predict(x_new)                              # raw rows, NaN = missing

Training is a Python loop over rounds (the reference compiles the whole run
into one `lax.scan`). Each round: gradients -> one tree per output grown
from the packed matrix -> incremental margin update in bin space. The
Booster runs on its training matrix's device; `predict` moves raw rows
there and runs the ensemble-traversal kernel on the card.

Trees grow as the reference's do: depthwise or lossguide (`growth`,
`max_leaves`); with the default `use_kernel_histograms=False` by the
subtraction trick (the privatised histogram kernel at the root, the row-id
kernel below it); with `use_kernel_histograms=True` every level in full
through the privatised kernel.

Not ported yet: evals, metrics and early stopping, `update`, checkpoints,
sampling (`subsample`, `colsample_*`, `sampling_method`), monotone
constraints, the numeric sentinel (`numeric_check`), the uncompressed
matrix (`compress_matrix=False`), multi-device fits. Their knobs keep the
reference's names and defaults; a non-default value raises
NotImplementedError naming the knob.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.core import objectives as O
from repro_torch.core import predict as PR
from repro_torch.core import quantile as Q
from repro_torch.core import split as S
from repro_torch.core import tree as T
from repro_torch.core.dmatrix import DeviceDMatrix, cuts_equal
from repro_torch.device import as_tensor
from repro_torch.kernels import ops as KO
from repro_torch.serve import traversal as ST


@dataclass(frozen=True)
class BoosterConfig:
    """Field names and defaults of `repro.core.booster.BoosterConfig`.

    `use_kernel_histograms=False` grows with the subtraction trick, `True`
    builds every level in full through the privatised histogram kernel, as
    the reference's kernel path does. `hist_block_rows` has no effect: the
    kernels need no dense tile.
    """

    n_rounds: int = 100
    learning_rate: float = 0.3
    max_depth: int = 6
    max_bins: int = Q.DEFAULT_MAX_BINS
    reg_lambda: float = 1.0
    gamma: float = 0.0
    min_child_weight: float = 1.0
    objective: str = "reg:squarederror"
    n_classes: int = 1
    quantile_alpha: float = 0.5
    growth: str = "depthwise"
    max_leaves: int = 0
    use_kernel_histograms: bool = False
    compress_matrix: bool = True
    hist_block_rows: int = 65536
    subsample: float = 1.0
    colsample_bytree: float = 1.0
    colsample_bylevel: float = 1.0
    colsample_bynode: float = 1.0
    monotone_constraints: tuple | None = None
    sampling_method: str = "uniform"
    top_rate: float = 0.2
    other_rate: float = 0.1
    seed: int = 0
    numeric_check: str = "off"

    def __post_init__(self):
        # Knobs of the reference whose non-default values this port lacks.
        unported = {
            "subsample": 1.0, "colsample_bytree": 1.0, "colsample_bylevel": 1.0,
            "colsample_bynode": 1.0, "monotone_constraints": None,
            "sampling_method": "uniform", "numeric_check": "off",
            "compress_matrix": True,
        }
        for knob, default in unported.items():
            if getattr(self, knob) != default:
                raise NotImplementedError(
                    f"{knob}={getattr(self, knob)!r} is not ported yet "
                    f"(only {knob}={default!r})"
                )

    @property
    def split_params(self) -> S.SplitParams:
        return S.SplitParams(self.reg_lambda, self.gamma, self.min_child_weight)


class Booster:
    """Gradient-boosted model (XGBoost's `Booster` noun).

    After `fit`: `ensemble` (stacked tree arenas, learning rate baked into
    the leaves), `cuts`, `base_score`, `margins` (training margins),
    `n_rounds_trained`, `device`.
    """

    def __init__(self, cfg: BoosterConfig | None = None, **params):
        if cfg is None:
            cfg = BoosterConfig(**params)
        elif params:
            cfg = dataclasses.replace(cfg, **params)
        self.cfg = cfg
        self.ensemble: PR.Ensemble | None = None
        self.cuts: torch.Tensor | None = None
        self.base_score: float = 0.0
        self.n_rounds_trained: int = 0
        self.device: torch.device | None = None
        self.margins: torch.Tensor | None = None

    @property
    def obj(self) -> O.Objective:
        return O.get_objective(self.cfg.objective)

    def fit(self, dtrain: DeviceDMatrix) -> "Booster":
        """Train cfg.n_rounds rounds from scratch on dtrain's device."""
        cfg, obj = self.cfg, self.obj
        if dtrain.label is None:
            raise ValueError("dtrain must be constructed with label= to fit")
        if dtrain.max_bins != cfg.max_bins:
            raise ValueError(
                f"DeviceDMatrix was quantised with max_bins={dtrain.max_bins} "
                f"but this booster expects max_bins={cfg.max_bins}"
            )
        if cfg.n_rounds <= 0:
            raise ValueError(f"n_rounds must be positive, got {cfg.n_rounds}")
        self.device = dtrain.device
        self.cuts = dtrain.cuts
        y = dtrain.label
        self.base_score = float(obj.init_base_score(y))
        k = obj.n_outputs(cfg.n_classes)
        data = dtrain.packed_bins()
        margins = torch.full((dtrain.n_rows, k), self.base_score,
                             dtype=torch.float32, device=self.device)
        hist_builder = (KO.build_histograms_kernel_packed if cfg.use_kernel_histograms
                        else None)
        trees: list[T.Tree] = []
        for _ in range(cfg.n_rounds):
            gh_all = obj.grad(margins, y)  # (n, k, 2), round-start gradients
            round_trees = [
                T.grow_tree(data, gh_all[:, c, :].contiguous(), dtrain.cuts,
                            cfg.max_depth, cfg.max_bins, cfg.split_params,
                            growth=cfg.growth,
                            max_leaves=cfg.max_leaves or 2**cfg.max_depth,
                            hist_builder=hist_builder)
                for c in range(k)
            ]
            deltas = torch.stack([
                PR.traverse_tree_packed(
                    tr.feature, tr.split_bin, tr.default_left, tr.leaf_value,
                    tr.is_leaf, data.packed, data.bits, data.n_rows,
                    cfg.max_bins - 1, cfg.max_depth)
                for tr in round_trees
            ], dim=1)
            margins = margins + cfg.learning_rate * deltas
            trees.extend(round_trees)
        self.ensemble = PR.stack_trees(trees, k, self.base_score,
                                       leaf_scale=cfg.learning_rate)
        self.margins = margins
        self.n_rounds_trained = cfg.n_rounds
        return self

    def predict_margins(self, data) -> torch.Tensor:
        """Margins (n_rows, n_outputs) of raw rows (numpy or torch, NaN =
        missing; moved to the booster's device) or of a DeviceDMatrix built
        with ref= the training matrix (bin-space traversal)."""
        if self.ensemble is None:
            raise RuntimeError("Booster is not fitted yet — call fit() first")
        if isinstance(data, DeviceDMatrix):
            if data.device != self.device:
                raise ValueError(f"DeviceDMatrix lives on {data.device}, the "
                                 f"booster on {self.device}")
            if not cuts_equal(self.cuts, data.cuts):
                raise ValueError(
                    "DeviceDMatrix was quantised with different cuts than this "
                    "booster; build it with ref= the training matrix"
                )
            return PR.predict_binned_packed(
                self.ensemble, data.matrix.packed, data.bits, data.n_rows,
                self.cfg.max_bins - 1, self.cfg.max_depth)
        x = as_tensor(data, self.device)
        if x.ndim != 2 or x.shape[1] != self.cuts.shape[0]:
            raise ValueError(f"x must be (n_rows, {self.cuts.shape[0]}), got "
                             f"{tuple(x.shape)}")
        return ST.predict_margins_fused(self.ensemble, x, self.cfg.max_depth)

    def predict(self, data, output_margin: bool = False) -> torch.Tensor:
        """Transformed predictions (values / probabilities / class ids)."""
        m = self.predict_margins(data)
        return m if output_margin else self.obj.transform(m)
