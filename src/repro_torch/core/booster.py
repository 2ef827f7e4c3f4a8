"""Gradient boosting — the Figure 1 pipeline; counterpart of `repro.core.booster`.

    dtrain = DeviceDMatrix(x, label=y)                  # cuda by default
    dvalid = DeviceDMatrix(x_valid, label=y_valid, ref=dtrain)
    bst = Booster(n_rounds=100, objective="binary:logistic")
    bst.fit(dtrain, evals=[(dvalid, "valid")], eval_metric=["logloss", "auc"],
            early_stopping_rounds=10)
    p = bst.predict(x_new)                              # raw rows, NaN = missing
    bst.update(dtrain, 20)                              # 20 more rounds

Training is a Python loop over rounds (the reference compiles the whole run
into one `lax.scan`). Each round: gradients -> one tree per output grown
from the training matrix -> incremental margin update in bin space. The
Booster runs on its training matrix's device; `predict` moves raw rows
there and runs the ensemble-traversal kernel on the card.

Trees grow as the reference's do: depthwise or lossguide (`growth`,
`max_leaves`); with the default `use_kernel_histograms=False` by the
subtraction trick (the privatised histogram kernel at the root, the row-id
kernel below it); with `use_kernel_histograms=True` every level in full
through the privatised kernel. With `compress_matrix=False` the rounds
grow from the dense bins that `dtrain.matrix.unpack()` gives once a fit
(one decompress launch on the card): plain-torch scatters build the
default growth's histograms, and the kernel path packs the bins at
`bits_needed(max_bins - 1)` for the privatised kernel every level, as the
reference does.

Evaluation sets (DeviceDMatrix built with `ref=dtrain`) keep their margins
next to the training margins, updated each round from the round's trees in
the training matrix's representation. Every requested metric of the
training set and of every eval set is a 0-d tensor a round, left on the
device. The rounds run in the reference's chunks, one ending at each
multiple of `early_stopping_rounds` and one at the end of the run, and a
chunk's metrics are read on the host once, stacked: never once a round.
Early stopping reads the LAST metric of the LAST eval set, in the
direction that metric declares, and truncates the model to
`best_iteration + 1` rounds.

Ranking: a DeviceDMatrix built with `group_ids=` hands its query groups
to the objective, the base score and every metric (`_dataset_extra`), the
training set's and each eval set's its own; `rank:pairwise` and `ndcg@k`
group by them, so a metric sees a set's queries, never one query.

The objective is pluggable: `fit(obj=)` takes a registry name, an
`objectives.register_objective` result or a bare `(margins, y) -> (g, h)`
callable; only the gradient is plain torch, the trees grow through the same
kernels. `save(path)` / `Booster.load(path)` write and read the reference's
self-describing checkpoint (`checkpoint/io.py`), so a model crosses between
the two packages.

Stochastic and constrained training (DESIGN.md §12, §17): `subsample`,
`colsample_bytree`/`bylevel`/`bynode`, GOSS (`sampling_method="goss"`,
`top_rate`, `other_rate`) and `monotone_constraints`, with the reference's
validation. Each class tree of round r draws from the path (seed, r,
class), r counted from the booster's first round, so early-stopping chunks
and `update` stay on the draws of one long fit. The default growth grows a
subsampled tree over the compacted buffer of its rows; the kernel path
(`use_kernel_histograms=True`) zeroes the unselected rows' (g, h) instead,
as the reference does. With every knob at its default the fit is the
program without sampling, whatever the seed.

External memory: `fit`, `update`, `resume`, `eval`, `predict` and the
eval sets take an `ExternalDMatrix`. With resident paging its chunk stack
is paged onto the device once and grows every tree there (both histogram
kernels read the whole stack in one launch a level). With streamed paging
(`paging="stream"`, or an "auto" stack above half the card's memory) the
rounds grow from `stream.StreamedChunkedBins`: the stack stays on the host
and is paged a chunk at a time, the kernels launched once a chunk, so at
most prefetch_chunks + 1 chunks are on the device; the training margins
enter and every prediction leaves a chunk at a time. Every other knob
(evals, early stopping, `update`, `checkpoint_every`, `numeric_check`,
sampling, monotone constraints) works on either. `fit(on_oom="external")`
retries a fit that ran out of device memory through an ExternalDMatrix,
halving `chunk_rows` each time, with a warning and a `resilience_events`
entry; a plain fit raises the OOM (see `fit` for what it relieves).

Fault tolerance (DESIGN.md §13): `numeric_check` ("raise", "warn_skip",
"clamp") computes a finite flag a round from the raw gradients, the
leaves and the new margins, left on the device and read with the chunk's
metrics, once a chunk. NaN gradients grow a root-only tree on the card as
on the CPU: the split scan ranks NaN gains first (as torch.argmax does),
so the chosen feature and bin stay in range, and `grow_tree` splits only
on finite positive gains, so no row is routed on them. `checkpoint_every`
/ `checkpoint_path` write the reference's resumable snapshot at chunk
boundaries (chunks also end at each multiple of `checkpoint_every`,
counted from the fit's first round), and `Booster.resume(path, dtrain)`
continues a killed fit with the snapshot's margins as carried. The
resumed booster is bit for bit the uninterrupted fit, on the CPU and on
the card (the card's histograms add 64-bit fixed-point integers, the same
bits in any order; `kernels/fixed.py`), as `update` is. Faults are provoked through
`repro_torch.testing.faults`.

Multi-device fits (DESIGN.md §15): `fit(dtrain, mesh=dist.make_mesh((S,),
("data",)), collective=, compression=, comm_tolerance=)`, and `update` and
`resume` with the same keywords, shard the rows over the mesh
(`dist.runner`): each round runs on every shard in a thread of its own,
histograms are combined by the collective every level, and the round's
trees and the global margins come back to the booster's device, where the
eval sets, the metrics and the chunk's one host read stay. The fit's
analytic wire accounting is `comm_stats`, with the measured
`fallback_events`.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core import compress as C
from repro_torch.core import metrics as M
from repro_torch.core import objectives as O
from repro_torch.core import predict as PR
from repro_torch.core import quantile as Q
from repro_torch.core import resilience as RES
from repro_torch.core import sampling as SMP
from repro_torch.core import split as S
from repro_torch.core import stream as STRM
from repro_torch.core import tree as T
from repro_torch.core.dmatrix import DeviceDMatrix, ExternalDMatrix, cuts_equal
from repro_torch.device import as_tensor
from repro_torch.kernels import ops as KO
from repro_torch.serve import traversal as ST
from repro_torch.testing import faults as FA


@dataclass(frozen=True)
class BoosterConfig:
    """Field names and defaults of `repro.core.booster.BoosterConfig`.

    `use_kernel_histograms=False` grows with the subtraction trick, `True`
    builds every level in full through the privatised histogram kernel, as
    the reference's kernel path does. `compress_matrix=False` grows from the
    dense bins. `hist_block_rows` has no effect: the kernels need no dense
    tile. `numeric_check` takes the reference's policies: "off", "raise",
    "warn_skip" and "clamp".
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
        RES.validate_numeric_policy(self.numeric_check)
        mc = self.monotone_constraints
        if mc is not None:
            mc = tuple(int(c) for c in mc)  # lists (a loaded checkpoint's) coerce
            object.__setattr__(self, "monotone_constraints", mc)
            if any(c not in (-1, 0, 1) for c in mc):
                raise ValueError(
                    f"monotone_constraints must be -1/0/+1, got {mc}"
                )
        for knob in ("subsample", "colsample_bytree", "colsample_bylevel",
                     "colsample_bynode"):
            v = getattr(self, knob)
            if not 0.0 < v <= 1.0:
                raise ValueError(f"{knob} must be in (0, 1], got {v}")
        if self.sampling_method not in ("uniform", "goss"):
            raise ValueError(
                f"sampling_method must be 'uniform' or 'goss', "
                f"got {self.sampling_method!r}"
            )
        if self.sampling_method == "goss":
            for knob in ("top_rate", "other_rate"):
                v = getattr(self, knob)
                if not 0.0 < v < 1.0:
                    raise ValueError(
                        f"{knob} must be in (0, 1) with sampling_method="
                        f"'goss', got {v}"
                    )
            if self.top_rate + self.other_rate > 1.0:
                raise ValueError(
                    f"top_rate + other_rate must be <= 1.0, got "
                    f"{self.top_rate} + {self.other_rate}"
                )
            if self.subsample < 1.0:
                raise ValueError(
                    "sampling_method='goss' replaces uniform row "
                    "subsampling — leave subsample at 1.0"
                )

    @property
    def split_params(self) -> S.SplitParams:
        return S.SplitParams(self.reg_lambda, self.gamma, self.min_child_weight)


def _apply_trees(cfg: BoosterConfig, trees: list[T.Tree], data,
                 margins: torch.Tensor) -> torch.Tensor:
    """Add one round's trees (unscaled leaves, tree c feeding output c) to
    margins, by bin-space traversal of `data`: on a bins type all k trees
    in one `traverse` (one pass over a streamed stack a round)."""
    mb, depth = cfg.max_bins - 1, cfg.max_depth
    if not isinstance(data, torch.Tensor):  # any bins type
        leaves = PR.traverse_trees_on(
            data, *(torch.stack([getattr(tr, f) for tr in trees]) for f in (
                "feature", "split_bin", "default_left", "leaf_value", "is_leaf")),
            mb, depth).t()
    else:
        leaves = torch.stack([PR.traverse_tree_binned(
            tr.feature, tr.split_bin, tr.default_left, tr.leaf_value, tr.is_leaf,
            data, mb, depth) for tr in trees], dim=1)
    return margins + cfg.learning_rate * leaves


class Booster:
    """Gradient-boosted model (XGBoost's `Booster` noun).

    After `fit`: `ensemble` (stacked tree arenas, learning rate baked into
    the leaves), `cuts`, `base_score`, `margins` (training margins; None
    after an early-stopped fit truncated the model), `history` (per-round
    records keyed `train_{metric}` and `{set}_{metric}`),
    `best_iteration`/`best_score` (when early stopping ran),
    `n_rounds_trained`, `device`, `skipped_rounds` (rounds zeroed under
    numeric_check="warn_skip") and `resilience_events` (the degradations
    the fit absorbed: OOM fallback, failed checkpoint writes, clamps).
    `update(dtrain, n)` continues training; `save(path)` and
    `Booster.load(path)` persist the model; `Booster.resume(path, dtrain)`
    continues a killed fit from its in-run checkpoint.
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
        self.history: list[dict] = []
        self.best_iteration: int | None = None
        self.best_score: float | None = None
        self.n_rounds_trained: int = 0
        self.device: torch.device | None = None
        self.margins: torch.Tensor | None = None
        self._train_dmat: DeviceDMatrix | None = None  # the matrix `margins` are of
        self._obj: O.Objective | None = None  # fit(obj=...) override
        self._metrics: tuple[M.Metric, ...] | None = None
        self.comm_stats: dict | None = None  # the last sharded fit's accounting
        self.skipped_rounds: list[int] = []
        self.resilience_events: list[dict] = []

    @property
    def obj(self) -> O.Objective:
        if self._obj is not None and self._obj.name == self.cfg.objective:
            return self._obj
        return O.get_objective(self.cfg.objective)

    @property
    def n_features(self) -> int | None:
        """Features a row must have: the cuts' count, or `n_features_in_`
        for a model that carries no cuts (imported from XGBoost JSON); None
        when neither is known (an imported model reloaded from a
        checkpoint)."""
        if self.cuts is not None:
            return int(self.cuts.shape[0])
        nf = getattr(self, "n_features_in_", None)
        return None if nf is None else int(nf)

    def _check_rows(self, x: torch.Tensor) -> None:
        """Raw rows must be 2-D with the model's features. A model that
        knows neither count (an imported model reloaded from a checkpoint)
        is refused: the traversal kernel would read past narrower rows."""
        nf = self.n_features
        if nf is None:
            raise ValueError("this model carries neither cuts nor n_features_in_; set "
                             "booster.n_features_in_ to the rows' feature count")
        if x.ndim != 2 or x.shape[1] != nf:
            raise ValueError(f"x must be (n_rows, {nf}), got {tuple(x.shape)}")

    def num_boosted_rounds(self) -> int:
        return self.n_rounds_trained

    def _require_fitted(self):
        if self.ensemble is None:
            raise RuntimeError("Booster is not fitted yet — call fit() first")

    # --- training ----------------------------------------------------------
    def _resolve_metrics(self, eval_metric, custom_metric) -> tuple[M.Metric, ...]:
        """eval_metric: one spec or a sequence of specs (registry names,
        Metric objects, callables, (name, fn[, maximize]) tuples);
        custom_metric: a single extra spec appended LAST, so with early
        stopping it drives the stop. Defaults to the objective's metric."""
        metrics = M.resolve_metrics(eval_metric)
        if custom_metric is not None:
            metrics = metrics + (M.get_metric(custom_metric),)
        if not metrics:
            metrics = (M.get_metric(self.obj.default_metric),)
        return metrics

    def _dataset_extra(self, dmat: DeviceDMatrix) -> dict:
        """Keywords forwarded to gradient, base-score and metric functions
        for one dataset: the config's (`config_kwargs`) plus the dataset's
        query groups when it has them."""
        extra = dict(O.config_kwargs(self.cfg))
        if dmat.group_ids is not None:
            extra["group_ids"] = dmat.group_ids
        return extra

    def fit(
        self,
        dtrain: DeviceDMatrix | ExternalDMatrix,
        evals: Sequence = (),
        *,
        obj=None,
        eval_metric=None,
        custom_metric=None,
        early_stopping_rounds: int | None = None,
        verbose_every: int = 0,
        callback: Callable[[int, dict], None] | None = None,
        mesh=None,
        data_axes: Sequence[str] = ("data",),
        collective="psum",
        compression: str | None = None,
        comm_tolerance: float = 0.05,
        checkpoint_every: int | None = None,
        checkpoint_path: str | None = None,
        on_oom: str = "raise",
    ) -> "Booster":
        """Train cfg.n_rounds rounds from scratch on dtrain's device, from a
        DeviceDMatrix or an ExternalDMatrix (its chunk stack paged onto the
        device once, or with streamed paging a chunk at a time).

        evals: sequence of (matrix, name) pairs (or bare matrices, named
          eval0, eval1, ...) built with `ref=dtrain`; ExternalDMatrix eval
          sets work too. Their metrics are computed every round. With
          `early_stopping_rounds`, the LAST metric of the LAST eval set
          drives stopping (direction = that metric's `maximize`) and the
          model is truncated to best_iteration + 1 rounds.
        eval_metric: metric spec or list of specs (names like "logloss",
          "auc", "ndcg@10", Metric objects, callables); defaults to the
          objective's default metric.
        obj: override cfg.objective: a registry name, an Objective (e.g.
          from objectives.register_objective), or a bare callable
          `(margins, y) -> (g, h)`; cfg.objective takes its name.
        custom_metric: one extra metric spec, appended after eval_metric.
        verbose_every: record every this many rounds in `history` (the last
          round always); with 0, every round when evals or a callback are
          given, else none.
        callback: called as callback(round, record) for each recorded round,
          once the chunk holding it has been read.
        checkpoint_every: write an atomic resumable snapshot every this many
          rounds to `checkpoint_path`; `Booster.resume(path, dtrain)`
          continues a killed fit from it.
        checkpoint_path: snapshot file; with checkpoint_every unset, only a
          final complete checkpoint is written there.
        on_oom: "raise" (default) or "external" — on a device out-of-memory
          error the fit is retried through an ExternalDMatrix with halved
          chunk_rows (repeatedly, until it fits or chunks hit one row), as
          the reference does. The fallback matrix keeps the failed one's
          paging ("auto" for an in-memory matrix). Where that resolves to
          "stream" (a stack above half the card's memory, or a streamed
          matrix re-chunked), the retry holds only the pager's ring of
          prefetch_chunks + 1 chunks and O(n) row state on the device, so
          a real OOM of the stack is relieved, and each halving shrinks the
          ring. What does not shrink: the caller's in-memory matrix stays on
          the device (as in the reference), and a resident stack takes at
          least the flat words' memory, so a resident fallback relieves
          nothing but padding.
        mesh: a `dist.Mesh` (`dist.make_mesh`): rows are sharded over
          `data_axes` and each level's histograms combined across the shards
          (paper Algorithm 1); the same Booster comes out. The rows must
          divide evenly across the shards; `group_ids` and streamed paging
          are refused.
        collective: the histogram reduction with mesh=: a registry name
          ("psum", "ring", "hier"), a `dist.Collective` subclass or an
          instance.
        compression: None, "f16" or "q16": compressed histogram bin sums,
          checked on the device and reduced exactly where the error bound
          exceeds `comm_tolerance` (relative). The fit's accounting lands on
          `comm_stats`.
        """
        if on_oom not in ("raise", "external"):
            raise ValueError(f"on_oom must be 'raise' or 'external', got {on_oom!r}")

        def reset():
            self.ensemble = None
            self.history = []
            self.best_iteration = self.best_score = None
            self.n_rounds_trained = 0
            self.margins = self._train_dmat = None
            self.skipped_rounds = []

        reset()
        self.resilience_events = []
        if obj is not None:
            resolved = O.as_objective(obj)
            self._obj = resolved
            self.cfg = dataclasses.replace(self.cfg, objective=resolved.name)
        if dtrain.label is None:
            raise ValueError("dtrain must be constructed with label= to fit")
        self._metrics = self._resolve_metrics(eval_metric, custom_metric)
        self.device = dtrain.device
        self.cuts = dtrain.cuts
        self.base_score = float(self.obj.init_base_score(dtrain.label,
                                                         **self._dataset_extra(dtrain)))
        dmat = dtrain
        while True:
            try:
                self._run_rounds(dmat, self.cfg.n_rounds, evals, early_stopping_rounds,
                                 verbose_every, callback,
                                 checkpoint_every=checkpoint_every,
                                 checkpoint_path=checkpoint_path, mesh=mesh,
                                 data_axes=data_axes, collective=collective,
                                 compression=compression, comm_tolerance=comm_tolerance)
                return self
            except Exception as exc:
                if on_oom != "external" or not RES.is_oom(exc):
                    raise
                # Drop the failed fit's tensors (its frames) before the retry.
                exc.__traceback__ = None
                reset()
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()
                dmat = self._oom_fallback_matrix(dmat, exc)

    def _oom_fallback_matrix(self, dmat, exc):
        """Next, smaller-footprint training matrix after a device OOM: an
        in-memory matrix degrades to external memory at half its rows per
        chunk; an external matrix halves chunk_rows again. Re-raises the
        OOM when chunks can no longer shrink."""
        if isinstance(dmat, ExternalDMatrix):
            new_rows = dmat.chunk_rows // 2
            if new_rows < 1:
                raise exc
            dmat.unload()  # one stack on the device at a time
            nd = dmat.rechunk(new_rows)
        else:
            nd = ExternalDMatrix.from_dmatrix(dmat, chunk_rows=max(dmat.n_rows // 2, 1))
        warnings.warn(
            f"device OOM during fit ({str(exc).splitlines()[0][:120]}); "
            f"retrying via external-memory training with "
            f"chunk_rows={nd.chunk_rows} (on_oom='external')"
        )
        self.resilience_events.append({
            "event": "oom_fallback",
            "chunk_rows": int(nd.chunk_rows),
            "error": str(exc)[:200],
        })
        return nd

    def update(
        self,
        dtrain: DeviceDMatrix | ExternalDMatrix,
        n_rounds: int,
        evals: Sequence = (),
        *,
        eval_metric=None,
        custom_metric=None,
        early_stopping_rounds: int | None = None,
        verbose_every: int = 0,
        callback: Callable[[int, dict], None] | None = None,
        mesh=None,
        data_axes: Sequence[str] = ("data",),
        collective="psum",
        compression: str | None = None,
        comm_tolerance: float = 0.05,
        checkpoint_every: int | None = None,
        checkpoint_path: str | None = None,
    ) -> "Booster":
        """Continue training for n_rounds more rounds (warm start).

        If `dtrain` is the matrix the booster last trained on, the rounds
        continue from its cached margins; otherwise the margins are rebuilt
        by bin-space prediction. fit(a) + update(b) is bit for bit one fit
        of a + b rounds, on the CPU (the plain versions add in a fixed
        order) and on the card (the histograms add 64-bit fixed-point
        integers, whose sums do not depend on the atomics' order). The
        objective is fixed at fit time; metrics may be changed per update.
        `checkpoint_every` / `checkpoint_path` and the sharding keywords
        (`mesh`, `data_axes`, `collective`, `compression`, `comm_tolerance`)
        are fit's.
        """
        self._require_fitted()
        if dtrain.label is None:
            raise ValueError("dtrain must be constructed with label= to update")
        if not cuts_equal(self.cuts, dtrain.cuts):
            raise ValueError(
                "dtrain was quantised with different cuts than this booster; "
                "build it with ref= the original training matrix"
            )
        if eval_metric is not None or custom_metric is not None or self._metrics is None:
            self._metrics = self._resolve_metrics(eval_metric, custom_metric)
        self._run_rounds(dtrain, n_rounds, evals, early_stopping_rounds,
                         verbose_every, callback, checkpoint_every=checkpoint_every,
                         checkpoint_path=checkpoint_path, mesh=mesh, data_axes=data_axes,
                         collective=collective, compression=compression,
                         comm_tolerance=comm_tolerance)
        return self

    @classmethod
    def resume(
        cls,
        path: str,
        dtrain,
        evals: Sequence = (),
        *,
        callback: Callable[[int, dict], None] | None = None,
        verbose_every: int | None = None,
        checkpoint_every: int | None = None,
        checkpoint_path: str | None = None,
        mesh=None,
        data_axes: Sequence[str] = ("data",),
        collective="psum",
        compression: str | None = None,
        comm_tolerance: float = 0.05,
    ) -> "Booster":
        """Continue a killed fit from an in-run checkpoint (the reference's
        format: a file either package wrote), on dtrain's device.

        `dtrain` (and `evals`, same sets in the same order) must be rebuilt
        exactly as for the original fit: the checkpoint carries the model,
        the margins, the early-stopping state and the absolute round the
        draws fold, but not the data. The margins re-enter the round loop
        exactly as carried (never rebuilt by prediction), the stochastic
        draws fold absolute rounds, and early-stopping checks fire at the
        same fit-relative boundaries. The resumed booster is bit for bit
        the one an uninterrupted fit gives (trees, margins, predictions),
        on the CPU and on the card, as in `update`.

        Checkpointing continues with the original cadence to the same file
        by default (override with checkpoint_every/checkpoint_path); the
        file is rewritten as a completed checkpoint when the fit finishes.
        The sharding keywords are fit's: a snapshot of a sharded fit resumes
        on one device or on a mesh, and one device's on a mesh.
        """
        from repro_torch.checkpoint import io as CIO

        bst, rs = CIO.load_booster_with_resume(path, device=dtrain.device)
        if rs is None:
            raise CIO.CheckpointError(
                f"{path} checkpoints a COMPLETED fit (no resume section); "
                "use Booster.load() to load it, or update() to train further"
            )
        try:
            bst._metrics = tuple(M.get_metric(n) for n in rs["metric_names"]) or None
        except Exception as exc:
            raise ValueError(
                f"cannot resolve checkpointed eval metrics "
                f"{list(rs['metric_names'])}: {exc}. Re-register custom "
                "metrics (metrics.register_metric) before resuming."
            ) from exc
        if dtrain.label is None:
            raise ValueError("dtrain must be constructed with label= to resume")
        if not cuts_equal(bst.cuts, dtrain.cuts):
            raise ValueError(
                "dtrain was quantised with different cuts than the "
                "checkpointed fit; rebuild it from the same data with the "
                "same max_bins (or with ref= the original matrix)"
            )
        evals_n = bst._normalise_evals(evals, dtrain)
        names = [n for _, n in evals_n]
        want = [str(n) for n in rs["eval_names"]]
        if names != want:
            raise ValueError(
                f"resume requires the original fit's eval sets in order: "
                f"expected {want}, got {names}"
            )
        remaining = int(rs["target"]) - int(rs["rounds_done"])
        if remaining <= 0:
            return bst
        ve = int(rs.get("verbose_every", 0)) if verbose_every is None else verbose_every
        ck = ((int(rs.get("checkpoint_every", 0)) or None) if checkpoint_every is None
              else checkpoint_every)
        cpath = checkpoint_path if checkpoint_path is not None else path
        es = int(rs.get("early_stopping_rounds", 0)) or None
        bst._run_rounds(dtrain, remaining, evals_n, es, ve, callback,
                        checkpoint_every=ck, checkpoint_path=cpath, resume_state=rs,
                        mesh=mesh, data_axes=data_axes, collective=collective,
                        compression=compression, comm_tolerance=comm_tolerance)
        return bst

    def _initial_margins(self, dmat) -> torch.Tensor:
        """Margins to (re-)enter training with: base score if unfitted, else
        bin-space prediction of the current ensemble (a chunk at a time on a
        streamed matrix, which is never paged in whole)."""
        if self.ensemble is None:
            k = self.obj.n_outputs(self.cfg.n_classes)
            return torch.full((dmat.n_rows, k), self.base_score, dtype=torch.float32,
                              device=dmat.device)
        if isinstance(dmat, ExternalDMatrix) and dmat.resolved_paging() == "stream":
            return self._predict_margins_external(self.ensemble, dmat)
        return PR.predict_binned_on(self.ensemble, dmat.packed_bins(), self.cfg.max_bins - 1,
                                    self.cfg.max_depth)

    def _normalise_evals(self, evals, dtrain) -> list:
        out = []
        for i, e in enumerate(evals):
            d, name = e if isinstance(e, (tuple, list)) else (e, f"eval{i}")
            if not isinstance(d, (DeviceDMatrix, ExternalDMatrix)):
                raise TypeError(
                    "evals entries must be DeviceDMatrix / ExternalDMatrix "
                    f"(or (matrix, name)), got {type(d)}; build with ref=dtrain"
                )
            if d.label is None:
                raise ValueError(f"eval set '{name}' has no label")
            if not dtrain.same_cuts(d):
                raise ValueError(
                    f"eval set '{name}' was quantised with different cuts; "
                    "build it with DeviceDMatrix(x, label=y, ref=dtrain)"
                )
            out.append((d, name))
        return out

    def _bins(self, dmat):
        """The representation the rounds read: the packed words; the chunk
        stack of an ExternalDMatrix, paged onto the device once, or with
        streamed paging `StreamedChunkedBins` (also kept as the matrix's
        `stream_stats`); or with compress_matrix=False the dense bins (one
        decompress on the card)."""
        if isinstance(dmat, ExternalDMatrix):
            if dmat.resolved_paging() == "stream":
                dmat.stream_stats = STRM.StreamedChunkedBins(dmat)
                return dmat.stream_stats
            return dmat.packed_bins()
        return dmat.packed_bins() if self.cfg.compress_matrix else dmat.matrix.unpack()

    def _run_rounds(self, dtrain, n_rounds: int, evals, early_stopping_rounds,
                    verbose_every, callback, checkpoint_every=None,
                    checkpoint_path=None, resume_state=None, mesh=None,
                    data_axes=("data",), collective="psum", compression=None,
                    comm_tolerance=0.05) -> None:
        if n_rounds <= 0:
            raise ValueError(f"n_rounds must be positive, got {n_rounds}")
        cfg, obj = self.cfg, self.obj
        if early_stopping_rounds and not evals:
            raise ValueError(
                "early_stopping_rounds requires at least one eval set "
                "(pass evals=[(DeviceDMatrix(..., ref=dtrain), name)])"
            )
        if checkpoint_every is not None:
            if checkpoint_every <= 0:
                raise ValueError(
                    f"checkpoint_every must be positive, got {checkpoint_every}"
                )
            if checkpoint_path is None:
                raise ValueError(
                    "checkpoint_every requires checkpoint_path= (the file "
                    "snapshots are written to)"
                )
        if dtrain.max_bins != cfg.max_bins:
            raise ValueError(
                f"{type(dtrain).__name__} was quantised with max_bins={dtrain.max_bins} "
                f"but this booster expects max_bins={cfg.max_bins}"
            )
        if dtrain.device != self.device:
            raise ValueError(f"{type(dtrain).__name__} lives on {dtrain.device}, the "
                             f"booster on {self.device}")
        if cfg.monotone_constraints is not None \
                and len(cfg.monotone_constraints) != dtrain.n_features:
            raise ValueError(
                f"monotone_constraints has {len(cfg.monotone_constraints)} "
                f"entries but dtrain has {dtrain.n_features} features"
            )
        if mesh is None and cfg.use_kernel_histograms and isinstance(dtrain, ExternalDMatrix):
            raise NotImplementedError(
                "use_kernel_histograms is not supported with ExternalDMatrix "
                "(the kernel path's builders are not chunk-aware); train with "
                "the default builders"
            )
        if mesh is not None and dtrain.group_ids is not None:
            raise NotImplementedError("group_ids (rank:pairwise) is single-device only")
        evals = self._normalise_evals(evals, dtrain)
        record_every = verbose_every or (1 if (callback or evals) else 0)
        metrics = self._metrics if record_every > 0 else ()
        extra = self._dataset_extra(dtrain)
        eval_extras = [self._dataset_extra(d) for d, _ in evals]
        k = obj.n_outputs(cfg.n_classes)

        y = dtrain.label
        if mesh is not None:
            # Sharded: the runner holds each shard's rows on its device and
            # hands back a round's trees and the global margins here.
            from repro_torch import dist as D

            runner = D.make_chunk_runner(cfg, obj, dtrain, mesh, data_axes,
                                         collective=collective, compression=compression,
                                         comm_tolerance=comm_tolerance, device=self.device)
            self.comm_stats = runner.comm_stats.as_dict()
        else:
            data = self._bins(dtrain)
            self.comm_stats = None
        eval_data = [self._bins(d) for d, _ in evals]
        if resume_state is not None:
            # The snapshot's margins re-enter the loop exactly as carried:
            # rebuilding them by prediction is not bit for bit.
            margins = resume_state["margins"].to(self.device, torch.float32)
            eval_margins = [m.to(self.device, torch.float32)
                            for m in resume_state["eval_margins"]]
            done = int(resume_state["rounds_done"])
            rounds_before = int(resume_state["rounds_before"])
            es_history = [float(v) for v in resume_state["es_history"]]
        else:
            if self._train_dmat is dtrain and self.margins is not None:
                margins = self.margins  # exact continuation, same matrix
            else:
                margins = self._initial_margins(dtrain)
            eval_margins = [self._initial_margins(d) for d, _ in evals]
            done = 0
            rounds_before = self.n_rounds_trained  # the draws' absolute round offset
            es_history = []
        target = done + n_rounds
        hist_builder = None
        if cfg.use_kernel_histograms:
            hist_builder = (KO.build_histograms_kernel_packed if cfg.compress_matrix
                            else KO.build_histograms_kernel)
        stoch = SMP.stochastic_params(cfg)
        sentinel = cfg.numeric_check != "off"
        fault = None  # the chunk's armed nan_grad fault

        def step(r_abs: int, margins: torch.Tensor):
            """One round on one device: (trees, new margins, finite flag or
            None, None)."""
            gh_all = obj.grad(margins, y, **extra)  # (n, k, 2), round-start gradients
            if fault is not None and r_abs == int(fault.payload.get("round", 0)):
                gh_all = torch.full_like(gh_all, float(fault.payload.get("value", np.nan)))
            gh_raw = gh_all
            if cfg.numeric_check == "clamp":
                gh_all = RES.clamp_gradients(gh_all)
            trees = []
            for c in range(k):
                gh_c, ctx = gh_all[:, c, :].contiguous(), None
                if stoch is not None:
                    # Compact buffers with the default growth, masked (g, h)
                    # with a hist_builder, as the reference does.
                    ctx, gh_c = SMP.make_tree_context(
                        stoch, (cfg.seed, r_abs, c), gh_c,
                        dtrain.n_features, compact=hist_builder is None)
                trees.append(T.grow_tree(
                    data, gh_c, self.cuts, cfg.max_depth, cfg.max_bins,
                    cfg.split_params, growth=cfg.growth,
                    max_leaves=cfg.max_leaves or 2**cfg.max_depth,
                    hist_builder=hist_builder, ctx=ctx))
            new_margins = _apply_trees(cfg, trees, data, margins)
            ok = None
            if sentinel:
                ok = RES.finite_flags(gh_raw, *(t.leaf_value for t in trees), new_margins)
                if cfg.numeric_check == "warn_skip":
                    # Neutralise the round: zero leaves (the trees add
                    # nothing to any margin), -inf gains (importances
                    # ignore them), the round-start margins carried on.
                    trees = [t._replace(
                        leaf_value=torch.where(ok, t.leaf_value, 0.0),
                        gain=torch.where(ok, t.gain, float("-inf")))
                        for t in trees]
                    new_margins = torch.where(ok, new_margins, margins)
            return trees, new_margins, ok, None

        round_step = runner.step if mesh is not None else step
        fallback_events = 0

        FA.check("oom")
        # Chunks end at the next multiple of e (early stopping), of
        # checkpoint_every, and at the end of the run, all counted from the
        # fit's first round, so a resumed fit re-enters the same schedule.
        # A chunk's metrics and finite flags are read on the host once.
        es_on = bool(early_stopping_rounds) and bool(evals)
        e = int(early_stopping_rounds) if es_on else None
        ck = int(checkpoint_every) if checkpoint_every else None
        eval_names = [name for _, name in evals]
        run_trees: list[T.Tree] = []
        best_round: int | None = None
        stopped = False
        last_chunk = None  # (start, tr_host, ev_host) for the final record
        while done < target and not stopped:
            nxt = target
            if es_on:
                nxt = min(nxt, (done // e + 1) * e)
            if ck:
                nxt = min(nxt, (done // ck + 1) * ck)
            length = nxt - done
            fault = FA.active("nan_grad")
            chunk_metrics = []  # a round's metrics, stacked: train, then each set
            flags = []  # a round's finite flag (sentinel on)
            fallbacks = []  # a round's count of compressed allreduces that fell back
            for r in range(done, nxt):
                trees, margins, ok, fb = round_step(rounds_before + r, margins)
                if ok is not None:
                    flags.append(ok)
                if fb is not None:
                    fallbacks.append(fb)
                run_trees.extend(trees)
                values = [m.fn(margins, y, **extra) for m in metrics]
                for j, (d, _) in enumerate(evals):
                    eval_margins[j] = _apply_trees(cfg, trees, eval_data[j], eval_margins[j])
                    values += [m.fn(eval_margins[j], d.label, **eval_extras[j])
                               for m in metrics]
                if values:
                    chunk_metrics.append(torch.stack([
                        torch.as_tensor(v, dtype=torch.float32, device=self.device)
                        for v in values]))
            # The chunk's one host read: its metrics (length, 1 + n_evals,
            # n_metrics), its finite flags (length,) and its fallback counts
            # (length,), together.
            n_vals = length * (1 + len(evals)) * len(metrics)
            read = [torch.stack(chunk_metrics).reshape(-1)] if metrics else []
            if flags:
                read.append(torch.stack(flags).to(torch.float32))
            if fallbacks:
                read.append(torch.stack(fallbacks).to(torch.float32))
            host = torch.cat(read).cpu().numpy() if read else np.zeros(0, np.float32)
            n_flags = len(flags)
            fallback_events += int(host[n_vals + n_flags:].sum())
            self._handle_numeric_flags(host[n_vals:n_vals + n_flags] > 0.5 if flags else None,
                                       rounds_before + done)
            tr_host, ev_host = [], []
            if metrics:
                vals = host[:n_vals].reshape(length, 1 + len(evals), len(metrics))
                tr_host = vals[:, 0, :].T  # (n_metrics, length)
                ev_host = [vals[:, 1 + s, :].T for s in range(len(evals))]
                self._record_history(done, length, tr_host, ev_host, metrics, eval_names,
                                     rounds_before, record_every, callback)
                last_chunk = (done, tr_host, ev_host)
            self._check_divergence(ev_host, eval_names, metrics, rounds_before + done)
            if es_on:
                # The LAST metric of the LAST eval set drives stopping, in the
                # direction that METRIC declares; checks fire only at
                # multiples of e (and at the end), so checkpoint boundaries
                # never change the decision.
                es_history.extend(ev_host[-1][-1].tolist())
                if nxt % e == 0 or nxt == target:
                    arr = np.asarray(es_history)
                    best_round = int(np.argmax(arr) if metrics[-1].maximize
                                     else np.argmin(arr))
                    if (len(arr) - 1 - best_round) >= e:
                        stopped = True
            done = nxt
            if ck and not stopped and done < target and done % ck == 0:
                self._write_checkpoint(
                    checkpoint_path, run_trees=run_trees, k=k, done=done,
                    target=target, rounds_before=rounds_before, margins=margins,
                    eval_margins=eval_margins, es_history=es_history,
                    early_stopping_rounds=e, checkpoint_every=ck,
                    verbose_every=verbose_every, eval_names=eval_names,
                )

        if self.comm_stats is not None:
            self.comm_stats["fallback_events"] = fallback_events

        # Deferred final history record: the cadence records round r when
        # r % record_every == 0, the last trained round unconditionally.
        if last_chunk is not None:
            start, tr_host, ev_host = last_chunk
            final_r = done - 1
            if final_r % record_every != 0:
                self._emit_record(final_r, final_r - start, tr_host, ev_host, metrics,
                                  eval_names, rounds_before, callback)

        # Early stopped: keep best_iteration + 1 rounds in all (best_round
        # may precede a resume point, so the cut can fall inside the trees
        # from before it). The Ensemble (and its packed nodes) is built once.
        keep = best_round + 1 if stopped else done
        full = self._with_run(run_trees, k)
        if stopped and keep < done:
            full = PR.truncate_rounds(full, rounds_before + keep)
        self.ensemble = full
        self.n_rounds_trained = rounds_before + keep
        if es_on and best_round is not None:
            self.best_iteration = rounds_before + best_round
            self.best_score = float(es_history[best_round])
        if keep == done:
            self.margins, self._train_dmat = margins, dtrain
        else:  # model truncated: the margins would be stale
            self.margins = self._train_dmat = None
        if checkpoint_path is not None:
            self._write_final_checkpoint(checkpoint_path)

    def _with_run(self, run_trees: list[T.Tree], k: int) -> PR.Ensemble:
        """The model so far: the booster's ensemble followed by this run's
        trees (learning rate baked into their leaves)."""
        run_ens = PR.stack_trees(run_trees, k, self.base_score,
                                 leaf_scale=self.cfg.learning_rate)
        return run_ens if self.ensemble is None else PR.concat_ensembles(self.ensemble,
                                                                         run_ens)

    def _record_history(self, start, length, tr_host, ev_host, metrics, eval_names,
                        rounds_before, record_every, callback):
        for i in range(length):
            r = start + i
            if r % record_every:
                continue
            self._emit_record(r, i, tr_host, ev_host, metrics, eval_names,
                              rounds_before, callback)

    def _emit_record(self, r, i, tr_host, ev_host, metrics, eval_names,
                     rounds_before, callback):
        rec: dict[str, Any] = {"round": rounds_before + r}
        for j, m in enumerate(metrics):
            rec[f"train_{m.name}"] = float(tr_host[j][i])
        for name, vals in zip(eval_names, ev_host):
            for j, m in enumerate(metrics):
                rec[f"{name}_{m.name}"] = float(vals[j][i])
        self.history.append(rec)
        if callback:
            callback(rounds_before + r, rec)

    # --- resilience plumbing -------------------------------------------------
    def _handle_numeric_flags(self, flags, start_round):
        """Host-side numeric-sentinel policy, applied once per chunk from the
        per-round finite flags read with the chunk's metrics."""
        policy = self.cfg.numeric_check
        if policy == "off" or flags is None:
            return
        bad = np.flatnonzero(~np.asarray(flags))
        if bad.size == 0:
            return
        rounds = [int(start_round + b) for b in bad]
        if policy == "raise":
            raise RES.NumericError(
                f"non-finite gradients/hessians/leaf values at boosting "
                f"round(s) {rounds} (numeric_check='raise'). Check labels "
                "and objective stability, or train with numeric_check="
                "'warn_skip' or 'clamp'."
            )
        if policy == "warn_skip":
            warnings.warn(
                f"round(s) {rounds} produced non-finite values; their trees "
                "were zeroed and margins carried forward unchanged "
                "(numeric_check='warn_skip')"
            )
            self.skipped_rounds.extend(rounds)
            self.resilience_events.append({"event": "rounds_skipped", "rounds": rounds})
        else:  # clamp
            warnings.warn(
                f"non-finite gradients at round(s) {rounds} were replaced/"
                "clipped before tree growth (numeric_check='clamp')"
            )
            self.resilience_events.append({"event": "gradients_clamped", "rounds": rounds})

    def _check_divergence(self, ev_host, eval_names, metrics, start_round):
        """Divergence detection on eval metrics (active with any non-"off"
        numeric_check): a non-finite metric means later rounds can only
        compound the damage."""
        if self.cfg.numeric_check == "off" or not eval_names:
            return
        for name, vals in zip(eval_names, ev_host):
            for m, arr in zip(metrics, vals):
                bad = np.flatnonzero(~np.isfinite(arr))
                if bad.size == 0:
                    continue
                at = int(start_round + bad[0])
                msg = (f"eval metric {name}_{m.name} became non-finite at "
                       f"round {at} — the fit is diverging")
                if self.cfg.numeric_check == "raise":
                    raise RES.DivergenceError(msg)
                warnings.warn(msg)
                self.resilience_events.append(
                    {"event": "divergence", "metric": f"{name}_{m.name}", "round": at}
                )
                return

    def _write_checkpoint(self, path, *, run_trees, k, done, target, rounds_before,
                          margins, eval_margins, es_history, early_stopping_rounds,
                          checkpoint_every, verbose_every, eval_names):
        """Atomic in-run snapshot at a chunk boundary: the partial model plus
        everything `resume` needs to replay the rest of the fit (carried
        margins, early-stopping history, the absolute round of the draws,
        the recording cadence). One copy of the margins to the host, once
        a snapshot."""
        from repro_torch.checkpoint import io as CIO

        ens = self._with_run(run_trees, k)
        resume = {
            "rounds_done": int(done),
            "target": int(target),
            "rounds_before": int(rounds_before),
            "margins": margins,
            "eval_margins": tuple(eval_margins),
            "es_history": [float(v) for v in es_history],
            "early_stopping_rounds": int(early_stopping_rounds or 0),
            "checkpoint_every": int(checkpoint_every or 0),
            "verbose_every": int(verbose_every or 0),
            "eval_names": [str(n) for n in eval_names],
            "metric_names": [m.name for m in (self._metrics or ())],
        }
        self._save_snapshot(
            path,
            lambda: CIO.save_booster(path, self, ensemble=ens,
                                     n_rounds_trained=rounds_before + done,
                                     history=self.history, resume=resume),
            at_round=rounds_before + done,
        )

    def _write_final_checkpoint(self, path):
        from repro_torch.checkpoint import io as CIO

        self._save_snapshot(path, lambda: CIO.save_booster(path, self),
                            at_round=self.n_rounds_trained)

    def _save_snapshot(self, path, write, at_round):
        """Checkpoint writes retry on transient I/O errors and degrade to a
        warning on persistent failure — losing a snapshot must not kill the
        training run it exists to protect."""
        try:
            RES.with_retries(write, retries=2, backoff=0.05, retry_on=(OSError,))
        except OSError as exc:
            warnings.warn(
                f"checkpoint write to {path} failed after retries ({exc}); "
                "training continues without this snapshot"
            )
            self.resilience_events.append({
                "event": "checkpoint_write_failed", "path": str(path),
                "round": int(at_round), "error": str(exc),
            })

    # --- inference ---------------------------------------------------------
    def predict_margins(self, data, iteration_range: tuple[int, int] = (0, 0)) -> torch.Tensor:
        """Margins (n_rows, n_outputs) of raw rows (numpy or torch, NaN =
        missing; moved to the booster's device) or of a DeviceDMatrix or
        ExternalDMatrix built with ref= the training matrix (bin-space
        traversal).

        iteration_range=(a, b) restricts to boosting rounds [a, b), XGBoost
        semantics (b=0 means "through the last round"); the default is the
        whole model. The slice takes the model's packed nodes with it."""
        self._require_fitted()
        ens = self.ensemble
        if tuple(iteration_range) != (0, 0):
            ens = PR.slice_rounds(ens, *iteration_range)
        if isinstance(data, (DeviceDMatrix, ExternalDMatrix)):
            if data.device != self.device:
                raise ValueError(f"{type(data).__name__} lives on {data.device}, the "
                                 f"booster on {self.device}")
            if not cuts_equal(self.cuts, data.cuts):
                raise ValueError(
                    f"{type(data).__name__} was quantised with different cuts than "
                    "this booster; build it with ref= the training matrix"
                )
            if isinstance(data, ExternalDMatrix):
                return self._predict_margins_external(ens, data)
            return PR.predict_binned_on(ens, data.packed_bins(), self.cfg.max_bins - 1,
                                        self.cfg.max_depth)
        x = as_tensor(data, self.device)
        self._check_rows(x)
        return ST.predict_margins_fused(ens, x, self.cfg.max_depth)

    def _predict_margins_external(self, ens: PR.Ensemble, data: ExternalDMatrix):
        """Margins over an ExternalDMatrix, its words one packed chunk at a
        time (`iter_device_chunks`: unless training left the stack on the
        device, only one chunk's words are there at once). Each chunk's
        margins are written as the chunk is read, so the device holds one
        chunk's words, one tree's leaves over the chunk and the margins.
        Each class adds its trees in tree order whatever rows share the
        call (`predict.fold_classes`), so the margins are bit for bit those
        of the DeviceDMatrix of the same rows."""
        mb, depth = self.cfg.max_bins - 1, self.cfg.max_depth
        margins = torch.empty((data.n_rows, ens.n_classes), dtype=torch.float32,
                              device=self.device)
        for i, words in enumerate(data.iter_device_chunks()):
            s = i * data.chunk_rows
            rows = min(data.chunk_rows, data.n_rows - s)
            margins[s:s + rows] = PR.predict_binned_on(
                ens, C.PackedBins(words, data.bits, rows), mb, depth)
        return margins

    def predict(self, data, output_margin: bool = False,
                iteration_range: tuple[int, int] = (0, 0)) -> torch.Tensor:
        """Transformed predictions (values / probabilities / class ids)."""
        m = self.predict_margins(data, iteration_range=iteration_range)
        return m if output_margin else self.obj.transform(m)

    def eval(self, dmat, name: str = "eval", metrics=None) -> dict:
        """One-shot metrics on a labelled DeviceDMatrix or ExternalDMatrix.

        metrics: optional spec or list of specs (as in fit's eval_metric);
        defaults to the objective's default metric. Returns
        {f"{name}_{metric}": value} for each metric.
        """
        self._require_fitted()
        if dmat.label is None:
            raise ValueError("eval requires a labelled DeviceDMatrix")
        resolved = M.resolve_metrics(metrics) or (M.get_metric(self.obj.default_metric),)
        margins = self.predict_margins(dmat)
        extra = self._dataset_extra(dmat)
        return {f"{name}_{m.name}": float(m.fn(margins, dmat.label, **extra))
                for m in resolved}

    def feature_importances(self, importance_type: str = "gain") -> np.ndarray:
        """Per-feature importance over the fitted ensemble, from the split
        gains stored in the tree arenas (a split node is any arena slot
        with finite gain; leaves and inactive slots carry -inf).

        importance_type:
          * "gain"       — mean objective reduction per split on the feature;
          * "total_gain" — summed objective reduction;
          * "weight"     — number of splits on the feature.

        Returns a float64 (n_features,) numpy vector (unnormalised).
        """
        self._require_fitted()
        gain = self.ensemble.gain.cpu().numpy().astype(np.float64)
        feat = self.ensemble.feature.cpu().numpy()
        split = np.isfinite(gain)
        n_features = self.n_features or 0
        counts = np.bincount(feat[split], minlength=n_features).astype(np.float64)
        if importance_type == "weight":
            return counts
        if importance_type in ("gain", "total_gain"):
            total = np.zeros(n_features, np.float64)
            np.add.at(total, feat[split], gain[split])
            if importance_type == "total_gain":
                return total
            return np.divide(total, counts, out=np.zeros_like(total), where=counts > 0)
        raise ValueError(
            f"importance_type must be 'gain', 'total_gain' or 'weight', "
            f"got {importance_type!r}"
        )

    # --- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        """Self-describing checkpoint (config + cuts + base score + trees) in
        the reference's format (`checkpoint/io.py`): a file either package
        writes, the other loads."""
        self._require_fitted()
        from repro_torch.checkpoint import io as CIO

        CIO.save_booster(path, self)

    @classmethod
    def load(cls, path: str, *, device=None) -> "Booster":
        """A Booster from a checkpoint, its tensors on `device` (the card
        unless "cpu")."""
        from repro_torch.checkpoint import io as CIO

        return CIO.load_booster(path, device=device)


# Deprecated alias kept from the reference: the old TrainState (ensemble /
# margins / history attribute surface) is the Booster itself.
TrainState = Booster


def train(
    x,
    y,
    cfg: BoosterConfig,
    eval_set: tuple[Any, Any] | None = None,
    group_ids=None,
    verbose_every: int = 0,
    callback: Callable[[int, dict], None] | None = None,
    *,
    device=None,
) -> Booster:
    """Deprecated one-shot shim over DeviceDMatrix + Booster.fit, on
    `device` (the card unless "cpu"). It quantises x on every call: build a
    DeviceDMatrix once and call `Booster.fit` to amortise that. `eval_set`
    becomes the eval set named "valid"; `group_ids` (ranking) become the
    training matrix's query groups."""
    dtrain = DeviceDMatrix(x, label=y, group_ids=group_ids, max_bins=cfg.max_bins,
                           device=device)
    evals = []
    if eval_set is not None:
        xv, yv = eval_set
        evals.append((DeviceDMatrix(xv, label=yv, ref=dtrain), "valid"))
    return Booster(cfg).fit(dtrain, evals=evals, verbose_every=verbose_every,
                            callback=callback)


def predict_margins(ens: PR.Ensemble, x, max_depth: int) -> torch.Tensor:
    """Deprecated shim: raw-threshold margins of rows `x` on the model's
    device. The single float32 conversion lives here."""
    return PR.predict_raw(ens, as_tensor(x, ens.feature.device), max_depth)


def predict(ens: PR.Ensemble, x, max_depth: int, objective: str) -> torch.Tensor:
    """Deprecated shim: prefer Booster.predict (the model describes itself)."""
    return O.get_objective(objective).transform(predict_margins(ens, x, max_depth))
