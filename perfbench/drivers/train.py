"""Closed loop of whole fits: the `train` driver.

Traffic keys: `rounds` (boosting rounds a fit), `warm_rounds` (the set-up's
fit, which runs every shape of a round once), `trace_rounds` (the traced
fit), `round_metric` (the name the cell reports its time a round under). One client: each fit starts when the last one has returned. Every fit
starts from the set-up's `DeviceDMatrix`, as a tuning sweep or a
cross-validation does. The window holds whole fits only and ends with the
fit running when the time is up; the time a round is its wall time over all
the rounds it completed.

The check judges one of the window's fits, drawn from the seed, with the
plain reference (`reference.growth.judge`) on the reference's own cuts,
bins and float64 gradients: `split_regret`, `leaf_gap`, `margin_gap` and
`threshold_mismatch`.
"""
from __future__ import annotations

import gc
import time
import traceback

import torch

from perfbench.data import generators as G
from perfbench.reference import growth as RG
from perfbench.reference import objectives as OBJ
from perfbench.reference import quantile as QT

TREE_FIELDS = ("feature", "split_bin", "default_left", "leaf_value", "is_leaf", "threshold")


def params(config: dict) -> RG.Params:
    return RG.Params(config["max_depth"], config["max_bins"], config["learning_rate"],
                     config["reg_lambda"], config["min_child_weight"], config["objective"])


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.dev = cell.device
        self.n_devices = 1
        self.attempted = self.failed = 0
        self.errors: list[str] = []
        c = cell.config
        self.kw = dict(max_depth=c["max_depth"], max_bins=c["max_bins"],
                       learning_rate=c["learning_rate"], reg_lambda=c["reg_lambda"],
                       min_child_weight=c["min_child_weight"], objective=c["objective"])
        self._ref = None
        self.readings = None

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def setup(self) -> None:
        from repro_torch.core import DeviceDMatrix

        c = self.cell.config
        self.data = G.make(c, self.cell.seed, self.dev)
        self.dtrain = DeviceDMatrix(self.data.x, label=self.data.y,
                                    group_ids=getattr(self.data, "qid", None),
                                    max_bins=c["max_bins"], device=str(self.dev))
        self.fit(self.cell.traffic["warm_rounds"])

    def fit(self, rounds: int):
        from repro_torch.core import Booster

        bst = Booster(n_rounds=rounds, **self.kw).fit(self.dtrain)
        self._sync()
        return bst

    def window(self, seconds: float) -> dict:
        rounds = self.cell.traffic["rounds"]
        self.fits, done = [], 0
        t0 = time.perf_counter()
        while True:
            self.attempted += 1
            try:
                bst = self.fit(rounds)
            except Exception:  # counted against the attempts; the run goes on
                self.failed += 1
                self.errors.append(traceback.format_exc())
                self._sync()
            else:
                ens = bst.ensemble
                self.fits.append(({f: getattr(ens, f) for f in TREE_FIELDS}, bst.margins))
                done += bst.n_rounds_trained
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        if not done:
            raise RuntimeError("no fit completed in the window:\n" + "\n".join(self.errors[:1]))
        self.round_s = wall / done
        return {self.cell.traffic["round_metric"]: 1e3 * wall / done}

    def trace(self):
        from perfbench import trace as TR

        self.trace_rounds = self.cell.traffic["trace_rounds"]
        return TR.traced(lambda: self.fit(self.trace_rounds))

    def release(self) -> None:
        """Keep the judged fit's trees and margins, free the rest of the
        program's state."""
        pick = self.cell.seed % len(self.fits) if self.fits else 0
        self.judged = self.fits[pick] if self.fits else None
        self.fits = []
        self.dtrain = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference_inputs(self):
        """The reference's own cuts and bins of the generated features, and
        the query blocks of a ranking set (made once a run)."""
        if self._ref is None:
            mb = self.cell.config["max_bins"]
            cut = QT.cuts(self.data.x, mb)
            bins = QT.quantize(self.data.x, cut, mb)
            sizes = getattr(self.data, "sizes", None)
            blocks = OBJ.QueryBlocks(sizes) if sizes is not None else None
            self._ref = (cut, bins, blocks)
        return self._ref

    def judge(self, trees: RG.Trees, margins: torch.Tensor) -> dict:
        cut, bins, blocks = self.reference_inputs()
        p = params(self.cell.config)
        self.readings = RG.judge(trees, margins, bins, cut, self.data.y, p, blocks,
                                 OBJ.base_score(p.objective))
        r = self.readings
        return {"split_regret": r.split_regret, "leaf_gap": r.leaf_gap,
                "margin_gap": r.margin_gap, "threshold_mismatch": r.threshold_mismatch}

    def extra(self) -> dict:
        """Readings of the last judge that are read, not compared."""
        r = self.readings
        return {"leaf_gap_max": r.leaf_gap_max, "margin_gap_max": r.margin_gap_max,
                "worst_leaf": r.worst_leaf, "worst_split": r.worst_split}

    def check(self) -> dict:
        fields, margins = self.judged
        return self.judge(RG.Trees(**fields), margins)

    def stand_in(self, dtype: torch.dtype, fault: RG.Fault | None = None):
        """The reference in the program's place: (trees, margins)."""
        cut, bins, blocks = self.reference_inputs()
        p = params(self.cell.config)
        return RG.grow(bins, cut, self.data.y, p, self.cell.traffic["rounds"], dtype, blocks,
                       fault, OBJ.base_score(p.objective))

    def work(self) -> dict:
        c = self.cell.config
        return {"kind": "train", "rounds": self.trace_rounds, "round_s": self.round_s,
                "rows": int(self.data.y.shape[0]), "features": c["features"],
                "max_bins": c["max_bins"], "depth": c["max_depth"],
                "hist_rows": self.readings.hist_rows[:self.trace_rounds]}
