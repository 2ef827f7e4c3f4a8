"""Closed loop of batch scoring: the `predict` driver.

Traffic keys: the model (`n_trees` complete trees of `depth` levels, leaf
values normal with `leaf_std`), the batches (`batch_min` to `batch_max`
rows, log-uniform, a fixed cycle of `cycle` sizes whose order each pass
draws from the seed), which calls the check keeps (`keep_every`,
`keep_max`, and always the first call of the largest size), and the traced
stretch (`trace_calls`).

The pool is the configuration's features (`rows` x `features`), made on
the card from the seed; each batch is the slice at a rotating offset, so
no batch sits in L2 from the last. The model is made on the card from the
seed as well: every split takes a uniformly drawn feature at a threshold
drawn from the feature's 255 value-bin edges (the standard normal's
quantiles at k / 256), so every row walks every tree to its full depth.

One client calls `Booster.predict` on rows already on the card and waits
for the probabilities. `predict_rows_per_s` is the window's rows over its
wall time; `predict_p95_ms` the 95th percentile of the calls' latencies,
each timed by CUDA events from the call to its result. The check scores
the kept calls' rows again with the plain reference in float64:
`prob_gap`, the widest gap between a probability the program returned and
the reference's.
"""
from __future__ import annotations

import gc
import math
import time
import traceback

import torch

from perfbench.data import generators as G
from perfbench.reference import traversal as RT


def batch_cycle(name: str, traffic: dict) -> list[int]:
    """The fixed cycle of batch sizes, log-uniform, set by the names."""
    g = torch.Generator().manual_seed(G.name_seed(name))
    lo, hi = math.log(traffic["batch_min"]), math.log(traffic["batch_max"])
    u = torch.rand(traffic["cycle"], generator=g, dtype=torch.float64)
    sizes = torch.round(torch.exp(lo + (hi - lo) * u)).to(torch.int64).tolist()
    sizes[0] = traffic["batch_max"]  # the longest call is always in the cycle
    return sizes


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.dev = cell.device
        self.n_devices = 1
        self.attempted = self.failed = 0
        self.errors: list[str] = []

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def setup(self) -> None:
        from repro_torch.core import Booster
        from repro_torch.core.predict import Ensemble

        c, t = self.cell.config, self.cell.traffic
        self.pool = G.tabular(c["name"], c["rows"], c["features"], self.cell.seed, self.dev).x
        self.model = self.make_model()
        bst = Booster(n_rounds=t["n_trees"], max_depth=t["depth"], objective=c["objective"])
        bst.ensemble = Ensemble(**self.model, n_classes=1, base_score=0.0)
        bst.device = self.dev
        bst.n_rounds_trained = t["n_trees"]
        bst.n_features_in_ = c["features"]
        self.booster = bst
        self.sizes = batch_cycle(f"{c['name']}/{self.cell.traffic['driver']}", t)
        self.offset = 0
        for b in sorted(set(self.sizes)):  # every shape of the traffic, once
            self.booster.predict(self.pool[:b])
        self._sync()

    def make_model(self) -> dict:
        """Complete trees from the seed, on the card, in a few calls."""
        c, t = self.cell.config, self.cell.traffic
        n_trees, depth = t["n_trees"], t["depth"]
        arena, inner = 2 ** (depth + 1) - 1, 2 ** depth - 1
        g = G.device_generator(self.cell.seed, c["name"] + "/model", self.dev)
        shape = (n_trees, arena)
        is_leaf = (torch.arange(arena, device=self.dev) >= inner).expand(shape).contiguous()
        k = torch.randint(1, 256, shape, generator=g, device=self.dev).to(torch.float32)
        edge = math.sqrt(2.0) * torch.erfinv(2.0 * k / 256.0 - 1.0)
        leaf = torch.randn(shape, generator=g, device=self.dev) * t["leaf_std"]
        return {
            "feature": torch.where(is_leaf, 0, torch.randint(0, c["features"], shape, generator=g,
                                                             device=self.dev)).to(torch.int32),
            "split_bin": torch.zeros(shape, dtype=torch.int32, device=self.dev),
            "threshold": torch.where(is_leaf, float("inf"), edge),
            "default_left": ~is_leaf & (torch.rand(shape, generator=g, device=self.dev) < 0.5),
            "leaf_value": torch.where(is_leaf, leaf, 0.0),
            "is_leaf": is_leaf,
            "gain": torch.where(is_leaf, float("-inf"), 1.0),
        }

    def batches(self, seed_tag: int):
        """Endless (offset, size) of the cycle, its order drawn anew each
        pass from the seed."""
        n_pool = self.pool.shape[0]
        g = torch.Generator().manual_seed(G.run_seed(self.cell.seed, f"batches/{seed_tag}"))
        while True:
            for i in torch.randperm(len(self.sizes), generator=g).tolist():
                b = min(self.sizes[i], n_pool)
                if self.offset + b > n_pool:
                    self.offset = 0
                yield self.offset, b
                self.offset += b

    def call(self, off: int, b: int):
        """One timed call: (probabilities, seconds by CUDA events)."""
        if self.dev.type != "cuda":
            t0 = time.perf_counter()
            out = self.booster.predict(self.pool[off:off + b])
            return out, time.perf_counter() - t0
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = self.booster.predict(self.pool[off:off + b])
        e.record()
        e.synchronize()
        return out, s.elapsed_time(e) / 1e3

    def window(self, seconds: float) -> dict:
        t = self.cell.traffic
        phase = self.cell.seed % t["keep_every"]
        self.calls, self.kept = [], []
        biggest = max(self.sizes)
        kept_biggest = False
        rows = 0
        stream = self.batches(0)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            off, b = next(stream)
            i = self.attempted
            self.attempted += 1
            try:
                out, lat = self.call(off, b)
            except Exception:  # counted against the attempts; the run goes on
                self.failed += 1
                self.errors.append(traceback.format_exc())
                self._sync()
                continue
            self.calls.append((b, lat))
            rows += b
            keep = (i % t["keep_every"] == phase and len(self.kept) < t["keep_max"])
            if b == biggest and not kept_biggest:
                keep, kept_biggest = True, True
            if keep:
                self.kept.append((off, b, out))
        wall = time.perf_counter() - t0
        if not self.calls:
            raise RuntimeError("no call completed in the window:\n" + "\n".join(self.errors[:1]))
        lat = sorted(x for _, x in self.calls)
        p95 = lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
        return {"predict_rows_per_s": rows / wall, "predict_p95_ms": 1e3 * p95}

    def trace(self):
        from perfbench import trace as TR

        stream = self.batches(1)
        self.traced_calls = [next(stream) for _ in range(self.cell.traffic["trace_calls"])]

        def stretch():
            for off, b in self.traced_calls:
                self.booster.predict(self.pool[off:off + b])
        return TR.traced(stretch)

    def release(self) -> None:
        self.booster = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, off: int, b: int, dtype: torch.dtype) -> torch.Tensor:
        m = self.model
        return RT.predict(self.cell.config["objective"], m["feature"], m["threshold"],
                          m["default_left"], m["leaf_value"], m["is_leaf"],
                          self.pool[off:off + b], self.cell.traffic["depth"], dtype)

    def judge(self, kept) -> dict:
        gap = 0.0
        for off, b, out in kept:
            ref = self.reference(off, b, torch.float64)
            gap = max(gap, float((out.reshape(-1).to(torch.float64) - ref).abs().max()))
        return {"prob_gap": gap}

    def check(self) -> dict:
        return self.judge(self.kept)

    def stand_in(self, dtype: torch.dtype):
        """The reference in the program's place, on the kept calls."""
        return [(off, b, self.reference(off, b, dtype)) for off, b, _ in self.kept]

    def work(self) -> dict:
        c, t = self.cell.config, self.cell.traffic
        a = self.model["feature"].shape[1]
        return {"kind": "predict", "features": c["features"], "n_trees": t["n_trees"],
                "arena": a + a % 2,  # the packed nodes' width
                "depth": t["depth"], "traced_calls": [b for _, b in self.traced_calls],
                "window_calls": self.calls}
