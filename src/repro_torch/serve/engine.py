"""PredictEngine, the serving front end; counterpart of `repro.serve.engine`.

Wraps a fitted (or imported, or loaded) Booster behind a `predict(X)` call
shaped for request traffic:

  * A ladder of row buckets. A request is padded up to the smallest bucket
    that holds it (larger ones are served in top-bucket slices), so every
    request runs one of a few fixed programs. Padding rows are NaN, the
    legal missing marker, and are sliced off the output.
  * On the card, one CUDA graph a bucket, captured once (at `warmup`, or
    when a bucket is first used): the traversal kernel's launch over a
    static device input block, the base score, and the objective's
    transform unless `output_margin=True`. A request then replays it; the
    kernel wrapper counts its launch at capture, never at replay. A capture
    that fails raises: there is no eager fallback.
  * Persistent host staging. Two pinned staging buffers a bucket: a slice's
    rows are copied into one (the single float32 conversion on this path),
    the tail is NaN, and the copy to the card leaves from pinned memory,
    asynchronously. The two alternate between slices, and a buffer is
    written again only once the event recorded after its last copy has
    passed. The outputs go to a pinned host buffer; a request synchronises
    with the card once, at its end.
  * On the CPU (a booster on `device="cpu"`) the same ladder and staging run
    the traversal's plain version, one program a bucket.
  * Latency accounting. Every call records rows, wall seconds and whether it
    built a program; `stats()` reduces to p50/p99 latency and rows/s with
    those calls excluded.

`trace_count` is the number of programs built: graph captures on the card,
one a bucket, and a steady-state engine never raises it. The reference's
donated input blocks have no counterpart: the static blocks are reused.

Validation mirrors DeviceDMatrix: inputs must be 2-D with the model's
feature count, ±inf is rejected with the same remedy message, NaN stays
legal missing.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import predict as PR
from repro_torch.kernels import build as KB
from repro_torch.kernels import ops

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


class PredictEngine:
    """Batched-inference engine over a fitted Booster.

    Args:
      booster: a fitted `repro_torch.core.Booster` (trained here, loaded
        from a checkpoint or imported with `import_xgboost_json`); the
        engine serves on its device.
      buckets: ascending row-count ladder to pad batches onto. Requests
        larger than the top bucket are served in top-bucket slices.
      output_margin: serve raw margins instead of transformed predictions.
      iteration_range: XGBoost-style (a, b) round slice baked in at engine
        build (staged serving: one engine per stage, no per-call slicing).
      host_staging: keep persistent staging buffers (pinned on the card);
        without it every slice is staged in a fresh pageable buffer.

    `predict(X)` returns a numpy array of X's row count.
    """

    def __init__(
        self,
        booster,
        *,
        buckets: tuple[int, ...] = DEFAULT_BUCKETS,
        output_margin: bool = False,
        iteration_range: tuple[int, int] = (0, 0),
        host_staging: bool = True,
    ):
        if getattr(booster, "ensemble", None) is None:
            raise RuntimeError(
                "PredictEngine requires a fitted Booster — call fit() or "
                "import a model first"
            )
        buckets = tuple(sorted(int(b) for b in buckets))
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"buckets must be positive ints, got {buckets!r}")

        ens = booster.ensemble
        if tuple(iteration_range) != (0, 0):
            ens = PR.slice_rounds(ens, *iteration_range)
        self._ens = ens
        self._max_depth = booster.cfg.max_depth
        self._transform = None if output_margin else booster.obj.transform
        self._buckets = buckets
        self._host_staging = bool(host_staging)
        self._device = ens.nodes.device

        nf = getattr(booster, "n_features_in_", None)
        if nf is None and getattr(booster, "cuts", None) is not None:
            nf = int(booster.cuts.shape[0])
        if nf is None:
            raise ValueError(
                "cannot infer the model's feature count; booster has "
                "neither cuts nor n_features_in_"
            )
        self.n_features = int(nf)

        self._programs: dict[int, _GraphProgram | _PlainProgram] = {}
        self._pool = None  # the graphs' shared memory pool (card)
        self._result: torch.Tensor | None = None  # pinned outputs (card), grown on demand
        self._trace_count = 0
        self.calls: list[dict] = []

    # --- programs ----------------------------------------------------------
    @property
    def trace_count(self) -> int:
        """Programs built so far: one per bucket after warmup (graph
        captures on the card); a steady-state engine never increases it."""
        return self._trace_count

    def _bucket_for(self, n_rows: int) -> int:
        for b in self._buckets:
            if n_rows <= b:
                return b
        return self._buckets[-1]

    def _program_for(self, bucket: int):
        prog = self._programs.get(bucket)
        if prog is None:
            if self._device.type == "cuda":
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                prog = _GraphProgram(self, bucket)
            else:
                prog = _PlainProgram(self, bucket)
            self._programs[bucket] = prog
            self._trace_count += 1
        return prog

    def _margins(self, block: torch.Tensor) -> torch.Tensor:
        """The program's body: traversal kernel, base score, transform."""
        m = ops.ensemble_margins_nodes_op(self._ens.nodes, block, self._ens.n_classes,
                                          self._max_depth) + self._ens.base_score
        return m if self._transform is None else self._transform(m)

    # --- serving -----------------------------------------------------------
    def warmup(self) -> "PredictEngine":
        """Build every bucket's program up front (and run it once), so the
        first real request never pays a capture."""
        probe = np.zeros((1, self.n_features), np.float32)
        for b in self._buckets:
            self._serve(probe, bucket=b)
        return self

    def predict(self, x) -> np.ndarray:
        """Serve one request batch. Accepts any 2-D array-like; rows beyond
        the largest bucket are processed in largest-bucket slices."""
        t0 = time.perf_counter()
        x = np.asarray(x)
        if x.ndim != 2:
            raise ValueError(
                f"x must be 2-D (n_rows, n_features), got shape {x.shape}"
            )
        if x.shape[1] != self.n_features:
            raise ValueError(
                f"x has {x.shape[1]} features, model expects "
                f"{self.n_features}"
            )
        if x.shape[0] == 0:
            raise ValueError("x has 0 rows; nothing to predict")
        if np.isinf(x).any():
            raise ValueError(
                "x contains infinite feature values; replace ±inf with NaN "
                "(the legal missing marker) or a large finite value before "
                "prediction"
            )
        built_before = self._trace_count
        result = self._serve(x)
        self.calls.append({
            "rows": int(x.shape[0]),
            "seconds": time.perf_counter() - t0,
            "compiled": self._trace_count > built_before,
        })
        return result

    def _serve(self, x: np.ndarray, bucket: int | None = None) -> np.ndarray:
        n, top = x.shape[0], self._buckets[-1]
        slices = [(s, x[s:s + top]) for s in range(0, n, top)]
        if self._device.type != "cuda":
            parts = [self._program_for(bucket or self._bucket_for(part.shape[0]))
                     .run(part).numpy()[:part.shape[0]] for _, part in slices]
            return parts[0].copy() if len(parts) == 1 else np.concatenate(parts)
        stream = torch.cuda.current_stream(self._device)
        result = None
        for s, part in slices:
            prog = self._program_for(bucket or self._bucket_for(part.shape[0]))
            out = prog.run(part, stream)
            if result is None:
                result = self._result_buffer(n, out)
            result[s:s + part.shape[0]].copy_(out[:part.shape[0]], non_blocking=True)
        stream.synchronize()  # the request's one wait on the card
        return result[:n].numpy().copy()

    def _result_buffer(self, n: int, out: torch.Tensor) -> torch.Tensor:
        """A pinned host buffer for n rows of the programs' output."""
        buf = self._result
        if buf is None or buf.shape[0] < n or buf.dtype != out.dtype:
            buf = torch.empty((max(n, self._buckets[-1]), *out.shape[1:]),
                              dtype=out.dtype, pin_memory=True)
            self._result = buf
        return buf

    # --- accounting --------------------------------------------------------
    def stats(self, include_warmup: bool = False) -> dict:
        """p50/p99 latency and throughput over recorded calls. Calls that
        built a program are excluded unless include_warmup=True."""
        calls = [
            c for c in self.calls if include_warmup or not c["compiled"]
        ]
        if not calls:
            return {"n_calls": 0}
        lat = np.array([c["seconds"] for c in calls])
        rows = sum(c["rows"] for c in calls)
        return {
            "n_calls": len(calls),
            "rows": rows,
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "rows_per_s": float(rows / lat.sum()),
        }

    def reset_stats(self) -> None:
        self.calls.clear()


def _stage(buf: np.ndarray, part: np.ndarray) -> None:
    """Copy a slice into a staging buffer (the single float32 conversion)
    and NaN-fill the padding tail."""
    n = part.shape[0]
    np.copyto(buf[:n], part, casting="unsafe")
    buf[n:] = np.nan


class _PlainProgram:
    """A bucket on the CPU: a staging buffer, the plain traversal on it."""

    def __init__(self, eng: PredictEngine, bucket: int):
        self._eng, self._bucket = eng, bucket
        self._staging = (np.empty((bucket, eng.n_features), np.float32)
                         if eng._host_staging else None)

    def run(self, part: np.ndarray) -> torch.Tensor:
        buf = self._staging
        if buf is None:
            buf = np.empty((self._bucket, self._eng.n_features), np.float32)
        _stage(buf, part)
        return self._eng._margins(torch.from_numpy(buf))


class _GraphProgram:
    """A bucket on the card: two pinned staging buffers, a device input
    block, and one CUDA graph of the program over it, captured here."""

    def __init__(self, eng: PredictEngine, bucket: int):
        self._eng, self._bucket = eng, bucket
        dev, nf = eng._device, eng.n_features
        self._staging = ([torch.full((bucket, nf), float("nan"), pin_memory=True)
                          for _ in range(2)] if eng._host_staging else None)
        self._copied = [torch.cuda.Event(), torch.cuda.Event()]
        self._turn = 0
        self._block = torch.full((bucket, nf), float("nan"), device=dev)
        KB.device_limits(dev.index)  # host-only queries, before the capture
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph, pool=eng._pool):
            self.out = eng._margins(self._block)

    def run(self, part: np.ndarray, stream) -> torch.Tensor:
        """Stage `part`, copy it to the card and replay; returns the static
        output block (valid once the stream reaches it)."""
        if self._staging is None:
            buf = torch.empty((self._bucket, self._eng.n_features))
            _stage(buf.numpy(), part)
            self._block.copy_(buf)
        else:
            j, self._turn = self._turn, self._turn ^ 1
            self._copied[j].synchronize()  # its last copy to the card has ended
            _stage(self._staging[j].numpy(), part)
            self._block.copy_(self._staging[j], non_blocking=True)
            self._copied[j].record(stream)
        self._graph.replay()
        return self.out
