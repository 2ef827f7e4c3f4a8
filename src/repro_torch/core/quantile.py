"""Feature quantile generation (paper §2.1); counterpart of `repro.core.quantile`.

Exact sort-based quantiles (`kernels.ops.compute_cuts_op`): the columns are
sorted with `torch.sort` (NaN filled with +inf so it sorts to the tail),
then the selection stage picks the interior boundaries of `n_value_bins`
equal-mass bins. On a CUDA tensor the selection runs in the cut-selection
kernel (`kernels/csrc/quantile_cuts.cu`), on a CPU tensor in its plain
version, bit-identical to it. Missing values (NaN) take the reserved last
bin.

`select_cuts_from_sorted`, `compute_cuts_reference` and
`quantize_reference` keep the reference's names for the selection stage
and the oracles.

`StreamingQuantileSketch` is the reference's mergeable weighted quantile
summary (host numpy, copied: `push`, `push_sorted`, `merge`, `get_cuts`,
memory bounded by `capacity` entries per feature), the external-memory
path's cut generator. Its summaries and cuts equal the reference's bit for
bit; `get_cuts` hands them over as a tensor on the caller's device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

# Reserved: the last bin id of every feature is the "missing" bin. With
# max_bins=256 there are 255 value bins + 1 missing bin: 8-bit symbols.
DEFAULT_MAX_BINS = 256


def missing_bin_id(max_bins: int = DEFAULT_MAX_BINS) -> int:
    return max_bins - 1


def n_value_bins(max_bins: int = DEFAULT_MAX_BINS) -> int:
    return max_bins - 1


def select_cuts_from_sorted(srt: torch.Tensor, n_valid: torch.Tensor,
                            max_bins: int = DEFAULT_MAX_BINS) -> torch.Tensor:
    """Selection stage of compute_cuts over column-sorted (n, F) float32
    with a +inf tail and the (F,) finite counts: the cut-selection kernel on
    the card, its plain version on the CPU."""
    from repro_torch.kernels import ops  # lazy: ops imports core modules

    return ops.select_cuts_op(srt, n_valid, max_bins)


def compute_cuts(x: torch.Tensor, max_bins: int = DEFAULT_MAX_BINS) -> torch.Tensor:
    """Per-feature quantile cut points.

    Args:
      x: (n_rows, n_features) float tensor, NaN = missing.
      max_bins: total bins per feature incl. the reserved missing bin.

    Returns:
      cuts: (n_features, n_value_bins - 1) float32, ascending; value bin b
        holds x <= cuts[b] (and x > cuts[b-1]). Unused tail cuts are +inf.
    """
    from repro_torch.kernels import ops  # lazy: ops imports core modules

    return ops.compute_cuts_op(x, max_bins)


def compute_cuts_reference(x: torch.Tensor, max_bins: int = DEFAULT_MAX_BINS) -> torch.Tensor:
    """The cuts in plain torch on x's device (sort, then the selection's
    plain version): the oracle of `compute_cuts`, bit-identical to it."""
    from repro_torch.kernels import ops  # lazy: ops imports core modules

    return ops.R.quantile_cuts_ref(*ops.sorted_columns(x), max_bins)


def quantize(x: torch.Tensor, cuts: torch.Tensor) -> torch.Tensor:
    """Map raw features to bin ids (n_rows, n_features) int32.

    bin = number of cuts strictly below x (searchsorted left), so x <= cuts[b]
    lands in bin b; NaN -> the missing bin cuts.shape[1] + 1 = max_bins - 1.
    """
    n_cuts = cuts.shape[1]
    xt = x.to(torch.float32).t().contiguous()  # (f, n): one row per feature
    b = torch.searchsorted(cuts.contiguous(), xt, side="left").to(torch.int32)
    b = torch.where(torch.isnan(xt), torch.full_like(b, n_cuts + 1), b)
    return b.t().contiguous()


# The reference keeps its all-device quantize as the oracle of its host
# fast path; here quantize is plain torch on every device, its own oracle.
quantize_reference = quantize


# --- streaming sketch (external-memory cut generation) --------------------

# A per-feature summary is the tuple (vals, rmin, rmax, w):
#   vals  float32, strictly ascending distinct values
#   rmin  float64, lower bound on the total weight strictly below vals[i]
#   rmax  float64, upper bound on the total weight <= vals[i]
#   w     float64, weight known to sit exactly at vals[i]
# For a summary built from raw data rmin/rmax are the exact exclusive /
# inclusive cumulative weights; merging keeps them exact, pruning widens
# the [rmin, rmax] band by at most total/capacity per prune (GK invariant).
_EMPTY_SUMMARY = (
    np.empty(0, np.float32),
    np.empty(0, np.float64),
    np.empty(0, np.float64),
    np.empty(0, np.float64),
)


def _exact_summary(values: np.ndarray, weights: np.ndarray):
    """Exact summary of a raw (already finite) value batch."""
    order = np.argsort(values, kind="stable")
    v = values[order]
    w = weights[order]
    if v.size == 0:
        return _EMPTY_SUMMARY
    newgrp = np.empty(v.size, bool)
    newgrp[0] = True
    np.not_equal(v[1:], v[:-1], out=newgrp[1:])
    starts = np.flatnonzero(newgrp)
    vu = v[starts]
    wu = np.add.reduceat(w, starts)
    rmax = np.cumsum(wu)
    return vu, rmax - wu, rmax, wu


def _exact_summary_presorted(values: np.ndarray):
    """Exact unit-weight summary of an already-sorted finite value array.

    The external-memory build sorts each chunk's columns on the device
    (`dmatrix._push_chunk_sorted`); this skips the host-side re-sort that
    `_exact_summary` would do.
    """
    v = np.asarray(values, np.float32)
    if v.size == 0:
        return _EMPTY_SUMMARY
    newgrp = np.empty(v.size, bool)
    newgrp[0] = True
    np.not_equal(v[1:], v[:-1], out=newgrp[1:])
    starts = np.flatnonzero(newgrp)
    vu = v[starts]
    counts = np.diff(np.append(starts, v.size)).astype(np.float64)
    rmax = np.cumsum(counts)
    return vu, rmax - counts, rmax, counts


def _summary_contrib(summary, vu: np.ndarray):
    """This summary's (rmin, rmax, w) contribution at each union value."""
    vals, rmin, rmax, w = summary
    m = vals.size
    if m == 0:
        z = np.zeros(vu.size, np.float64)
        return z, z.copy(), z.copy()
    total = rmax[-1]
    i = np.searchsorted(vals, vu, side="left")
    ic = np.minimum(i, m - 1)
    present = vals[ic] == vu
    # Floor entry (last strictly below): everything <= it is surely below.
    fl = np.maximum(i - 1, 0)
    rmin_next = np.where(i > 0, rmin[fl] + w[fl], 0.0)
    # Ceil entry (first strictly above): its rmax minus its own weight
    # bounds the mass <= vu from above.
    j = np.searchsorted(vals, vu, side="right")
    jc = np.minimum(j, m - 1)
    rmax_prev = np.where(j < m, rmax[jc] - w[jc], total)
    return (
        np.where(present, rmin[ic], rmin_next),
        np.where(present, rmax[ic], rmax_prev),
        np.where(present, w[ic], 0.0),
    )


def _combine_summaries(a, b):
    """XGBoost WQSummary::Combine — exact summaries merge exactly."""
    if a[0].size == 0:
        return b
    if b[0].size == 0:
        return a
    vu = np.unique(np.concatenate([a[0], b[0]]))
    ra_min, ra_max, wa = _summary_contrib(a, vu)
    rb_min, rb_max, wb = _summary_contrib(b, vu)
    return vu.astype(np.float32), ra_min + rb_min, ra_max + rb_max, wa + wb


def _prune_summary(summary, capacity: int):
    """WQSummary::SetPrune — keep the endpoints plus the entries nearest to
    capacity-2 evenly spaced rank targets."""
    vals, rmin, rmax, w = summary
    m = vals.size
    if m <= capacity:
        return summary
    total = rmax[-1]
    mids = (rmin + rmax) * 0.5
    targets = total * np.arange(1, capacity - 1, dtype=np.float64) / (capacity - 1)
    pos = np.searchsorted(mids, targets)
    lo = np.clip(pos - 1, 0, m - 1)
    hi = np.clip(pos, 0, m - 1)
    pick = np.where(np.abs(mids[hi] - targets) < np.abs(mids[lo] - targets), hi, lo)
    keep = np.unique(np.concatenate([[0], pick, [m - 1]]))
    return tuple(arr[keep] for arr in summary)


def _value_at_rank(summary, ranks: np.ndarray) -> np.ndarray:
    """Summary value covering each (0-based) rank: the first entry whose
    inclusive upper rank bound exceeds the query. Exact order statistics
    for exact summaries; off by at most the summary's rank error otherwise."""
    vals, _, rmax, _ = summary
    idx = np.minimum(np.searchsorted(rmax, ranks, side="right"), vals.size - 1)
    return vals[idx]


class StreamingQuantileSketch:
    """Mergeable weighted quantile sketch over feature columns.

    Streams over host-resident chunks with `push(batch)` (NaN = missing,
    excluded), combines sketches built elsewhere with `merge(other)` —
    merge of exact summaries is exact, so merge order cannot change the
    result until pruning kicks in — and emits `compute_cuts`-shaped cut
    points with `get_cuts()`. Memory is bounded by O(capacity) entries per
    feature regardless of how many rows are pushed.
    """

    def __init__(self, n_features: int, max_bins: int = DEFAULT_MAX_BINS,
                 capacity: int = 1024):
        if n_features <= 0:
            raise ValueError(f"n_features must be positive, got {n_features}")
        if capacity < 8:
            raise ValueError(f"capacity must be >= 8, got {capacity}")
        self.n_features = n_features
        self.max_bins = max_bins
        self.capacity = capacity
        self.n_pushed = 0
        self._summaries = [_EMPTY_SUMMARY] * n_features

    def push(self, batch, weights=None) -> "StreamingQuantileSketch":
        """Fold one (chunk_rows, n_features) batch into the sketch."""
        x = np.asarray(batch, np.float32)
        if x.ndim != 2 or x.shape[1] != self.n_features:
            raise ValueError(
                f"batch must be (rows, {self.n_features}), got {x.shape}"
            )
        if weights is None:
            w = np.ones(x.shape[0], np.float64)
        else:
            w = np.asarray(weights, np.float64)
            if w.shape != (x.shape[0],):
                raise ValueError(
                    f"weights must be ({x.shape[0]},), got {w.shape}"
                )
        for j in range(self.n_features):
            col = x[:, j]
            finite = np.isfinite(col)
            if not finite.any():
                continue
            batch_summary = _exact_summary(col[finite], w[finite])
            self._summaries[j] = _prune_summary(
                _combine_summaries(self._summaries[j], batch_summary),
                self.capacity,
            )
        self.n_pushed += x.shape[0]
        return self

    def push_sorted(self, cols_sorted, n_valid) -> "StreamingQuantileSketch":
        """Fold pre-sorted unit-weight columns into the sketch.

        Args:
          cols_sorted: (rows, n_features) with every column ascending and
            non-finite entries (missing markers / +inf padding) sorted to
            the tail — exactly what `torch.sort` of a NaN->+inf-filled
            chunk produces.
          n_valid: (n_features,) count of finite entries per column.

        Equivalent to `push` on the unsorted data (same summaries), minus
        the host-side argsort.
        """
        x = np.asarray(cols_sorted, np.float32)
        if x.ndim != 2 or x.shape[1] != self.n_features:
            raise ValueError(
                f"cols_sorted must be (rows, {self.n_features}), got {x.shape}"
            )
        nv = np.asarray(n_valid, np.int64).reshape(-1)
        if nv.shape != (self.n_features,):
            raise ValueError(
                f"n_valid must be ({self.n_features},), got {nv.shape}"
            )
        for j in range(self.n_features):
            if nv[j] == 0:
                continue
            batch_summary = _exact_summary_presorted(x[: nv[j], j])
            self._summaries[j] = _prune_summary(
                _combine_summaries(self._summaries[j], batch_summary),
                self.capacity,
            )
        self.n_pushed += x.shape[0]
        return self

    def merge(self, other: "StreamingQuantileSketch") -> "StreamingQuantileSketch":
        """Fold another sketch into this one (distributed cut generation)."""
        if not isinstance(other, StreamingQuantileSketch):
            raise TypeError(f"cannot merge {type(other)}")
        if (other.n_features, other.max_bins) != (self.n_features, self.max_bins):
            raise ValueError(
                "sketches disagree on shape: "
                f"({self.n_features}, max_bins={self.max_bins}) vs "
                f"({other.n_features}, max_bins={other.max_bins})"
            )
        for j in range(self.n_features):
            self._summaries[j] = _prune_summary(
                _combine_summaries(self._summaries[j], other._summaries[j]),
                self.capacity,
            )
        self.n_pushed += other.n_pushed
        return self

    def n_valid(self, feature: int) -> float:
        """Total (weighted) finite mass seen for one feature."""
        s = self._summaries[feature]
        return float(s[2][-1]) if s[0].size else 0.0

    def get_cuts(self, device=None) -> torch.Tensor:
        """Cut points in `compute_cuts`' exact output format: (n_features,
        n_value_bins - 1) float32 ascending, +inf padding past the used
        prefix, duplicates collapsed, as a tensor on `device` (the card
        unless "cpu"). For exact (unpruned) summaries this reproduces
        compute_cuts' rank interpolation arithmetic in float32.
        """
        nvb = n_value_bins(self.max_bins)
        out = np.full((self.n_features, nvb - 1), np.inf, np.float32)
        for j in range(self.n_features):
            summary = self._summaries[j]
            if summary[0].size == 0:
                continue  # all-missing feature: every cut stays +inf
            total = summary[2][-1]
            # Mirror compute_cuts bit-for-bit (same f32 ops, same guards).
            qs = (
                np.arange(1, nvb, dtype=np.float32) / np.float32(nvb)
            ) * np.float32(max(total - 1.0, 1.0))
            lo = np.floor(qs).astype(np.int64)
            frac = qs - lo.astype(np.float32)
            hi = lo + 1
            lov = _value_at_rank(summary, lo.astype(np.float64))
            hiv = np.where(
                hi < total,
                _value_at_rank(summary, np.minimum(hi, total - 1)),
                lov,
            )
            cand = (lov + frac * (hiv - lov)).astype(np.float32)
            cand = np.where(np.isfinite(cand), cand, np.float32(np.inf))
            prev = np.concatenate([[np.float32(-np.inf)], cand[:-1]])
            cand = np.where(cand > prev, cand, np.float32(np.inf))
            out[j] = np.sort(cand)
        return torch.from_numpy(out).to(resolve_device(device))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        sizes = [s[0].size for s in self._summaries]
        return (
            f"StreamingQuantileSketch({self.n_features} features, "
            f"{self.n_pushed} rows pushed, capacity={self.capacity}, "
            f"max summary={max(sizes) if sizes else 0})"
        )
