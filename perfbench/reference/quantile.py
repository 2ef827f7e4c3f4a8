"""Cut points and bins, worked out again from the raw features.

The rule is the paper's exact quantile sketch as the system states it
(`max_bins` bins a feature, the last one reserved for missing values, the
`max_bins - 1` value bins of equal mass), with its float32 arithmetic:
over each column sorted ascending with missing values as a +inf tail and n
finite values, candidate k (k = 1 .. nvb - 1, nvb = max_bins - 1) sits at
q = (k / nvb) * (n - 1), interpolated between the sorted values at floor(q)
and floor(q) + 1; a candidate not above its predecessor is dropped (+inf)
and the cuts are sorted ascending. A value x falls in the bin given by the
number of cuts strictly below it; a missing value in bin max_bins - 1.

`dtype` rounds the features to a lower precision first (the control).
"""
from __future__ import annotations

import torch


def cuts(x: torch.Tensor, max_bins: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(F, max_bins - 2) float32 cuts, ascending, +inf tail."""
    n, n_features = x.shape
    nvb = max_bins - 1
    dev = x.device
    ranks = torch.arange(1, nvb, dtype=torch.float32, device=dev)
    # True division by a tensor on the same device: torch multiplies by
    # the reciprocal when the divisor is a Python or host scalar.
    frac_of = ranks / torch.full_like(ranks, float(nvb))
    out = torch.empty((n_features, nvb - 1), dtype=torch.float32, device=dev)
    for f in range(n_features):  # one column at a time: no (n, F) sort indices
        col = x[:, f].to(dtype).to(torch.float32)
        finite = torch.isfinite(col)
        srt = torch.sort(torch.where(finite, col, float("inf"))).values
        nv = int(finite.sum())
        qs = frac_of * torch.tensor(float(max(nv - 1, 1)), dtype=torch.float32, device=dev)
        lo = torch.clamp(torch.floor(qs).to(torch.int64), 0, n - 1)
        hi = torch.clamp(lo + 1, 0, n - 1)
        frac = qs - lo.to(torch.float32)
        lov, hiv = srt[lo], srt[hi]
        hiv = torch.where(torch.isfinite(hiv), hiv, lov)
        cand = lov + frac * (hiv - lov)
        cand = torch.where(torch.isfinite(cand), cand, float("inf"))
        prev = torch.cat([torch.full_like(cand[:1], float("-inf")), cand[:-1]])
        out[f] = torch.sort(torch.where(cand > prev, cand, float("inf"))).values
    return out.to(dtype).to(torch.float32)


def quantize(x: torch.Tensor, cut: torch.Tensor, max_bins: int,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(F, n) feature-major bins: uint8 up to 256 bins, else int16."""
    store = torch.uint8 if max_bins <= 256 else torch.int16
    n, n_features = x.shape
    out = torch.empty((n_features, n), dtype=store, device=x.device)
    for f in range(n_features):
        col = x[:, f].to(dtype).to(torch.float32).contiguous()
        b = torch.searchsorted(cut[f].contiguous(), col, side="left")
        out[f] = torch.where(torch.isnan(col), max_bins - 1, b).to(store)
    return out
