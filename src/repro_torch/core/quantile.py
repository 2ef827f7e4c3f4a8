"""Feature quantile generation (paper §2.1); counterpart of `repro.core.quantile`.

Exact sort-based quantiles (`kernels.ops.compute_cuts_op`): the columns are
sorted with `torch.sort` (NaN filled with +inf so it sorts to the tail),
then the selection stage picks the interior boundaries of `n_value_bins`
equal-mass bins. On a CUDA tensor the selection runs in the cut-selection
kernel (`kernels/csrc/quantile_cuts.cu`), on a CPU tensor in its plain
version, bit-identical to it. Missing values (NaN) take the reserved last
bin.

The streaming sketch of the reference (external memory) is not ported yet.
"""
from __future__ import annotations

import torch

# Reserved: the last bin id of every feature is the "missing" bin. With
# max_bins=256 there are 255 value bins + 1 missing bin: 8-bit symbols.
DEFAULT_MAX_BINS = 256


def n_value_bins(max_bins: int = DEFAULT_MAX_BINS) -> int:
    return max_bins - 1


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
