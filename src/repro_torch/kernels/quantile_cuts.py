"""Wrapper of the cut-selection CUDA kernel (`csrc/quantile_cuts.cu`).

Counterpart of `repro.kernels.quantile_cuts.quantile_cuts_from_sorted`. It
returns the PRE-SORT candidate cuts; `ops.compute_cuts_op` re-sorts them
with `torch.sort`, as the reference's caller does. No row cap.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as B


def quantile_cuts_from_sorted(
    srt: torch.Tensor,  # (n, F) f32 column-sorted, +inf tail
    n_valid: torch.Tensor,  # (F,) finite count per column
    max_bins: int,
) -> torch.Tensor:
    """(F, max_bins - 2) f32 candidates, bit-identical to `ref.quantile_cuts_ref`."""
    B.expect(srt, "srt", torch.float32, 2)
    n_valid = n_valid.to(torch.int32).contiguous()
    B.expect(n_valid, "n_valid", torch.int32, 1)
    n, f = srt.shape
    if n_valid.shape[0] != f:
        raise ValueError(f"n_valid has {n_valid.shape[0]} entries for {f} features")
    if max_bins < 3:
        raise ValueError(f"max_bins must be >= 3, got {max_bins}")
    if n == 0 or f == 0:
        raise ValueError(f"srt must be non-empty, got shape {tuple(srt.shape)}")
    dev = srt.device
    out = torch.empty((f, max_bins - 2), dtype=torch.float32, device=dev)
    err = B.lib().rt_quantile_cuts(
        srt.data_ptr(), n_valid.data_ptr(), out.data_ptr(), n, f, max_bins,
        B.stream(dev),
    )
    B.check(err, "quantile_cuts")
    quantile_cuts_from_sorted.launches += 1
    return out


quantile_cuts_from_sorted.launches = 0
