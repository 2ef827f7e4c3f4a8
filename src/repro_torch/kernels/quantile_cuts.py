"""Wrapper of the cut-selection CUDA kernel (`csrc/quantile_cuts.cu`).

Counterpart of `repro.kernels.quantile_cuts.quantile_cuts_from_sorted`: the
ascending cuts with a +inf tail, in one launch (the kernel compacts the
deduplicated candidates in order instead of sorting them). No row cap.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as B


def quantile_cuts_from_sorted(
    srt: torch.Tensor,  # (n, F) f32 column-sorted, +inf tail
    n_valid: torch.Tensor,  # (F,) finite count per column
    max_bins: int,
) -> torch.Tensor:
    """(F, max_bins - 2) f32 ascending cuts, +inf tail, bit-identical to
    `ref.quantile_cuts_ref`."""
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
    B.launch("rt_quantile_cuts", dev,
             srt.data_ptr(), n_valid.data_ptr(), out.data_ptr(), n, f, max_bins)
    B.count(quantile_cuts_from_sorted)
    return out


quantile_cuts_from_sorted.launches = 0
