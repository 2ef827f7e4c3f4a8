"""Wrapper of the split-scan CUDA kernel (`csrc/split_scan.cu`).

Counterpart of `repro.kernels.split_scan.split_scan`, with a fifth output
field: per (node, feature) [gain, bin, default_left, gl, hl], so the caller
forms the left child's (G, H) without another pass. gamma and the argmax
across features are left to the caller (`core/split.py`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as B

MAX_BINS_LIMIT = 1025  # one thread per value bin, at most 1024 per block


def split_scan(
    hist: torch.Tensor,  # (n_nodes, F, B, 2) f32
    parent_sum: torch.Tensor,  # (n_nodes, 2) f32
    reg_lambda: float = 1.0,
    min_child_weight: float = 1.0,
) -> torch.Tensor:
    """Returns (n_nodes, F, 5) f32, bit-identical to `ref.split_scan_ref`."""
    B.expect(hist, "hist", torch.float32, 4)
    B.expect(parent_sum, "parent_sum", torch.float32, 2)
    n_nodes, f, max_bins, two = hist.shape
    if two != 2 or tuple(parent_sum.shape) != (n_nodes, 2):
        raise ValueError(f"hist must be (n, F, B, 2) and parent_sum (n, 2), got "
                         f"{tuple(hist.shape)} and {tuple(parent_sum.shape)}")
    if not 3 <= max_bins <= MAX_BINS_LIMIT:
        raise ValueError(f"split_scan takes 3 <= max_bins <= {MAX_BINS_LIMIT}, "
                         f"got {max_bins}")
    dev = hist.device
    out = torch.empty((n_nodes, f, 5), dtype=torch.float32, device=dev)
    if n_nodes == 0 or f == 0:
        return out
    err = B.lib().rt_split_scan(
        hist.data_ptr(), parent_sum.data_ptr(), out.data_ptr(), n_nodes, f,
        max_bins, float(reg_lambda), float(min_child_weight), B.stream(dev),
    )
    B.check(err, "split_scan")
    split_scan.launches += 1
    return out


split_scan.launches = 0
