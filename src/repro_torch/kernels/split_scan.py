"""Wrapper of the split-scan CUDA kernel (`csrc/split_scan.cu`).

Counterpart of `repro.kernels.split_scan.split_scan`, with a fifth output
field: per (node, feature) [gain, bin, default_left, gl, hl], so the caller
forms the left child's (G, H) without another pass. gamma and the argmax
across features are left to the caller (`core/split.py`). A feature mask
and monotone constraints with per-node bounds (the reference's
`core/split.py::evaluate_splits` inputs) ride in the same launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as B

MAX_BINS_LIMIT = 1025  # a warp's stage of 1024 value bins: 8 KB of shared memory


def split_scan(
    hist: torch.Tensor,  # (n_nodes, F, B, 2) f32
    parent_sum: torch.Tensor,  # (n_nodes, 2) f32
    reg_lambda: float = 1.0,
    min_child_weight: float = 1.0,
    feature_mask: torch.Tensor | None = None,  # (F,) or (n_nodes, F) bool or uint8
    monotone: torch.Tensor | None = None,  # (F,) int in {-1, 0, +1}
    node_bounds: torch.Tensor | None = None,  # (n_nodes, 2) f32 [lower, upper]
) -> torch.Tensor:
    """Returns (n_nodes, F, 5) f32, bit-identical to `ref.split_scan_ref`.
    A masked-out (node, feature) gives [-inf, 0, 0, 0, 0]; `monotone` needs
    `node_bounds`."""
    B.expect(hist, "hist", torch.float32, 4)
    B.expect(parent_sum, "parent_sum", torch.float32, 2)
    n_nodes, f, max_bins, two = hist.shape
    if two != 2 or tuple(parent_sum.shape) != (n_nodes, 2):
        raise ValueError(f"hist must be (n, F, B, 2) and parent_sum (n, 2), got "
                         f"{tuple(hist.shape)} and {tuple(parent_sum.shape)}")
    if not 3 <= max_bins <= MAX_BINS_LIMIT:
        raise ValueError(f"split_scan takes 3 <= max_bins <= {MAX_BINS_LIMIT}, "
                         f"got {max_bins}")
    if (monotone is None) != (node_bounds is None):
        raise ValueError("monotone and node_bounds go together")
    dev = hist.device
    mask_ptr = mono_ptr = bounds_ptr = 0
    if feature_mask is not None:
        if feature_mask.shape not in ((f,), (n_nodes, f)):
            raise ValueError(f"feature_mask must be ({f},) or ({n_nodes}, {f}), got "
                             f"{tuple(feature_mask.shape)}")
        feature_mask = feature_mask.to(torch.uint8).expand(n_nodes, f).contiguous()
        B.expect(feature_mask, "feature_mask", torch.uint8, 2)
        mask_ptr = feature_mask.data_ptr()
    if monotone is not None:
        monotone = monotone.to(torch.int8).contiguous()
        B.expect(monotone, "monotone", torch.int8, 1)
        B.expect(node_bounds, "node_bounds", torch.float32, 2)
        if monotone.shape != (f,) or node_bounds.shape != (n_nodes, 2):
            raise ValueError(f"monotone must be ({f},) and node_bounds ({n_nodes}, 2), "
                             f"got {tuple(monotone.shape)} and {tuple(node_bounds.shape)}")
        mono_ptr, bounds_ptr = monotone.data_ptr(), node_bounds.data_ptr()
    out = torch.empty((n_nodes, f, 5), dtype=torch.float32, device=dev)
    if n_nodes == 0 or f == 0:
        return out
    if hist.data_ptr() % 8:  # the kernel reads each (g, h) as one float2
        hist = hist.clone()
    err = B.lib().rt_split_scan(
        hist.data_ptr(), parent_sum.data_ptr(), out.data_ptr(), mask_ptr, mono_ptr,
        bounds_ptr, n_nodes, f, max_bins, float(reg_lambda), float(min_child_weight),
        B.stream(dev),
    )
    B.check(err, "split_scan")
    split_scan.launches += 1
    return out


split_scan.launches = 0
