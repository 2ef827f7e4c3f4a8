"""Wrapper of the ensemble-traversal CUDA kernel (`csrc/ensemble_traversal.cu`).

Counterpart of `repro.kernels.ensemble_traversal.ensemble_margins_kernel`:
raw rows (NaN = missing) through all trees, margins (N, K) without
base_score, tree t feeding class t % K.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as B

THREADS = 256  # rows per block
SMEM_TARGET = 48 * 1024  # shared memory a block aims for
NODE_BYTES = 14  # feature i32 + threshold f32 + leaf f32 + two u8 flags


def trees_per_block(n_trees: int, arena: int, n_classes: int, smem_bytes: int) -> int:
    """How many tree arenas a block stages at once beside its per-class
    accumulators (n_classes x THREADS floats)."""
    acc = n_classes * THREADS * 4
    if acc + arena * NODE_BYTES > smem_bytes:
        raise ValueError(
            f"{n_classes} classes with a {arena}-node arena need more than the "
            f"{smem_bytes} B of shared memory a block may use"
        )
    fit = max(1, (max(SMEM_TARGET, acc + arena * NODE_BYTES) - acc) // (arena * NODE_BYTES))
    return min(n_trees, fit)


def ensemble_margins_kernel(
    feature: torch.Tensor,  # (T, A) int
    threshold: torch.Tensor,  # (T, A) f32
    default_left: torch.Tensor,  # (T, A) bool
    leaf_value: torch.Tensor,  # (T, A) f32
    is_leaf: torch.Tensor,  # (T, A) bool
    x: torch.Tensor,  # (N, F) f32, NaN = missing
    n_classes: int,
    max_depth: int,
) -> torch.Tensor:
    """Margins (N, n_classes) f32, bit-identical to `ref.ensemble_margins_ref`."""
    feature = feature.to(torch.int32).contiguous()
    default_left = default_left.to(torch.uint8).contiguous()
    is_leaf = is_leaf.to(torch.uint8).contiguous()
    for t, name, dtype in ((feature, "feature", torch.int32),
                           (threshold, "threshold", torch.float32),
                           (default_left, "default_left", torch.uint8),
                           (leaf_value, "leaf_value", torch.float32),
                           (is_leaf, "is_leaf", torch.uint8)):
        B.expect(t, name, dtype, 2)
        if t.shape != feature.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, feature "
                             f"{tuple(feature.shape)}")
    B.expect(x, "x", torch.float32, 2)
    n_trees, arena = feature.shape
    n_rows, n_features = x.shape
    if n_trees % n_classes:
        raise ValueError(f"{n_trees} trees do not fill rounds of {n_classes} classes")
    dev = x.device
    out = torch.empty((n_rows, n_classes), dtype=torch.float32, device=dev)
    if n_rows == 0:
        return out
    tb = trees_per_block(n_trees, arena, n_classes, B.device_limits(dev.index)[1])
    err = B.lib().rt_ensemble_margins(
        feature.data_ptr(), threshold.data_ptr(), default_left.data_ptr(),
        leaf_value.data_ptr(), is_leaf.data_ptr(), x.data_ptr(), out.data_ptr(),
        n_trees, arena, n_rows, n_features, n_classes, max_depth, tb, THREADS,
        B.stream(dev),
    )
    B.check(err, "ensemble_margins")
    ensemble_margins_kernel.launches += 1
    return out


ensemble_margins_kernel.launches = 0
