"""Wrapper of the ensemble-traversal CUDA kernel (`csrc/ensemble_traversal.cu`).

Counterpart of `repro.kernels.ensemble_traversal.ensemble_margins_kernel`:
raw rows (NaN = missing) through all trees, margins (N, K) without
base_score, tree t feeding class t % K. It serves every model the reference
serves: the plan below picks, from the card's shared memory, how many
classes a block accumulates and whether it stages the tree arenas or reads
them from global memory.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build as B

THREADS = 256  # rows per block
SMEM_TARGET = 48 * 1024  # shared memory a block aims for
NODE_BYTES = 14  # feature i32 + threshold f32 + leaf f32 + two u8 flags


class TraversalPlan(NamedTuple):
    class_tile: int  # classes a block accumulates (grid y = ceil(K / class_tile))
    trees_blk: int  # tree arenas a block stages at once; 0 = read from global memory


def traversal_plan(n_trees: int, arena: int, n_classes: int,
                   smem_bytes: int) -> TraversalPlan:
    """Per-class accumulators (class_tile x THREADS floats) and staged arenas
    share a block's `smem_bytes`. All classes take one block while their
    accumulators fit beside one arena; otherwise the classes are tiled over
    the grid, at most SMEM_TARGET of accumulators a block. Arenas are staged
    while they fit beside the accumulators, else read through L2."""
    acc_row = THREADS * 4
    tree = arena * NODE_BYTES
    tile = n_classes
    if n_classes * acc_row + tree > smem_bytes:
        tiles = math.ceil(n_classes / max(1, SMEM_TARGET // acc_row))
        tile = math.ceil(n_classes / tiles)
    acc = tile * acc_row
    if acc + tree > smem_bytes:
        return TraversalPlan(tile, 0)
    fit = max(1, (max(SMEM_TARGET, acc + tree) - acc) // tree)
    return TraversalPlan(tile, min(n_trees // n_classes * tile, fit))


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
    plan = traversal_plan(n_trees, arena, n_classes,
                          B.device_limits(dev.index).smem_block)
    err = B.lib().rt_ensemble_margins(
        feature.data_ptr(), threshold.data_ptr(), default_left.data_ptr(),
        leaf_value.data_ptr(), is_leaf.data_ptr(), x.data_ptr(), out.data_ptr(),
        n_trees, arena, n_rows, n_features, n_classes, max_depth, *plan, THREADS,
        B.stream(dev),
    )
    B.check(err, "ensemble_margins")
    ensemble_margins_kernel.launches += 1
    return out


ensemble_margins_kernel.launches = 0
