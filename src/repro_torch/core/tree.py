"""Decision tree construction (paper §2.3, Algorithm 1); counterpart of
`repro.core.tree` for depthwise, single-device growth on the packed matrix.

The tree grows level-synchronously into a fixed arena of 2^(max_depth+1) - 1
node slots. Every level: one histogram over all its nodes, built straight
from the packed words (the histogram kernel on the card), split evaluation
(the split-scan kernel plus a small epilogue), then row repartition.

Every level is built in full, as the reference does on its kernel path
(`repro/core/tree.py` turns subtraction off when a `hist_builder` is given).
The subtraction trick, lossguide growth, sampling and constraints are not
ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import compress as C
from repro_torch.core import histogram as H
from repro_torch.core import partition as P
from repro_torch.core import split as S


class Tree(NamedTuple):
    """Array-form tree arena (all tensors of length 2^(max_depth+1) - 1)."""

    feature: torch.Tensor  # int32
    split_bin: torch.Tensor  # int32 (bin-space threshold: bin <= split_bin -> left)
    threshold: torch.Tensor  # float32 (raw-space threshold: x <= threshold -> left)
    default_left: torch.Tensor  # bool
    leaf_value: torch.Tensor  # float32
    is_leaf: torch.Tensor  # bool
    gain: torch.Tensor  # float32 (split gain; -inf on leaves and unused slots)

    @property
    def n_arena(self) -> int:
        return self.feature.shape[0]


def arena_size(max_depth: int) -> int:
    return 2 ** (max_depth + 1) - 1


def level_offset(level: int) -> int:
    return 2**level - 1


def grow_tree(
    bins: C.PackedBins,
    gh: torch.Tensor,  # (n, 2) float32
    cuts: torch.Tensor,  # (f, n_cuts) float32
    max_depth: int,
    max_bins: int,
    params: S.SplitParams = S.SplitParams(),
    growth: str = "depthwise",
) -> Tree:
    """Grow one tree from the packed matrix and the rows' (g, h) pairs."""
    if growth != "depthwise":
        raise NotImplementedError(f"growth={growth!r} is not ported yet")
    if not isinstance(bins, C.PackedBins):
        raise TypeError("grow_tree takes the packed matrix (compress.PackedBins)")
    dev = gh.device
    n = bins.n_rows
    na = arena_size(max_depth)
    missing_bin = max_bins - 1

    feature = torch.zeros(na, dtype=torch.int32, device=dev)
    split_bin = torch.zeros(na, dtype=torch.int32, device=dev)
    default_left = torch.zeros(na, dtype=torch.bool, device=dev)
    leaf_value = torch.zeros(na, dtype=torch.float32, device=dev)
    is_leaf = torch.zeros(na, dtype=torch.bool, device=dev)
    gain = torch.full((na,), float("-inf"), dtype=torch.float32, device=dev)
    node_sum = torch.zeros((na, 2), dtype=torch.float32, device=dev)
    active = torch.zeros(na, dtype=torch.bool, device=dev)

    positions = torch.zeros(n, dtype=torch.int32, device=dev)  # all at the root
    node_sum[0] = gh.sum(dim=0)
    active[0] = True

    for level in range(max_depth):
        off, n_nodes = level_offset(level), 2**level
        lvl = slice(off, off + n_nodes)

        # --- BuildPartialHistograms ---------------------------------------
        in_level = (positions >= off) & (positions < off + n_nodes)
        local = torch.where(in_level, positions - off, n_nodes).to(torch.int32)
        hist = H.build_histograms_packed(bins.packed, gh, local, n_nodes,
                                         max_bins, bins.bits)

        # --- EvaluateSplit --------------------------------------------------
        parent = node_sum[lvl]
        sp = S.evaluate_splits(hist, parent, params)
        lvl_active = active[lvl]
        will_split = lvl_active & (sp.gain > 0.0) & torch.isfinite(sp.gain)
        stays_leaf = lvl_active & ~will_split

        feature[lvl] = torch.where(will_split, sp.feature, 0)
        split_bin[lvl] = torch.where(will_split, sp.split_bin, 0)
        default_left[lvl] = will_split & sp.default_left
        gain[lvl] = torch.where(will_split, sp.gain, float("-inf"))
        is_leaf[lvl] = stays_leaf
        leaf_value[lvl] = torch.where(
            stays_leaf, S.leaf_value(parent, params.reg_lambda), 0.0)

        # Children's sums come from the split evaluation (no extra pass).
        kids = slice(2 * off + 1, 2 * (off + n_nodes) + 1)
        node_sum[kids] = torch.where(
            will_split[:, None, None],
            torch.stack([sp.left_sum, sp.right_sum], dim=1), 0.0,
        ).reshape(-1, 2)
        active[kids] = will_split.repeat_interleave(2)

        # --- RepartitionInstances ------------------------------------------
        split_mask = torch.zeros(na, dtype=torch.bool, device=dev)
        split_mask[lvl] = will_split
        positions = P.update_positions_packed(
            bins.packed, positions, split_mask, feature, split_bin,
            default_left, missing_bin, bins.bits,
        )

    # Final level: every still-active node is a leaf.
    off, n_nodes = level_offset(max_depth), 2**max_depth
    lvl = slice(off, off + n_nodes)
    is_leaf[lvl] = active[lvl]
    leaf_value[lvl] = torch.where(
        active[lvl], S.leaf_value(node_sum[lvl], params.reg_lambda), 0.0)

    # Raw-space thresholds for prediction on unquantised rows.
    col = torch.clamp(split_bin, 0, cuts.shape[1] - 1).to(torch.int64)
    threshold = cuts[feature.to(torch.int64), col]
    threshold = torch.where(is_leaf, float("inf"), threshold)
    return Tree(feature, split_bin, threshold, default_left, leaf_value,
                is_leaf, gain)
