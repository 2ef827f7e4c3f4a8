"""Decision tree construction (paper §2.3, Algorithm 1); counterpart of
`repro.core.tree` for single-device growth on the packed matrix.

The tree grows level-synchronously into a fixed arena of 2^(max_depth+1) - 1
node slots. Every level: one histogram over all its nodes, built straight
from the packed words, split evaluation (the split-scan kernel plus a small
epilogue), then row repartition.

Histograms, as in the reference: the root level is built in full (the
privatised histogram kernel on the card); below it the subtraction trick
builds only each parent's smaller child, over a compacted row buffer (the
row-id histogram kernel), and derives the sibling as parent - child. A
given `hist_builder` turns subtraction off and builds every level in full.

Growth strategies: "depthwise" expands every node whose best gain > 0;
"lossguide" spends a `max_leaves` budget, letting only the top-k gains of
each level split, k = the budget left. Sampling and constraints are not
ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import compress as C
from repro_torch.core import histogram as H
from repro_torch.core import partition as P
from repro_torch.core import split as S

# Counters and dump slots of the subtraction trick's compaction are spread
# over this many lanes, so that rows do not all hit one address on the card.
SPREAD_LANES = 1024


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
    max_leaves: int = 0,  # only used by lossguide
    hist_builder=None,  # optional builder (kernels.ops), every level in full
) -> Tree:
    """Grow one tree from the packed matrix and the rows' (g, h) pairs.
    `hist_builder(bins, gh, positions, n_nodes, max_bins)` receives the
    packed matrix as given."""
    if growth not in ("depthwise", "lossguide"):
        raise ValueError(f"growth must be 'depthwise' or 'lossguide', got {growth!r}")
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
    # lossguide leaf budget: a tree starts as 1 leaf; each split adds 1.
    budget = torch.tensor(max(max_leaves - 1, 0) if growth == "lossguide" else na,
                          device=dev)

    hist_prev = None

    for level in range(max_depth):
        off, n_nodes = level_offset(level), 2**level
        lvl = slice(off, off + n_nodes)

        # --- BuildPartialHistograms ---------------------------------------
        in_level = (positions >= off) & (positions < off + n_nodes)
        local = torch.where(in_level, positions - off, n_nodes).to(torch.int32)
        if hist_builder is not None:
            hist = hist_builder(bins, gh, local, n_nodes, max_bins)
        elif level == 0:
            hist = H.build_histograms_packed(bins.packed, gh, local, n_nodes,
                                             max_bins, bins.bits)
        else:
            hist = _histograms_by_subtraction(bins, gh, local, hist_prev,
                                              n_nodes, max_bins)
        hist_prev = hist

        # --- EvaluateSplit --------------------------------------------------
        parent = node_sum[lvl]
        sp = S.evaluate_splits(hist, parent, params)
        lvl_active = active[lvl]
        will_split = lvl_active & (sp.gain > 0.0) & torch.isfinite(sp.gain)

        if growth == "lossguide":
            # Keep only the top-`budget` gains among would-be splits. A stable
            # sort, as jnp.argsort is: equal gains rank in node order.
            g = torch.where(will_split, sp.gain, float("-inf"))
            order = torch.argsort(-g, stable=True)  # descending
            rank = torch.empty_like(order).scatter_(
                0, order, torch.arange(n_nodes, device=dev))
            will_split = will_split & (rank < budget)
            budget = budget - will_split.sum()

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


def _histograms_by_subtraction(
    bins: C.PackedBins,
    gh: torch.Tensor,  # (n, 2)
    local: torch.Tensor,  # (n,) int32 level-local child index, n_nodes = inactive
    hist_prev: torch.Tensor,  # (n_nodes/2, f, max_bins, 2) parents' full hist
    n_nodes: int,
    max_bins: int,
) -> torch.Tensor:
    """Level histogram via the subtraction trick (`repro/core/tree.py`,
    DESIGN.md §7.5).

    Per parent, only the smaller child (by instance count) is histogrammed;
    its sibling is parent - child. Since sum_p min(left_p, right_p) <=
    floor(n/2), a fixed n//2 compaction buffer always suffices. Every step
    has a size known from the shapes, so no level waits on the device.
    """
    n = gh.shape[0]
    dev = gh.device
    n_par = n_nodes // 2
    m = n // 2
    local64 = local.to(torch.int64)
    row = torch.arange(n, device=dev)
    lane = row & (SPREAD_LANES - 1)

    # Instance counts per child -> smaller-child bit per parent (ties: left).
    # Each child counts into SPREAD_LANES lanes, summed after: one counter
    # per child would serialise every row's atomic add on the card, and
    # bincount's data-dependent size would cost a host sync.
    ones = torch.ones((), dtype=torch.int64, device=dev).expand(n)
    cnt = torch.zeros((n_nodes + 1) * SPREAD_LANES, dtype=torch.int64, device=dev)
    cnt = cnt.index_add_(0, local64 * SPREAD_LANES + lane, ones)
    cnt = cnt.view(n_nodes + 1, SPREAD_LANES).sum(dim=1)
    small_bit = (cnt[1:n_nodes:2] < cnt[0:n_nodes:2]).to(torch.int64)

    is_active = local64 < n_nodes
    par = torch.clamp(local64 >> 1, max=n_par - 1)
    sel = is_active & ((local64 & 1) == small_bit[par])

    # Compact selected row ids into the n//2 buffer (sentinel n = padding):
    # each selected row goes to its rank among the selected, every other row
    # to one of SPREAD_LANES slots past the buffer, which are dropped.
    order = torch.cumsum(sel, dim=0) - 1
    buf = torch.full((m + SPREAD_LANES,), n, dtype=torch.int64, device=dev)
    buf = buf.scatter_(0, torch.where(sel, order, m + lane), row)[:m]
    parent_ext = torch.cat([
        torch.where(sel, par, n_par),
        torch.full((1,), n_par, dtype=torch.int64, device=dev),
    ])
    pos_c = parent_ext[torch.clamp(buf, max=n)]
    gh_c = gh[torch.clamp(buf, max=n - 1)]
    # Padding slots carry row id n; their position is the dump slot, so
    # they contribute nothing and their rows are not read.
    hist_small = H.build_histograms_packed_rows(
        bins.packed, gh_c, pos_c, buf, n_par, max_bins, bins.bits)

    other = hist_prev - hist_small
    built_left = (small_bit == 0)[:, None, None, None]
    left = torch.where(built_left, hist_small, other)
    right = torch.where(built_left, other, hist_small)
    f = hist_prev.shape[1]
    return torch.stack([left, right], dim=1).reshape(n_nodes, f, max_bins, 2)
