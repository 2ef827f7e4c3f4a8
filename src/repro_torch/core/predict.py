"""Ensemble arena and bin-space prediction (paper §2.4); counterpart of
`repro.core.predict`.

`traverse_trees_on` (any bins type's `traverse`: the flat words, the
external-memory chunk stack, or the streamed stack a chunk at a time) and
`traverse_tree_binned` (dense bins, `compress_matrix=False`) are the
training margin update: trees in bin space, all rows one level per step
(plain torch gathers; the reference runs them in XLA too), sharing one
walk (`_traverse`). Bin-space margins
add each class's trees in tree order (`fold_classes`, `_sum_trees`), so a
row's margin is the same whichever rows share the call.
Raw-row prediction (`predict_raw`, and `serve/traversal.py`) goes through
the ensemble-traversal kernel. `concat_ensembles`, `truncate_rounds` and
`slice_rounds` cut and join models round by round, their packed nodes with
them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import compress as C
from repro_torch.core.tree import Tree
from repro_torch.kernels.ensemble_traversal import pack_nodes

ENSEMBLE_FIELDS = ("feature", "split_bin", "threshold", "default_left",
                   "leaf_value", "is_leaf", "gain")


@dataclasses.dataclass(frozen=True)
class Ensemble:
    """Stacked tree arenas, leading axis n_trees. Multiclass trees are laid
    out round-robin: tree t predicts class t % n_classes. `nodes` is the
    arenas packed for raw-row prediction (`pack_nodes`), once, when the
    Ensemble is built without them; a cut or joined model slices or joins
    them along with the other fields (`_map_trees`)."""

    feature: torch.Tensor  # (t, a) int32
    split_bin: torch.Tensor  # (t, a) int32
    threshold: torch.Tensor  # (t, a) float32
    default_left: torch.Tensor  # (t, a) bool
    leaf_value: torch.Tensor  # (t, a) float32
    is_leaf: torch.Tensor  # (t, a) bool
    gain: torch.Tensor  # (t, a) float32, -inf = not a split
    n_classes: int = 1
    base_score: float = 0.0
    nodes: torch.Tensor | None = dataclasses.field(default=None, repr=False)  # (t, a + a % 2, 2) int32

    def __post_init__(self):
        if self.nodes is None:
            object.__setattr__(self, "nodes", pack_nodes(
                self.feature, self.threshold, self.default_left, self.leaf_value,
                self.is_leaf))

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]


def stack_trees(trees: list[Tree], n_classes: int = 1, base_score: float = 0.0,
                leaf_scale: float = 1.0) -> Ensemble:
    """Stack tree arenas into an Ensemble; `leaf_scale` bakes the learning
    rate into the stored leaf values."""
    st = {f: torch.stack([getattr(t, f) for t in trees]) for f in ENSEMBLE_FIELDS}
    st["leaf_value"] = st["leaf_value"] * leaf_scale
    return Ensemble(**st, n_classes=n_classes, base_score=base_score)


def _map_trees(fn, *ens: Ensemble) -> Ensemble:
    """An Ensemble whose every per-tree field, `nodes` too, is `fn` of the
    same field of each of `ens`; the metadata is the first's."""
    return dataclasses.replace(
        ens[0], **{f: fn(*(getattr(e, f) for e in ens)) for f in (*ENSEMBLE_FIELDS, "nodes")})


def concat_ensembles(a: Ensemble, b: Ensemble) -> Ensemble:
    """Append b's trees after a's (continued training). Static metadata must
    agree — the two halves describe one model."""
    if a.n_classes != b.n_classes or a.base_score != b.base_score:
        raise ValueError("cannot concatenate ensembles with different metadata")
    if a.feature.shape[1] != b.feature.shape[1]:
        raise ValueError("cannot concatenate ensembles with different arenas")
    return _map_trees(lambda x, y: torch.cat([x, y], dim=0), a, b)


def truncate_rounds(ens: Ensemble, n_rounds: int) -> Ensemble:
    """Keep only the first n_rounds boosting rounds (n_rounds * n_classes
    trees, round-robin layout) — used by early stopping."""
    keep = n_rounds * ens.n_classes
    return _map_trees(lambda x: x[:keep], ens)


def slice_rounds(ens: Ensemble, start: int, end: int) -> Ensemble:
    """Keep boosting rounds [start, end) — XGBoost `iteration_range`
    semantics (end=0 means "through the last round"). base_score is part of
    the model, not of any round, so it survives the slice unchanged."""
    n_rounds = ens.n_trees // ens.n_classes
    if end == 0:
        end = n_rounds
    if not (0 <= start < end <= n_rounds):
        raise ValueError(
            f"iteration_range ({start}, {end}) out of range for a model "
            f"with {n_rounds} rounds"
        )
    lo, hi = start * ens.n_classes, end * ens.n_classes
    return _map_trees(lambda x: x[lo:hi], ens)


def _traverse(feature, split_bin, default_left, leaf_value, is_leaf, n_rows: int,
              missing_bin: int, max_depth: int, bins_of) -> torch.Tensor:
    """Leaf outputs (t, n_rows) of t tree arenas (t, a), all rows one level
    per step; `bins_of(f)` gives each (tree, row)'s bin of feature f (t, n_rows)."""
    node = torch.zeros((feature.shape[0], n_rows), dtype=torch.int64, device=feature.device)
    for _ in range(max_depth):
        b = bins_of(torch.gather(feature, 1, node).to(torch.int64))
        go_left = torch.where(b == missing_bin, torch.gather(default_left, 1, node),
                              b <= torch.gather(split_bin, 1, node))
        child = torch.where(go_left, 2 * node + 1, 2 * node + 2)
        node = torch.where(torch.gather(is_leaf, 1, node), node, child)
    return torch.gather(leaf_value, 1, node)


def traverse_tree_binned(
    feature, split_bin, default_left, leaf_value, is_leaf,
    bins: torch.Tensor, missing_bin: int, max_depth: int,
) -> torch.Tensor:
    """Leaf outputs (n_rows,) of ONE tree arena over dense (n_rows, f) bins:
    per level one gather of each row's split-feature column."""
    row = torch.arange(bins.shape[0], device=bins.device)
    return _traverse(*(a[None] for a in (feature, split_bin, default_left, leaf_value, is_leaf)),
                     bins.shape[0], missing_bin, max_depth, lambda f: bins[row, f])[0]


def traverse_trees_on(
    bins,
    feature, split_bin, default_left, leaf_value, is_leaf,
    missing_bin: int, max_depth: int,
) -> torch.Tensor:
    """Leaf outputs (t, n_rows) of t tree arenas (t, a) over a bins type
    (`compress.PackedBins`, `compress.ChunkedPackedBins`,
    `stream.StreamedChunkedBins`): `bins.traverse`, per level one word
    gather per (tree, row) plus a shift/mask; the dense bins never exist.
    The walk is elementwise per row, so on the chunk stack, resident or
    streamed, the leaves are the flat walk's."""
    return bins.traverse(feature, split_bin, default_left, leaf_value, is_leaf,
                         missing_bin, max_depth)


def traverse_trees_packed(
    feature, split_bin, default_left, leaf_value, is_leaf,
    packed: torch.Tensor, bits: int, n_rows: int, missing_bin: int, max_depth: int,
) -> torch.Tensor:
    """Leaf outputs (t, n_rows) of t tree arenas (t, a) over the packed
    matrix."""
    return traverse_trees_on(C.PackedBins(packed, bits, n_rows), feature, split_bin,
                             default_left, leaf_value, is_leaf, missing_bin, max_depth)


def traverse_tree_packed(
    feature, split_bin, default_left, leaf_value, is_leaf,
    packed: torch.Tensor, bits: int, n_rows: int, missing_bin: int, max_depth: int,
) -> torch.Tensor:
    """Leaf outputs (n_rows,) of ONE tree arena over the packed matrix."""
    return traverse_trees_packed(
        *(a[None] for a in (feature, split_bin, default_left, leaf_value, is_leaf)),
        packed, bits, n_rows, missing_bin, max_depth)[0]


def fold_classes(leaves: torch.Tensor, ens: Ensemble) -> torch.Tensor:
    """(n_trees, n_rows) leaf outputs -> (n_rows, n_classes) margins. Each
    class adds its trees' leaves one after another in tree order, as each
    thread of the traversal kernel does (`kernels.ref.ensemble_margins_ref`):
    with the order fixed, a row's margin does not depend on which other rows
    share the call, so chunk by chunk gives the whole matrix's margins."""
    k = ens.n_classes
    acc = torch.zeros((k, leaves.shape[1]), dtype=leaves.dtype, device=leaves.device)
    for r in range(leaves.shape[0] // k):
        acc = acc + leaves[r * k:(r + 1) * k]
    return acc.t() + ens.base_score


def _sum_trees(ens: Ensemble, n_rows: int, leaves_of) -> torch.Tensor:
    """fold_classes of the leaves `leaves_of(t)` (n_rows,) of each tree t,
    added as each tree is walked: one tree's leaves at a time, never the
    (n_trees, n_rows) matrix."""
    k = ens.n_classes
    acc = torch.zeros((k, n_rows), dtype=torch.float32, device=ens.feature.device)
    for t in range(ens.n_trees):
        acc[t % k] += leaves_of(t)
    return acc.t() + ens.base_score


def predict_raw(ens: Ensemble, x: torch.Tensor, max_depth: int) -> torch.Tensor:
    """Margins (n_rows, n_classes) from raw float32 rows (NaN = missing),
    base_score included: the traversal kernel over the model's packed nodes
    on the card, its plain version on the CPU."""
    from repro_torch.kernels import ops  # lazy: ops imports core modules

    return ops.ensemble_margins_nodes_op(ens.nodes, x, ens.n_classes, max_depth) \
        + ens.base_score


def predict_binned(ens: Ensemble, bins: torch.Tensor, missing_bin: int,
                   max_depth: int) -> torch.Tensor:
    """Margins (n_rows, n_classes) from the dense quantised matrix."""
    return _sum_trees(ens, bins.shape[0], lambda t: traverse_tree_binned(
        ens.feature[t], ens.split_bin[t], ens.default_left[t], ens.leaf_value[t],
        ens.is_leaf[t], bins, missing_bin, max_depth))


def predict_binned_on(ens: Ensemble, bins, missing_bin: int, max_depth: int) -> torch.Tensor:
    """Margins (n_rows, n_classes) from a bins type (the reference's
    `predict_binned_packed` and `predict_binned_chunked`), one tree's walk
    at a time: on the streamed stack that is a pass a tree, so margins of
    a streamed matrix go through `Booster` a chunk at a time instead."""
    return _sum_trees(ens, bins.n_rows, lambda t: traverse_trees_on(
        bins, ens.feature[t:t + 1], ens.split_bin[t:t + 1], ens.default_left[t:t + 1],
        ens.leaf_value[t:t + 1], ens.is_leaf[t:t + 1], missing_bin, max_depth)[0])


def predict_binned_packed(ens: Ensemble, packed: torch.Tensor, bits: int,
                          n_rows: int, missing_bin: int, max_depth: int) -> torch.Tensor:
    """Margins (n_rows, n_classes) from the packed quantised matrix."""
    return predict_binned_on(ens, C.PackedBins(packed, bits, n_rows), missing_bin,
                             max_depth)
