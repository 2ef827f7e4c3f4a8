"""Ensemble arena and bin-space prediction (paper §2.4); counterpart of
`repro.core.predict`.

`traverse_tree_packed` is the training margin update: one tree over the
packed training matrix in bin space, all rows one level per step (plain
torch gathers; the reference runs it in XLA too). Raw-row prediction goes
through the ensemble-traversal kernel in `serve/traversal.py`.
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
    Ensemble is built."""

    feature: torch.Tensor  # (t, a) int32
    split_bin: torch.Tensor  # (t, a) int32
    threshold: torch.Tensor  # (t, a) float32
    default_left: torch.Tensor  # (t, a) bool
    leaf_value: torch.Tensor  # (t, a) float32
    is_leaf: torch.Tensor  # (t, a) bool
    gain: torch.Tensor  # (t, a) float32, -inf = not a split
    n_classes: int = 1
    base_score: float = 0.0
    nodes: torch.Tensor = dataclasses.field(init=False, repr=False)  # (t, a + a % 2, 2) int32

    def __post_init__(self):
        object.__setattr__(self, "nodes", pack_nodes(
            self.feature, self.threshold, self.default_left, self.leaf_value, self.is_leaf))

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


def traverse_tree_packed(
    feature, split_bin, default_left, leaf_value, is_leaf,
    packed: torch.Tensor, bits: int, n_rows: int, missing_bin: int, max_depth: int,
) -> torch.Tensor:
    """Leaf outputs (n_rows,) of ONE tree arena over the packed matrix: per
    level one word gather per row plus a shift/mask."""
    node = torch.zeros(n_rows, dtype=torch.int64, device=packed.device)
    for _ in range(max_depth):
        b = C.gather_feature_bins(packed, bits, feature[node])
        go_left = torch.where(b == missing_bin, default_left[node], b <= split_bin[node])
        child = torch.where(go_left, 2 * node + 1, 2 * node + 2)
        node = torch.where(is_leaf[node], node, child)
    return leaf_value[node]


def fold_classes(leaves: torch.Tensor, ens: Ensemble) -> torch.Tensor:
    """(n_trees, n_rows) leaf outputs -> (n_rows, n_classes) margins."""
    k = ens.n_classes
    per_class = leaves.reshape(-1, k, leaves.shape[1]).sum(dim=0)
    return per_class.t() + ens.base_score


def predict_binned_packed(ens: Ensemble, packed: torch.Tensor, bits: int,
                          n_rows: int, missing_bin: int, max_depth: int) -> torch.Tensor:
    """Margins (n_rows, n_classes) from the packed quantised matrix."""
    leaves = torch.stack([
        traverse_tree_packed(ens.feature[t], ens.split_bin[t], ens.default_left[t],
                             ens.leaf_value[t], ens.is_leaf[t], packed, bits,
                             n_rows, missing_bin, max_depth)
        for t in range(ens.n_trees)
    ])
    return fold_classes(leaves, ens)
