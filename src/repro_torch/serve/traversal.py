"""Ensemble traversal for batch inference; counterpart of
`repro.serve.traversal`.

`predict_margins_fused` runs all trees over all rows in one launch of the
ensemble-traversal kernel on the card (its plain version on the CPU), over
the model's packed nodes (`Ensemble.nodes`, packed once when the model is
built): x <= threshold goes left, NaN takes the node's default direction,
tree t feeds class t % n_classes.

`traverse_ensemble_raw` and `traverse_ensemble_packed` give the per-tree
leaves (n_trees, n_rows) over raw rows and over the bit-packed quantised
matrix; `predict_margins_fused_packed` folds the packed ones into margins.
For external memory, `ensemble_leaves_chunk` gives one packed chunk's
leaves (the unit of a paged predict) and `predict_margins_fused_chunked`
the margins over a resident chunk stack, chunk by chunk; each class adds
its trees in tree order (`core.predict.fold_classes`), so both are bit for
bit `core.predict.predict_binned_on` over the same rows.
The reference builds these with XLA, outside any kernel; here they are
plain torch on the tensors' device, a block of TREES_BLOCK trees advancing
one level per step: the kernel's plain version (`kernels.ref`) over raw
rows, `core.predict`'s bin-space walk over the packed words. So they are
bit-identical to the per-tree traversals (the same leaves, folded in the
same order). `Booster.predict_margins` keeps the per-tree
`core.predict.predict_binned_packed` for a DeviceDMatrix, as `update` does.
"""
from __future__ import annotations

import torch

from repro_torch.core import predict as PR
from repro_torch.kernels.ref import ensemble_leaves_ref

TREES_BLOCK = 32  # trees a level step advances: (32, n_rows) node planes


def predict_margins_fused(ens: PR.Ensemble, x: torch.Tensor, max_depth: int) -> torch.Tensor:
    """Margins (n_rows, n_classes) from raw float32 rows, base_score included:
    `core.predict.predict_raw`, the traversal kernel over the packed nodes."""
    return PR.predict_raw(ens, x, max_depth)


def traverse_ensemble_raw(feature, threshold, default_left, leaf_value, is_leaf,
                          x: torch.Tensor, max_depth: int) -> torch.Tensor:
    """(n_trees, n_rows) leaf outputs over float32 rows (NaN = missing)."""
    return torch.cat([
        ensemble_leaves_ref(feature[s], threshold[s], default_left[s], leaf_value[s],
                            is_leaf[s], x, max_depth)
        for s in _blocks(feature.shape[0])])


def traverse_ensemble_packed(feature, split_bin, default_left, leaf_value, is_leaf,
                             packed: torch.Tensor, bits: int, n_rows: int,
                             missing_bin: int, max_depth: int) -> torch.Tensor:
    """(n_trees, n_rows) leaf outputs straight from the bit-packed matrix."""
    return torch.cat([
        PR.traverse_trees_packed(feature[s], split_bin[s], default_left[s], leaf_value[s],
                                 is_leaf[s], packed, bits, n_rows, missing_bin, max_depth)
        for s in _blocks(feature.shape[0])])


def predict_margins_fused_packed(ens: PR.Ensemble, packed: torch.Tensor, bits: int,
                                 n_rows: int, missing_bin: int,
                                 max_depth: int) -> torch.Tensor:
    """Margins (n_rows, n_classes) from the bit-packed quantised matrix,
    bit-identical to `core.predict.predict_binned_packed`."""
    leaves = traverse_ensemble_packed(ens.feature, ens.split_bin, ens.default_left,
                                      ens.leaf_value, ens.is_leaf, packed, bits, n_rows,
                                      missing_bin, max_depth)
    return PR.fold_classes(leaves, ens)


def ensemble_leaves_chunk(ens: PR.Ensemble, chunk_words: torch.Tensor, bits: int,
                          chunk_rows: int, n_rows: int, missing_bin: int,
                          max_depth: int) -> torch.Tensor:
    """(n_trees, chunk_rows) leaf outputs of ONE packed chunk (F,
    words_per_chunk), walked at its padded chunk_rows size: the unit of a
    paged predict over an ExternalDMatrix. `n_rows` is the reference's
    argument; the chunk's padding rows are the caller's to drop."""
    del n_rows
    return traverse_ensemble_packed(ens.feature, ens.split_bin, ens.default_left,
                                    ens.leaf_value, ens.is_leaf, chunk_words, bits,
                                    chunk_rows, missing_bin, max_depth)


def predict_margins_fused_chunked(ens: PR.Ensemble, packed: torch.Tensor, bits: int,
                                  chunk_rows: int, n_rows: int, missing_bin: int,
                                  max_depth: int) -> torch.Tensor:
    """Margins (n_rows, n_classes) over a device-resident (n_chunks, F,
    words_per_chunk) chunk stack: each chunk's leaves (`ensemble_leaves_chunk`)
    in global row order, the padding dropped, folded class by class in tree
    order: bit for bit `core.predict.predict_binned_on` over the stack."""
    leaves = torch.cat([ensemble_leaves_chunk(ens, packed[c], bits, chunk_rows, n_rows,
                                              missing_bin, max_depth)
                        for c in range(packed.shape[0])], dim=1)[:, :n_rows]
    return PR.fold_classes(leaves, ens)


def _blocks(n_trees: int) -> list[slice]:
    return [slice(s, s + TREES_BLOCK) for s in range(0, n_trees, TREES_BLOCK)]
