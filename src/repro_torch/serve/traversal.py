"""Raw-row ensemble prediction; counterpart of `repro.serve.traversal`
(`predict_margins_fused`).

All trees over all rows in one launch of the ensemble-traversal kernel on
the card (its plain version on the CPU): x <= threshold goes left, NaN takes
the node's default direction, tree t feeds class t % n_classes.
"""
from __future__ import annotations

import torch

from repro_torch.core.predict import Ensemble
from repro_torch.kernels import ops


def predict_margins_fused(ens: Ensemble, x: torch.Tensor, max_depth: int) -> torch.Tensor:
    """Margins (n_rows, n_classes) from raw float32 rows, base_score included."""
    m = ops.ensemble_margins_op(ens.feature, ens.threshold, ens.default_left,
                                ens.leaf_value, ens.is_leaf, x, ens.n_classes,
                                max_depth)
    return m + ens.base_score
