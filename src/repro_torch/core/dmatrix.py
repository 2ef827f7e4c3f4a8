"""DeviceDMatrix — the quantised, compressed training matrix (paper Figure 1,
left boxes); counterpart of the constructor of `repro.core.dmatrix.DeviceDMatrix`.

Construction runs quantile generation (`compute_cuts`) -> quantisation
(`quantize`) -> bit-packing (`compress`) ONCE, on the matrix's device.
Evaluation and prediction sets share the training cuts through `ref=`, so
bin-space traversal agrees exactly with raw-threshold traversal:

    dtrain = DeviceDMatrix(x_train, label=y_train)        # cuda by default
    dvalid = DeviceDMatrix(x_valid, label=y_valid, ref=dtrain)
    drank = DeviceDMatrix(x, label=rel, group_ids=qid)   # rank:pairwise

The batch constructors and the external-memory matrix are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core import compress as C
from repro_torch.core import quantile as Q
from repro_torch.device import as_tensor, resolve_device


def cuts_equal(a: torch.Tensor | None, b: torch.Tensor | None) -> bool:
    """Identity-or-value equality of two cut-point arrays."""
    if a is b:
        return True
    if a is None or b is None:
        return False
    return a.device == b.device and torch.equal(a, b)


class DeviceDMatrix:
    """Device-resident quantised + compressed data matrix.

    Args:
      x: (n_rows, n_features) float array (numpy or torch), NaN = missing.
      label: optional (n_rows,) targets; required for `Booster.fit`.
      group_ids: optional (n_rows,) int query-group ids (rank:pairwise and
        ndcg@k), kept as an int32 tensor on the matrix's device. Ids need
        not be contiguous or sorted.
      max_bins: total bins per feature incl. the reserved missing bin.
      ref: another DeviceDMatrix whose cut points, max_bins and device to
        reuse — required for evaluation and prediction sets.
      cuts: optional precomputed (n_features, max_bins - 2) cut array.
        Mutually exclusive with `ref`.
      device: "cuda" (the default, None) or "cpu". Without a card a CUDA
        matrix raises instead of falling back to the CPU.
    """

    def __init__(
        self,
        x,
        label=None,
        *,
        group_ids=None,
        max_bins: int = Q.DEFAULT_MAX_BINS,
        ref: "DeviceDMatrix | None" = None,
        cuts=None,
        device=None,
    ):
        if ref is not None and device is None:
            device = ref.device
        dev = resolve_device(device)
        if ref is not None and dev != ref.device:
            raise ValueError(f"ref lives on {ref.device}, not on {dev}")
        x = as_tensor(x, dev)
        if x.ndim != 2:
            raise ValueError(f"x must be 2-D (n_rows, n_features), got {tuple(x.shape)}")
        if x.shape[0] == 0:
            raise ValueError(
                "x has 0 rows; cannot build a DeviceDMatrix from an empty matrix"
            )
        if x.shape[1] == 0:
            raise ValueError(
                "x has 0 features; every row needs at least one feature column"
            )
        if bool(torch.isinf(x).any()):
            raise ValueError(
                "x contains infinite feature values; replace ±inf with NaN "
                "(the legal missing marker) or a large finite value before "
                "quantisation"
            )
        if ref is not None:
            if cuts is not None:
                raise ValueError(
                    "pass either ref= or cuts=, not both (ref already "
                    "carries its cut points)"
                )
            cuts = ref.cuts
            max_bins = ref.max_bins
            if x.shape[1] != ref.n_features:
                raise ValueError(
                    f"ref has {ref.n_features} features, x has {x.shape[1]}"
                )
        elif cuts is not None:
            cuts = as_tensor(cuts, dev)
            nvb = Q.n_value_bins(max_bins)
            if tuple(cuts.shape) != (x.shape[1], nvb - 1):
                raise ValueError(
                    f"cuts must have shape ({x.shape[1]}, {nvb - 1}) for "
                    f"max_bins={max_bins}, got {tuple(cuts.shape)}"
                )
        else:
            cuts = Q.compute_cuts(x, max_bins)
        self.device = dev
        bins = Q.quantize(x, cuts)
        self.matrix: C.CompressedMatrix = C.compress(bins, cuts, max_bins)
        self.label = None if label is None else as_tensor(label, dev).reshape(-1)
        if self.label is not None and self.label.shape[0] != self.n_rows:
            raise ValueError(
                f"label has {self.label.shape[0]} rows, x has {self.n_rows}"
            )
        if self.label is not None and not bool(torch.isfinite(self.label).all()):
            raise ValueError(
                "label contains non-finite values (NaN/inf); clean or drop "
                "those rows before training"
            )
        # Checked here, not left to the gradient: the pairwise kernel would
        # read a short group_ids past its end.
        self.group_ids = (None if group_ids is None
                          else as_tensor(group_ids, dev, torch.int32).reshape(-1))
        if self.group_ids is not None and self.group_ids.shape[0] != self.n_rows:
            raise ValueError(
                f"group_ids has {self.group_ids.shape[0]} rows, x has {self.n_rows}"
            )

    @property
    def cuts(self) -> torch.Tensor:
        return self.matrix.cuts

    @property
    def max_bins(self) -> int:
        return self.matrix.max_bins

    @property
    def bits(self) -> int:
        return self.matrix.bits

    @property
    def n_rows(self) -> int:
        return self.matrix.n_rows

    @property
    def n_features(self) -> int:
        return self.matrix.n_features

    @property
    def nbytes(self) -> int:
        """Device bytes held: packed words + cut points + labels/groups."""
        total = self.matrix.nbytes_compressed() + self.cuts.numel() * 4
        if self.label is not None:
            total += self.label.shape[0] * 4
        if self.group_ids is not None:
            total += self.group_ids.shape[0] * 4
        return total

    def packed_bins(self) -> C.PackedBins:
        return self.matrix.as_packed_bins()

    def compression_ratio(self) -> float:
        return self.matrix.compression_ratio()

    def same_cuts(self, other: "DeviceDMatrix") -> bool:
        return cuts_equal(self.cuts, other.cuts)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"DeviceDMatrix({self.n_rows}x{self.n_features}, {self.bits}-bit, "
            f"max_bins={self.max_bins}, {self.device}"
            f"{', labelled' if self.label is not None else ''}"
            f"{', grouped' if self.group_ids is not None else ''})"
        )
