"""Peaks of the card and the least time of the work the benchmark measures.

Peaks: NVIDIA H100 SXM data sheet, dense rates: 3.35 TB/s of HBM3, 67
TFLOP/s in float32 outside the tensor cores (the histograms, the split
scan and the traversal use no tensor core). The card's power limit is
reported beside every reading (`device.power_limit_w`).

Least time of a piece of work: the larger of its bytes over the bandwidth
and its operations over the float32 rate, each input read once and each
output written once, whatever the kernel reads again.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def least_s(nbytes: float, nops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S)


def packed_row_bytes(n_features: int, max_bins: int) -> float:
    """Bytes of one row's symbols in the compressed matrix: each feature's
    bin at the bits max_bins - 1 needs, packed whole into 32-bit words."""
    bits = max(1, (max_bins - 1).bit_length())
    bits = next(b for b in (1, 2, 4, 8, 16, 32) if b >= bits)
    return n_features * bits / 8


def histogram_call(rows: int, n_features: int, max_bins: int, n_nodes: int,
                   row_ids: bool) -> tuple[float, float]:
    """(bytes, operations) of one histogram call over `rows` rows into
    n_nodes nodes: the rows' symbols, their (g, h) pairs (8 bytes) and node
    positions (4), their row ids (8) where the call takes a row list; the
    float32 (g, h) histogram written once; an add of g and of h a (row,
    feature)."""
    nbytes = rows * (packed_row_bytes(n_features, max_bins) + 8 + 4 + (8 if row_ids else 0))
    nbytes += n_nodes * n_features * max_bins * 2 * 4
    return nbytes, 2.0 * rows * n_features


def traversal_call(rows: int, n_features: int, n_trees: int, arena: int,
                   levels_visited: int, n_classes: int = 1) -> tuple[float, float]:
    """(bytes, operations) of one traversal call: the float32 rows read
    once, the packed arenas (8 bytes a node) once, the margins written once;
    a compare, a missing test and a child index a level visited, an add a
    (row, tree)."""
    nbytes = rows * n_features * 4 + n_trees * arena * 8 + rows * n_classes * 4
    return nbytes, 3.0 * levels_visited + rows * n_trees


def training_round(rows: int, n_features: int, max_bins: int, depth: int,
                   hist_rows: list[int]) -> tuple[float, float]:
    """(bytes, operations) of one boosting round: the packed matrix read
    once for each level it routes and histograms; (g, h), labels and
    margins read once; positions and margins written once; the histograms'
    adds over the rows each level histograms."""
    nbytes = depth * rows * packed_row_bytes(n_features, max_bins)
    nbytes += rows * (8 + 4 + 4) + rows * (4 + 4)
    return nbytes, 2.0 * n_features * sum(hist_rows)
