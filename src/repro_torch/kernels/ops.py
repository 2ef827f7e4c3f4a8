"""Dispatch between the CUDA kernels and their plain versions; counterpart
of `repro.kernels.ops`.

A CUDA tensor goes to the kernel, a CPU tensor to the plain version in
`kernels/ref.py`. Nothing else: a kernel that fails to build or launch
raises, it never gives way to the plain version.

Histograms: `fixed_point_histograms(device)` alone says where they are built
in 64-bit fixed point (`kernels/fixed.py`): on a CUDA device, where the
kernels always add so. On the CPU the histogram ops run the float plain
versions (float32 sums in row order, the reference's arithmetic), unless
that function is replaced, as the CPU tests replace it to run the card's
arithmetic through whole fits.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantile as Q
from repro_torch.core.compress import PackedBins, bits_needed, pack
from repro_torch.kernels import fixed as FX
from repro_torch.kernels import ref as R
from repro_torch.kernels.decompress import decompress
from repro_torch.kernels.ensemble_traversal import (
    ensemble_margins_kernel,
    node_fields,
    pack_nodes,
)
from repro_torch.kernels.histogram import (
    build_histograms_packed_kernel,
    build_histograms_rows_kernel,
    dequantise_kernel,
    fixed_exponent,
    histogram_packed,
)
from repro_torch.kernels.pairwise import pairwise_grad as pairwise_grad_kernel
from repro_torch.kernels.quantile_cuts import quantile_cuts_from_sorted
from repro_torch.kernels.split_scan import split_scan as split_scan_kernel

# The wrappers whose `launches` count shows which kernels a run went through.
KERNELS = {
    "histogram_private": build_histograms_packed_kernel,
    "histogram_rows": build_histograms_rows_kernel,
    "histogram_packed": histogram_packed,
    "split_scan": split_scan_kernel,
    "quantile_cuts": quantile_cuts_from_sorted,
    "ensemble_traversal": ensemble_margins_kernel,
    "decompress": decompress,
    "pairwise_grad": pairwise_grad_kernel,
    "fixed_exponent": fixed_exponent,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def fixed_point_histograms(device) -> bool:
    """Whether histograms on `device` are built in 64-bit fixed point: true
    for a CUDA device, false for the CPU. Every histogram op, the dense
    scatter and the running slabs ask this, and nothing else decides."""
    return torch.device(device).type == "cuda"


def fixed_point_exponent(gh: torch.Tensor) -> torch.Tensor:
    """The fixed-point exponent of the (n, 2) (g, h): the exponent kernel
    on the card (one launch), `fixed.exponent` elsewhere (the same k)."""
    if gh.is_cuda:
        return fixed_exponent(gh.contiguous())
    return FX.exponent(gh)


def dequantise(acc: torch.Tensor, exponent: torch.Tensor) -> torch.Tensor:
    """float32 histogram from an int64 accumulator at `exponent`: the
    conversion pass on the card, `fixed.dequantise` elsewhere (the same
    bits)."""
    if acc.is_cuda:
        return dequantise_kernel(acc.contiguous(), exponent)
    return FX.dequantise(acc, exponent)


def histogram_packed_op(packed: torch.Tensor, gh: torch.Tensor, positions: torch.Tensor,
                        n_nodes: int, max_bins: int, bits: int,
                        exponent: torch.Tensor | None = None) -> torch.Tensor:
    """(n_nodes, F, max_bins, 2) histogram from packed words through the
    cluster kernel (each output tile owned by one thread-block cluster);
    positions n_nodes or -1 are inactive. In fixed point at `exponent`
    (None: from gh) where `fixed_point_histograms` holds."""
    if packed.is_cuda:
        return histogram_packed(packed, gh.contiguous(),
                                positions.to(torch.int32).contiguous(),
                                n_nodes, max_bins, bits, exponent=exponent)
    if fixed_point_histograms(packed.device):
        return R.histogram_packed_fixed_ref(packed, gh, positions, n_nodes, max_bins, bits,
                                            exponent=exponent)
    return R.histogram_packed_ref(packed, gh, positions, n_nodes, max_bins, bits)


def _slab_nodes(out: torch.Tensor | None, n_nodes: int, chunk_rows, gh: torch.Tensor,
                exponent: torch.Tensor | None):
    """(a running slab's first n_nodes nodes, the exponent to add at): the
    kernels' `out=` (the dump slot is the plain versions' alone); slabs are
    for the flat words. A fixed-point (int64) slab adds at its pass's
    exponent; given none, at the slab's own (`fixed.running_exponent`)."""
    if out is None:
        return None, exponent
    if chunk_rows is not None:
        raise ValueError("out= adds flat words (one chunk) into a slab, not the chunk stack")
    if out.ndim != 4 or out.shape[0] != n_nodes + 1:
        raise ValueError(f"out must be an (n_nodes + 1, F, max_bins, 2) slab of "
                         f"{n_nodes + 1} nodes, got {tuple(out.shape)}")
    if out.dtype == torch.int64 and exponent is None:
        exponent = FX.running_exponent(out, gh)
    return out[:n_nodes], exponent


def histogram_private_op(packed: torch.Tensor, gh: torch.Tensor, positions: torch.Tensor,
                         n_nodes: int, max_bins: int, bits: int,
                         chunk_rows: int | None = None,
                         out: torch.Tensor | None = None,
                         exponent: torch.Tensor | None = None) -> torch.Tensor:
    """(n_nodes, F, max_bins, 2) histogram from packed words through the
    privatised kernel; with `chunk_rows`, from the (n_chunks, F,
    words_per_chunk) chunk stack, in one launch. Given `out`, a running
    (n_nodes + 1, F, max_bins, 2) slab (its last node the dump slot), the
    rows are added into it (`core.histogram.histogram_chunk_update`): an
    int64 slab where `fixed_point_histograms` holds, at the pass's
    `exponent` (given none, at the slab's own). Without `out` the exponent
    is the call's own unless given."""
    nodes, exponent = _slab_nodes(out, n_nodes, chunk_rows, gh, exponent)
    if packed.is_cuda:
        return build_histograms_packed_kernel(
            packed.contiguous(), gh.contiguous(), positions.to(torch.int32).contiguous(),
            n_nodes, max_bins, bits, chunk_rows, out=nodes, exponent=exponent)
    if fixed_point_histograms(packed.device):
        if chunk_rows is not None:
            return R.histogram_chunked_fixed_ref(packed, gh, positions, n_nodes, max_bins,
                                                 bits, chunk_rows, exponent=exponent)
        return R.histogram_fixed_ref(packed, gh, positions, n_nodes, max_bins, bits,
                                     exponent=exponent, out=out)
    if chunk_rows is not None:
        return R.histogram_chunked_ref(packed, gh, positions, n_nodes, max_bins, bits,
                                       chunk_rows)
    return R.histogram_ref(packed, gh, positions, n_nodes, max_bins, bits, out=out)


def build_histograms_kernel_packed(data: PackedBins, gh: torch.Tensor,
                                   positions: torch.Tensor, n_nodes: int,
                                   max_bins: int) -> torch.Tensor:
    """The `hist_builder` of `use_kernel_histograms=True`: the training
    matrix's packed words straight to the privatised kernel, every level."""
    return histogram_private_op(data.packed, gh, positions, n_nodes, max_bins,
                                data.bits)


def build_histograms_kernel(bins: torch.Tensor, gh: torch.Tensor, positions: torch.Tensor,
                            n_nodes: int, max_bins: int) -> torch.Tensor:
    """The `hist_builder` of `use_kernel_histograms=True` on dense (n, f)
    bins (`compress_matrix=False`): packs them at `bits_needed(max_bins - 1)`
    (plain torch, as the reference packs them outside its kernel) and calls
    the privatised kernel."""
    bits = bits_needed(max_bins - 1)
    return histogram_private_op(pack(bins, bits), gh, positions, n_nodes, max_bins, bits)


def histogram_rows(packed: torch.Tensor, gh_sel: torch.Tensor, pos_sel: torch.Tensor,
                   row_ids: torch.Tensor, n_nodes: int, max_bins: int,
                   bits: int, chunk_rows: int | None = None,
                   out: torch.Tensor | None = None,
                   exponent: torch.Tensor | None = None) -> torch.Tensor:
    """(n_nodes, F, max_bins, 2) histogram of a compacted row buffer; with
    `chunk_rows`, over the chunk stack (global row ids), in one launch.
    Given `out`, a running slab as for `histogram_private_op`, the slots
    are added into it (`core.histogram.histogram_rows_chunk_update`), an
    int64 one at the pass's `exponent`."""
    nodes, exponent = _slab_nodes(out, n_nodes, chunk_rows, gh_sel, exponent)
    if packed.is_cuda:
        return build_histograms_rows_kernel(
            packed.contiguous(), gh_sel.contiguous(), pos_sel.to(torch.int32).contiguous(),
            row_ids.to(torch.int32).contiguous(), n_nodes, max_bins, bits, chunk_rows,
            out=nodes, exponent=exponent)
    if fixed_point_histograms(packed.device):
        if chunk_rows is not None:
            return R.histogram_rows_chunked_fixed_ref(packed, gh_sel, pos_sel, row_ids,
                                                      n_nodes, max_bins, bits, chunk_rows,
                                                      exponent=exponent)
        return R.histogram_rows_fixed_ref(packed, gh_sel, pos_sel, row_ids, n_nodes,
                                          max_bins, bits, exponent=exponent, out=out)
    if chunk_rows is not None:
        return R.histogram_rows_chunked_ref(packed, gh_sel, pos_sel, row_ids, n_nodes,
                                            max_bins, bits, chunk_rows)
    return R.histogram_rows_ref(packed, gh_sel, pos_sel, row_ids, n_nodes,
                                max_bins, bits, out=out)


def decompress_op(packed: torch.Tensor, bits: int, n_rows: int) -> torch.Tensor:
    """(n_rows, F) int32 bins unpacked from the packed words."""
    if packed.is_cuda:
        return decompress(packed.contiguous(), bits, n_rows)
    return R.decompress_ref(packed, bits, n_rows)


def compute_cuts_op(x: torch.Tensor, max_bins: int) -> torch.Tensor:
    """Per-feature cut points (F, max_bins - 2) f32, ascending, +inf tail:
    missing values filled with +inf, each column sorted with `torch.sort`,
    then the cut-selection kernel (its plain version on the CPU), which
    returns the ascending cuts."""
    return select_cuts_op(*sorted_columns(x), max_bins)


def sorted_columns(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(column-sorted float32 with missing values as a +inf tail, the
    (F,) int32 finite counts): the sort stage of the cuts."""
    x = x.to(torch.float32)
    finite = torch.isfinite(x)
    srt = torch.sort(torch.where(finite, x, float("inf")), dim=0).values
    return srt, finite.sum(dim=0, dtype=torch.int32)


def select_cuts_op(srt: torch.Tensor, n_valid: torch.Tensor, max_bins: int) -> torch.Tensor:
    """The selection stage alone: ascending cuts (F, max_bins - 2) from
    column-sorted (n, F) float32 with a +inf tail and the (F,) finite
    counts, through the cut-selection kernel on the card."""
    if srt.is_cuda:
        return quantile_cuts_from_sorted(srt.contiguous(),
                                         n_valid.to(torch.int32).contiguous(), max_bins)
    return R.quantile_cuts_ref(srt, n_valid, max_bins)


def quantize_op(x: torch.Tensor, cuts: torch.Tensor) -> torch.Tensor:
    """(n_rows, F) int32 bin ids; NaN takes the missing bin. Plain PyTorch
    on both devices: the reference computes it outside any kernel too."""
    return Q.quantize(x, cuts)


def split_scan(hist: torch.Tensor, parent_sum: torch.Tensor,
               reg_lambda: float = 1.0, min_child_weight: float = 1.0,
               feature_mask: torch.Tensor | None = None,
               monotone: torch.Tensor | None = None,
               node_bounds: torch.Tensor | None = None) -> torch.Tensor:
    """(n_nodes, F, 5): [gain, bin, default_left, gl, hl] per (node, feature);
    `core.split` forms the left child's sums from gl and hl. Optional: a
    (F,) or (n_nodes, F) feature mask, and monotone constraints (F,) with
    (n_nodes, 2) node bounds."""
    if hist.is_cuda:
        return split_scan_kernel(
            hist.contiguous(), parent_sum.contiguous(), reg_lambda, min_child_weight,
            feature_mask, monotone,
            None if node_bounds is None else node_bounds.to(torch.float32).contiguous())
    return R.split_scan_ref(hist, parent_sum, reg_lambda, min_child_weight,
                            feature_mask, monotone, node_bounds)


def split_scan_op(hist: torch.Tensor, parent_sum: torch.Tensor,
                  reg_lambda: float = 1.0, min_child_weight: float = 1.0) -> torch.Tensor:
    """(n_nodes, F, 4): [gain, bin, default_left, hl] per (node, feature), the
    reference's fields (`split_scan` without gl)."""
    return split_scan(hist, parent_sum, reg_lambda, min_child_weight)[..., [0, 1, 2, 4]]


def ensemble_margins_nodes_op(nodes: torch.Tensor, x: torch.Tensor, n_classes: int,
                              max_depth: int) -> torch.Tensor:
    """(N, n_classes) margins of raw rows over all trees of a packed model
    (`Ensemble.nodes`), without base_score. A packed internal node holds its
    threshold, not a leaf value, so arenas deeper than `max_depth` raise:
    `ensemble_margins_op` cuts such a model at `max_depth` first."""
    if nodes.shape[1] > 2 ** (max_depth + 1):
        raise ValueError(f"packed arenas of {nodes.shape[1]} nodes are deeper than "
                         f"max_depth={max_depth}")
    if x.is_cuda:
        return ensemble_margins_kernel(nodes, x.contiguous(), n_classes, max_depth)
    value, feature, default_left, is_leaf = node_fields(nodes)
    return R.ensemble_margins_ref(feature, value, default_left, value, is_leaf, x,
                                  n_classes, max_depth)


def ensemble_margins_op(feature, threshold, default_left, leaf_value, is_leaf,
                        x: torch.Tensor, n_classes: int, max_depth: int) -> torch.Tensor:
    """(N, n_classes) margins of raw rows over all trees, without base_score,
    from the arena fields (the reference's signature): packed, then
    traversed. A model that predicts often packs once (`Ensemble.nodes`).
    As in the reference, a walk that has not reached a leaf after
    `max_depth` levels takes the leaf value of the node it stands on: arenas
    deeper than that are cut there, the last level kept made leaves."""
    keep = 2 ** (max_depth + 1) - 1
    if feature.shape[1] > keep:
        feature, threshold, default_left, leaf_value = (
            t[:, :keep] for t in (feature, threshold, default_left, leaf_value))
        last = torch.arange(keep, device=is_leaf.device) >= 2 ** max_depth - 1
        is_leaf = is_leaf[:, :keep].to(torch.bool) | last
    nodes = pack_nodes(feature, threshold, default_left, leaf_value, is_leaf)
    return ensemble_margins_nodes_op(nodes, x, n_classes, max_depth)


def query_groups(group_ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The grouping of rows by query id: (order, start, end), each (n,)
    int32. `order` is a stable argsort of the ids, so a group's rows keep
    ascending row order; `start[p]` and `end[p]` bound the span of sorted
    positions of position p's group. One sort and two binary searches of the
    sorted ids on their device, with no host read; ids need not be
    contiguous or sorted."""
    srt, order = torch.sort(group_ids.to(torch.int32), stable=True)
    start = torch.searchsorted(srt, srt, side="left", out_int32=True)
    end = torch.searchsorted(srt, srt, side="right", out_int32=True)
    return order.to(torch.int32), start, end


def pairwise_grad(scores: torch.Tensor, labels: torch.Tensor, order: torch.Tensor,
                  start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """(n, 2) (g, h) of rank:pairwise in row order over the grouping of
    `query_groups`, through the pairwise kernel on the card."""
    if scores.is_cuda:
        return pairwise_grad_kernel(
            scores.to(torch.float32).contiguous(), labels.to(torch.float32).contiguous(),
            *(t.to(torch.int32).contiguous() for t in (order, start, end)))
    return R.pairwise_grad_ref(scores, labels, order, start, end)
