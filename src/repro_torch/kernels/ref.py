"""Plain PyTorch versions of the CUDA kernels; counterpart of
`repro.kernels.ref`.

Each computes the same function as its kernel. The CPU path runs them (the
dispatch in `kernels/ops.py` sends a CPU tensor here), and the kernels are
held against them on the card. Where the kernel's arithmetic is
deterministic (split scan, cut selection, traversal, unpack) the plain
version performs the same operations in the same order, so the two agree
bit for bit; the histogram kernels add with atomics, in no fixed order.
"""
from __future__ import annotations

import torch

from repro_torch.core import histogram as H
from repro_torch.core.compress import symbols_per_word, unpack, words_as_uint

# Plain version of the decompress kernel: (F, W) words -> (n_rows, F) int32.
decompress_ref = unpack


def histogram_ref(
    packed: torch.Tensor,  # (F, W) int32 words
    gh: torch.Tensor,  # (N, 2) float32
    positions: torch.Tensor,  # (N,) int32, n_nodes (or -1) = inactive
    n_nodes: int,
    max_bins: int,
    bits: int,
) -> torch.Tensor:
    """Plain version of the privatised histogram kernel: unpack, then
    scatter-add. Returns (n_nodes, F, max_bins, 2) in gh's dtype: float32
    as the kernel computes it, or float64 for a reference whose own
    rounding stays far below the kernel's."""
    bins = unpack(packed, bits, gh.shape[0])
    return H.build_histograms(bins, gh, positions, n_nodes, max_bins)


# `histogram_packed` computes the same function as the privatised kernel.
histogram_packed_ref = histogram_ref


def histogram_rows_ref(
    packed: torch.Tensor,  # (F, W) int32 words
    gh_sel: torch.Tensor,  # (m, 2) float32
    pos_sel: torch.Tensor,  # (m,) int node per slot, n_nodes = dump
    row_ids: torch.Tensor,  # (m,) int row per slot, >= W * spw = padding
    n_nodes: int,
    max_bins: int,
    bits: int,
) -> torch.Tensor:
    """Plain version of the row-id histogram kernel: one word gather and a
    shift/mask per (slot, feature), then the scatter-add in slot order. A
    slot whose row id lies outside the packed words goes to the dump slot,
    as one at the dump position does. Returns (n_nodes, F, max_bins, 2) in
    gh_sel's dtype."""
    spw = symbols_per_word(bits)
    rid = row_ids.to(torch.int64)
    inside = (rid >= 0) & (rid < packed.shape[1] * spw)
    rid = torch.where(inside, rid, 0)
    words = words_as_uint(packed[:, rid // spw])  # (F, m)
    bins = ((words >> ((rid % spw) * bits)) & ((1 << bits) - 1)).t()
    pos = torch.where(inside, pos_sel.to(torch.int64), n_nodes)
    return H.build_histograms(bins, gh_sel, pos, n_nodes, max_bins)


def inclusive_scan(v: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis, added strictly left to right
    in float32 (the order of the split-scan kernel). Sequential order keeps
    an empty bin's prefix exactly equal to its predecessor's, so candidate
    thresholds that split the rows identically tie exactly."""
    out = torch.empty_like(v)
    acc = torch.zeros_like(v[..., 0])
    for b in range(v.shape[-1]):
        acc = acc + v[..., b]
        out[..., b] = acc
    return out


def split_scan_ref(
    hist: torch.Tensor,  # (n_nodes, F, B, 2)
    parent_sum: torch.Tensor,  # (n_nodes, 2)
    reg_lambda: float,
    min_child_weight: float,
) -> torch.Tensor:
    """Plain version of the split-scan kernel: per (node, feature) best split.

    Returns (n_nodes, F, 5): [gain, best_bin, default_left, gl, hl], where
    (gl, hl) are the left child's sums at the best split (missing mass
    included when it goes left). gamma is left to the caller. The float
    operations and their order are those of `core/split.py` in the reference.
    """
    g, h = hist[..., 0], hist[..., 1]
    g_tot = parent_sum[:, None, 0:1]
    h_tot = parent_sum[:, None, 1:2]
    g_miss, h_miss = g[..., -1:], h[..., -1:]
    gl = inclusive_scan(g[..., :-1])[..., :-1]  # (n, F, B-2) candidates
    hl = inclusive_scan(h[..., :-1])[..., :-1]
    parent = (g_tot * g_tot) / (h_tot + reg_lambda)

    def gain_of(gl_, hl_):
        gr_, hr_ = g_tot - gl_, h_tot - hl_
        gain = 0.5 * ((gl_ * gl_) / (hl_ + reg_lambda)
                      + (gr_ * gr_) / (hr_ + reg_lambda) - parent)
        ok = (hl_ >= min_child_weight) & (hr_ >= min_child_weight)
        return torch.where(ok, gain, torch.full_like(gain, float("-inf")))

    gain_r = gain_of(gl, hl)
    gain_l = gain_of(gl + g_miss, hl + h_miss)
    dl = gain_l > gain_r
    gain = torch.where(dl, gain_l, gain_r)

    best = torch.argmax(gain, dim=-1, keepdim=True)  # first max: lowest bin
    take = lambda a: torch.gather(a, -1, best)[..., 0]  # noqa: E731
    bdl = take(dl)
    zero = torch.zeros((), dtype=hist.dtype, device=hist.device)
    gl_best = take(gl) + torch.where(bdl, g_miss[..., 0], zero)
    hl_best = take(hl) + torch.where(bdl, h_miss[..., 0], zero)
    return torch.stack(
        [take(gain), best[..., 0].to(torch.float32), bdl.to(torch.float32),
         gl_best, hl_best],
        dim=-1,
    )


def quantile_cuts_ref(
    srt: torch.Tensor,  # (n, F) f32 column-sorted, +inf tail
    n_valid: torch.Tensor,  # (F,) finite count per column
    max_bins: int,
) -> torch.Tensor:
    """Plain version of the cut-selection kernel: the PRE-SORT candidate
    cuts (F, max_bins - 2), arithmetic of `repro.core.quantile`
    (`select_cuts_from_sorted`) operation for operation, with true f32
    division for the rank fractions."""
    n = srt.shape[0]
    nvb = max_bins - 1
    ranks = torch.arange(1, nvb, dtype=torch.float32, device=srt.device)
    nv_m1 = torch.clamp(n_valid.to(torch.int64) - 1, min=1).to(torch.float32)
    # Divide by a tensor, not a Python number: torch turns division by a
    # scalar into multiplication by its reciprocal, which is not true
    # division and would differ from the kernel's __fdiv_rn.
    qs = (ranks / torch.full_like(ranks, nvb))[None, :] * nv_m1[:, None]
    lo = torch.clamp(torch.floor(qs).to(torch.int64), 0, n - 1)
    hi = torch.clamp(lo + 1, 0, n - 1)
    frac = qs - lo.to(torch.float32)
    col = srt.t()
    lov = torch.gather(col, 1, lo)
    hiv = torch.gather(col, 1, hi)
    hiv = torch.where(torch.isfinite(hiv), hiv, lov)
    cand = lov + frac * (hiv - lov)
    inf = torch.full_like(cand, float("inf"))
    cand = torch.where(torch.isfinite(cand), cand, inf)
    prev = torch.cat([torch.full_like(cand[:, :1], float("-inf")), cand[:, :-1]], dim=1)
    return torch.where(cand > prev, cand, inf)


def ensemble_leaves_ref(
    feature: torch.Tensor,  # (T, A) int
    threshold: torch.Tensor,  # (T, A) f32
    default_left: torch.Tensor,  # (T, A) bool
    leaf_value: torch.Tensor,  # (T, A) f32
    is_leaf: torch.Tensor,  # (T, A) bool
    x: torch.Tensor,  # (N, F) f32, NaN = missing
    max_depth: int,
) -> torch.Tensor:
    """(T, N) leaf value of every (tree, row): all trees walk all rows one
    level per step; x <= threshold goes left, NaN takes the node's default
    direction, a leaf keeps its row."""
    n_rows = x.shape[0]
    node = torch.zeros((feature.shape[0], n_rows), dtype=torch.int64, device=x.device)
    row = torch.arange(n_rows, device=x.device)[None, :]
    for _ in range(max_depth):
        f = torch.gather(feature, 1, node).to(torch.int64)
        v = x[row, f]
        go_left = torch.where(torch.isnan(v), torch.gather(default_left, 1, node),
                              v <= torch.gather(threshold, 1, node))
        child = torch.where(go_left, 2 * node + 1, 2 * node + 2)
        node = torch.where(torch.gather(is_leaf, 1, node), node, child)
    return torch.gather(leaf_value, 1, node)


def ensemble_margins_ref(
    feature: torch.Tensor,
    threshold: torch.Tensor,
    default_left: torch.Tensor,
    leaf_value: torch.Tensor,
    is_leaf: torch.Tensor,
    x: torch.Tensor,
    n_classes: int,
    max_depth: int,
) -> torch.Tensor:
    """Plain version of the ensemble-traversal kernel: margins (N, K)
    without base_score. Tree t feeds class t % K; each class sums its
    leaves in tree order, as each kernel thread does."""
    leaves = ensemble_leaves_ref(feature, threshold, default_left, leaf_value,
                                 is_leaf, x, max_depth)
    n_trees, n_rows = leaves.shape
    acc = torch.zeros((n_classes, n_rows), dtype=torch.float32, device=x.device)
    for r in range(n_trees // n_classes):
        acc = acc + leaves[r * n_classes:(r + 1) * n_classes]
    return acc.t().contiguous()
