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
from repro_torch.core.compress import (
    gather_rows_chunked,
    symbols_per_word,
    unpack,
    unpack_chunked,
    words_as_uint,
)

# Plain version of the decompress kernel: (F, W) words -> (n_rows, F) int32.
decompress_ref = unpack


def histogram_ref(
    packed: torch.Tensor,  # (F, W) int32 words
    gh: torch.Tensor,  # (N, 2) float32
    positions: torch.Tensor,  # (N,) int32, n_nodes (or -1) = inactive
    n_nodes: int,
    max_bins: int,
    bits: int,
    out: torch.Tensor | None = None,  # (n_nodes + 1, F, max_bins, 2) slab to add into
) -> torch.Tensor:
    """Plain version of the privatised histogram kernel: unpack, then
    scatter-add. Returns (n_nodes, F, max_bins, 2) in gh's dtype: float32
    as the kernel computes it, or float64 for a reference whose own
    rounding stays far below the kernel's. Given `out`, the rows are
    scattered into that running slab in row order (`build_histograms`'
    `flat`)."""
    bins = unpack(packed, bits, gh.shape[0])
    return H.build_histograms(bins, gh, positions, n_nodes, max_bins, flat=out)


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
    out: torch.Tensor | None = None,  # (n_nodes + 1, F, max_bins, 2) slab to add into
) -> torch.Tensor:
    """Plain version of the row-id histogram kernel: one word gather and a
    shift/mask per (slot, feature), then the scatter-add in slot order. A
    slot whose row id lies outside the packed words goes to the dump slot,
    as one at the dump position does. Returns (n_nodes, F, max_bins, 2) in
    gh_sel's dtype; given `out`, scattered into that running slab."""
    spw = symbols_per_word(bits)
    rid = row_ids.to(torch.int64)
    inside = (rid >= 0) & (rid < packed.shape[1] * spw)
    rid = torch.where(inside, rid, 0)
    words = words_as_uint(packed[:, rid // spw])  # (F, m)
    bins = ((words >> ((rid % spw) * bits)) & ((1 << bits) - 1)).t()
    pos = torch.where(inside, pos_sel.to(torch.int64), n_nodes)
    return H.build_histograms(bins, gh_sel, pos, n_nodes, max_bins, flat=out)


def histogram_chunked_ref(
    packed: torch.Tensor,  # (n_chunks, F, words_per_chunk) int32 chunk stack
    gh: torch.Tensor,  # (N, 2)
    positions: torch.Tensor,  # (N,) int, n_nodes (or -1) = inactive
    n_nodes: int,
    max_bins: int,
    bits: int,
    chunk_rows: int,
) -> torch.Tensor:
    """Plain version of the privatised kernel's chunked contract: each
    chunk unpacked, its padding dropped, then the scatter-add in row order:
    bit for bit `histogram_ref` on the flat words of the same rows."""
    bins = unpack_chunked(packed, bits, chunk_rows, gh.shape[0])
    return H.build_histograms(bins, gh, positions, n_nodes, max_bins)


def histogram_rows_chunked_ref(
    packed: torch.Tensor,  # (n_chunks, F, words_per_chunk) int32 chunk stack
    gh_sel: torch.Tensor,  # (m, 2)
    pos_sel: torch.Tensor,  # (m,) int node per slot, n_nodes = dump
    row_ids: torch.Tensor,  # (m,) int global row per slot, past the stack = padding
    n_nodes: int,
    max_bins: int,
    bits: int,
    chunk_rows: int,
) -> torch.Tensor:
    """Plain version of the row-id kernel's chunked contract: each slot's
    words gathered from its row's chunk, then the scatter-add in slot
    order. A slot whose row id lies past the stack's n_chunks * chunk_rows
    rows goes to the dump slot: bit for bit `histogram_rows_ref` on the
    flat words of the same rows."""
    rid = row_ids.to(torch.int64)
    inside = (rid >= 0) & (rid < packed.shape[0] * chunk_rows)
    bins = gather_rows_chunked(packed, bits, chunk_rows, torch.where(inside, rid, 0))
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


def gain_at_weight(g, h, w, reg_lambda):
    """A leaf's objective reduction at weight w (XGBoost's
    CalcGainGivenWeight): -(2 G w + (H + lam) w^2), in that order of
    operations; G^2/(H+lam) at the unconstrained optimum w = -G/(H+lam)."""
    return -(2.0 * g * w + (h + reg_lambda) * w * w)


def split_scan_ref(
    hist: torch.Tensor,  # (n_nodes, F, B, 2)
    parent_sum: torch.Tensor,  # (n_nodes, 2)
    reg_lambda: float,
    min_child_weight: float,
    feature_mask: torch.Tensor | None = None,  # (F,) or (n_nodes, F) bool
    monotone: torch.Tensor | None = None,  # (F,) int in {-1, 0, +1}
    node_bounds: torch.Tensor | None = None,  # (n_nodes, 2) [lower, upper]
) -> torch.Tensor:
    """Plain version of the split-scan kernel: per (node, feature) best split.

    Returns (n_nodes, F, 5): [gain, best_bin, default_left, gl, hl], where
    (gl, hl) are the left child's sums at the best split (missing mass
    included when it goes left). gamma is left to the caller. The float
    operations and their order are those of `core/split.py` in the reference.

    With `monotone` (and the required `node_bounds`) every candidate is
    scored as the reference's constrained evaluation scores it: child
    weights clipped to the node's bounds, the gain taken at the clipped
    weights, and a split whose weights break its feature's direction
    rejected. A (node, feature) that `feature_mask` leaves out gives
    [-inf, 0, 0, 0, 0].
    """
    g, h = hist[..., 0], hist[..., 1]
    g_tot = parent_sum[:, None, 0:1]
    h_tot = parent_sum[:, None, 1:2]
    g_miss, h_miss = g[..., -1:], h[..., -1:]
    gl = inclusive_scan(g[..., :-1])[..., :-1]  # (n, F, B-2) candidates
    hl = inclusive_scan(h[..., :-1])[..., :-1]
    lam, mcw = reg_lambda, min_child_weight

    if monotone is None:
        parent = (g_tot * g_tot) / (h_tot + lam)

        def gain_of(gl_, hl_):
            gr_, hr_ = g_tot - gl_, h_tot - hl_
            gain = 0.5 * ((gl_ * gl_) / (hl_ + lam) + (gr_ * gr_) / (hr_ + lam) - parent)
            ok = (hl_ >= mcw) & (hr_ >= mcw)
            return torch.where(ok, gain, torch.full_like(gain, float("-inf")))
    else:
        if node_bounds is None:
            raise ValueError("node_bounds is required with monotone")
        lo = node_bounds[:, 0][:, None, None]
        hi = node_bounds[:, 1][:, None, None]
        c = monotone.to(torch.int32)[None, :, None]
        parent = gain_at_weight(g_tot, h_tot,
                                 torch.clamp(-g_tot / (h_tot + lam), lo, hi), lam)

        def gain_of(gl_, hl_):
            gr_, hr_ = g_tot - gl_, h_tot - hl_
            wl = torch.clamp(-gl_ / (hl_ + lam), lo, hi)
            wr = torch.clamp(-gr_ / (hr_ + lam), lo, hi)
            gain = 0.5 * (gain_at_weight(gl_, hl_, wl, lam)
                          + gain_at_weight(gr_, hr_, wr, lam) - parent)
            ok = (hl_ >= mcw) & (hr_ >= mcw)
            ok &= (c == 0) | ((c > 0) & (wl <= wr)) | ((c < 0) & (wl >= wr))
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
    out = torch.stack(
        [take(gain), best[..., 0].to(torch.float32), bdl.to(torch.float32),
         gl_best, hl_best],
        dim=-1,
    )
    if feature_mask is not None:
        keep = feature_mask.to(torch.bool).expand(out.shape[:2])[..., None]
        masked = torch.tensor([float("-inf"), 0.0, 0.0, 0.0, 0.0], dtype=out.dtype,
                              device=out.device)
        out = torch.where(keep, out, masked)
    return out


def quantile_cuts_ref(
    srt: torch.Tensor,  # (n, F) f32 column-sorted, +inf tail
    n_valid: torch.Tensor,  # (F,) finite count per column
    max_bins: int,
) -> torch.Tensor:
    """Plain version of the cut-selection kernel: the ascending cuts (F,
    max_bins - 2) with a +inf tail that `repro.kernels.quantile_cuts.
    quantile_cuts_from_sorted` returns. The candidates follow the arithmetic
    of `repro.core.quantile` (`select_cuts_from_sorted`) operation for
    operation, with true f32 division for the rank fractions; a candidate
    not above its predecessor becomes +inf, and `torch.sort` moves those
    markers to the tail."""
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
    return torch.sort(torch.where(cand > prev, cand, inf), dim=-1).values


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
    """Plain version of the ensemble-traversal kernel, on the arena fields
    (the kernel reads them packed): margins (N, K) without base_score. Tree
    t feeds class t % K; each class sums its leaves in tree order, as each
    kernel thread does."""
    leaves = ensemble_leaves_ref(feature, threshold, default_left, leaf_value,
                                 is_leaf, x, max_depth)
    n_trees, n_rows = leaves.shape
    acc = torch.zeros((n_classes, n_rows), dtype=torch.float32, device=x.device)
    for r in range(n_trees // n_classes):
        acc = acc + leaves[r * n_classes:(r + 1) * n_classes]
    return acc.t().contiguous()


# (position, partner) pairs one chunk of the plain pairwise gradient holds.
PAIR_CHUNK_ELEMENTS = 1 << 23


def pairwise_terms_ref(
    scores: torch.Tensor,  # (n,) f32
    labels: torch.Tensor,  # (n,) f32
    order: torch.Tensor,  # (n,) int: rows sorted stably by group id
    start: torch.Tensor,  # (n,) int: each sorted position's group span
    end: torch.Tensor,  # (n,) int
) -> torch.Tensor:
    """(n, 3) float64 in row order: for each row i the sums over its group
    of rho = sigmoid(s_i - s_j) where y_j > y_i (added to g_i), of
    rho = sigmoid(s_j - s_i) where y_i > y_j (taken from g_i), and of
    rho (1 - rho) over both. Each term in float32, as the pairwise kernel
    computes it, the sums in float64, as it adds them.

    Group by group, never an n x n mask: each sorted position's
    (position, partner) pairs are enumerated from its [start, end) span, in
    chunks of at most PAIR_CHUNK_ELEMENTS pairs (a position's whole span
    always fits one chunk). Reads the spans' running total on the host."""
    n = scores.shape[0]
    dev = scores.device
    srt = order.to(torch.int64)
    s, y = scores[srt].to(torch.float32), labels[srt].to(torch.float32)
    st = start.to(torch.int64)
    width = end.to(torch.int64) - st
    total = torch.cumsum(width, 0)
    limits = total.cpu()
    out = torch.zeros((n, 3), dtype=torch.float64, device=dev)  # by sorted position
    a = 0
    while a < n:
        done = int(limits[a - 1]) if a else 0
        b = max(a + 1, int(torch.searchsorted(limits, done + PAIR_CHUNK_ELEMENTS,
                                              right=True)))
        w = width[a:b]
        pos = torch.repeat_interleave(torch.arange(a, b, device=dev), w)
        first = torch.repeat_interleave(total[a:b] - w - done, w)
        part = st[pos] + torch.arange(pos.shape[0], device=dev) - first
        si, sj, yi, yj = s[pos], s[part], y[pos], y[part]
        better, worse = yi > yj, yj > yi
        rho = torch.sigmoid(torch.where(better, sj - si, si - sj))
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        terms = torch.stack([torch.where(worse, rho, zero),
                             torch.where(better, rho, zero),
                             torch.where(better | worse, rho * (1.0 - rho), zero)], dim=1)
        out.index_add_(0, pos, terms.to(torch.float64))
        a = b
    result = torch.empty_like(out)
    result[srt] = out
    return result


def pairwise_grad_ref(
    scores: torch.Tensor,
    labels: torch.Tensor,
    order: torch.Tensor,
    start: torch.Tensor,
    end: torch.Tensor,
) -> torch.Tensor:
    """Plain version of the pairwise-gradient kernel: (n, 2) float32 (g, h)
    in row order, the function of `repro.core.objectives._pairwise_grad`
    over the groups that `ops.query_groups` describes, h floored at 1e-6."""
    t = pairwise_terms_ref(scores, labels, order, start, end)
    g = (t[:, 0] - t[:, 1]).to(torch.float32)
    h = torch.clamp(t[:, 2].to(torch.float32), min=1e-6)
    return torch.stack([g, h], dim=1)
