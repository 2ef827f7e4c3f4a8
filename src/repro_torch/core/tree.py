"""Decision tree construction (paper §2.3, Algorithm 1); counterpart of
`repro.core.tree` for single-device growth on the packed matrix
(`PackedBins`), on the external-memory chunk stack (`ChunkedPackedBins`:
both histogram kernels read the whole stack in one launch a level, and
routing reads each row's word from its chunk), on the streamed stack
(`stream.StreamedChunkedBins`: one launch a chunk, the stack paged chunk by
chunk) or on dense (n, f) int32 bins (`compress_matrix=False`). Every bins
type answers the same calls (`histograms`, `histograms_rows`,
`feature_bins`), so growth never asks which one it reads.

The tree grows level-synchronously into a fixed arena of 2^(max_depth+1) - 1
node slots. Every level: one histogram over all its nodes, split evaluation
(the split-scan kernel plus a small epilogue), then row repartition.

Histograms, as in the reference: the root level is built in full (from the
packed words by the privatised histogram kernel on the card; from dense
bins by a plain-torch scatter, as the reference builds them in XLA); below
it the subtraction trick builds only each parent's smaller child, over a
compacted row buffer (the row-id histogram kernel on packed words, a
scatter over the gathered dense rows otherwise), and derives the sibling as
parent - child. A given `hist_builder` turns subtraction off and builds
every level in full.

Sharded growth (`collective`, inside `dist.spmd`): the bins and (g, h)
are one shard's rows, every level is histogrammed in full and reduced by
the collective (the paper's AllReduceHistograms), and every shard grows
the same tree from the reduced histograms.

Feature-sharded growth (`feature_axis`, a mesh axis name, inside
`dist.spmd`; DESIGN.md §3): the dense bins and the cuts hold this
position's slice of the features as well. Histograms stay feature-local
(reduced over the row axes only), each position evaluates its features,
and one all-gather a level of a small record per node picks the winner
(the lowest global feature id among equal gains); the owner of a split's
feature routes the rows and a psum over the feature axis hands the route,
and at the end the thresholds, to every position.

Growth strategies: "depthwise" expands every node whose best gain > 0;
"lossguide" spends a `max_leaves` budget, letting only the top-k gains of
each level split, k = the budget left.

Sampling and constraints (`ctx`, a `sampling.TreeContext`; DESIGN.md §12):
with `ctx.row_ids` set the tree grows over the sampled-row buffer only —
gh is the buffer's (m, 2), positions live in buffer space, the root's
histogram is the row-id kernel over the buffer, the subtraction trick
compacts buffer slots and maps them to rows, and routing reads each slot's
bin through its row id. On dense bins the buffer's rows are gathered once
and the tree grows as usual. Feature masks come from the context every
level; monotone constraints carry [lower, upper] bounds down the arena,
clip every leaf to its node's bounds and reach the split scan. Everything
stays on the device, with no host read. `ctx=None` is the program without
sampling.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import compress as C
from repro_torch.core import histogram as H
from repro_torch.core import partition as P
from repro_torch.core import sampling as SMP
from repro_torch.core import split as S


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
    bins,  # a bins type (PackedBins, ChunkedPackedBins, StreamedChunkedBins) or dense bins
    gh: torch.Tensor,  # (n, 2) float32
    cuts: torch.Tensor,  # (f, n_cuts) float32
    max_depth: int,
    max_bins: int,
    params: S.SplitParams = S.SplitParams(),
    growth: str = "depthwise",
    max_leaves: int = 0,  # only used by lossguide
    hist_builder=None,  # optional builder (kernels.ops), every level in full
    ctx: SMP.TreeContext | None = None,  # sampling and constraints
    collective=None,  # a dist.Collective: this shard's rows, histograms reduced
    feature_axis: str | None = None,  # mesh axis over which the features are sharded
) -> Tree:
    """Grow one tree from a bins type (the packed matrix, the chunk stack,
    resident or streamed) or the dense (n, f) bins and the rows' (g, h)
    pairs (with `ctx.row_ids` set: the sampled buffer's).
    `hist_builder(bins, gh, positions, n_nodes, max_bins)` receives the
    matrix as given; it is refused on either chunk stack, as the reference
    refuses it.

    With a `collective` (inside `dist.spmd`) the bins and gh are this
    shard's rows: the root sum goes through `collective.allreduce` and each
    level's histogram, built in full (no subtraction trick), through
    `collective.allreduce_hist`, so every shard grows the same tree; rows
    are sampled in masked mode only, and streamed bins are refused.

    With `feature_axis` (inside `dist.spmd`) `bins` are dense and, with
    `cuts`, hold only this position's slice of the features; its index on
    the axis (`mesh.coords(position)[feature_axis]`, what
    `jax.lax.axis_index` is to the reference) places that slice. The row
    axes reduce through `collective`: the reference's `axis_name="data"`
    is `collective=PsumCollective(mesh, ("data",))`. Every position
    returns the same tree, with global feature ids. Column sampling draws
    at the local width with the same path on every position, as the
    reference does. Monotone constraints are refused: the reference looks
    a split's sign up by global feature id in a vector of the local width
    (`repro/core/tree.py:322`), which JAX clamps and the card would fault
    on."""
    if growth not in ("depthwise", "lossguide"):
        raise ValueError(f"growth must be 'depthwise' or 'lossguide', got {growth!r}")
    # Every bins type answers the same calls; only dense bins take other paths.
    packed_mode = not isinstance(bins, torch.Tensor) and hasattr(bins, "histograms_rows")
    if not packed_mode and not (isinstance(bins, torch.Tensor) and bins.ndim == 2):
        raise TypeError("grow_tree takes a bins type (compress.PackedBins, "
                        "compress.ChunkedPackedBins, stream.StreamedChunkedBins) or "
                        "dense (n, f) bins")
    sharded = collective is not None or feature_axis is not None
    if sharded and packed_mode and not isinstance(bins, (C.PackedBins, C.ChunkedPackedBins)):
        raise NotImplementedError(
            "streamed out-of-core growth is single-shard with the default "
            "builders; use resident paging for sharded or kernel fits"
        )
    if feature_axis is not None and packed_mode:
        raise NotImplementedError(
            "feature-sharded growth requires dense bins (unpack per shard)"
        )
    if packed_mode and not isinstance(bins, C.PackedBins) and hist_builder is not None:
        raise NotImplementedError(
            "custom/kernel hist builders are not chunk-aware; use the "
            "default builders for external-memory training"
        )
    dev = gh.device
    n, f = (bins.n_rows, bins.n_features) if packed_mode else bins.shape
    na = arena_size(max_depth)
    missing_bin = max_bins - 1

    stoch = ctx.params if ctx is not None else None
    row_ids = ctx.row_ids if ctx is not None else None
    if row_ids is not None:
        if hist_builder is not None:
            raise NotImplementedError(
                "custom/kernel hist builders are not row-subset aware; use "
                "masked-mode subsampling (ctx.row_ids=None) with them"
            )
        if sharded:
            raise NotImplementedError(
                "sharded growth uses masked-mode subsampling "
                "(ctx.row_ids=None); compact buffers are single-shard only"
            )
        if not packed_mode:
            # Dense bins: gather the sampled rows once, then grow as usual.
            bins, row_ids = bins[row_ids.to(torch.int64)], None
        n = gh.shape[0]  # the buffer's size m: positions live there
    mono_on = stoch is not None and stoch.monotone_on
    if mono_on and feature_axis is not None:
        raise NotImplementedError(
            "monotone constraints are not supported with feature_axis: the "
            "reference looks a split's sign up by global feature id in a "
            "vector of the local width (repro/core/tree.py:322), a clamped "
            "gather in JAX that would read out of range on the card"
        )
    if mono_on:
        if len(stoch.monotone) != f:
            raise ValueError(
                f"monotone constraints cover {len(stoch.monotone)} features "
                f"but the matrix has {f}"
            )
        mono = torch.tensor(stoch.monotone, dtype=torch.int8, device=dev)
        lower = torch.full((na,), float("-inf"), dtype=torch.float32, device=dev)
        upper = torch.full((na,), float("inf"), dtype=torch.float32, device=dev)

    feature = torch.zeros(na, dtype=torch.int32, device=dev)
    split_bin = torch.zeros(na, dtype=torch.int32, device=dev)
    default_left = torch.zeros(na, dtype=torch.bool, device=dev)
    leaf_value = torch.zeros(na, dtype=torch.float32, device=dev)
    is_leaf = torch.zeros(na, dtype=torch.bool, device=dev)
    gain = torch.full((na,), float("-inf"), dtype=torch.float32, device=dev)
    node_sum = torch.zeros((na, 2), dtype=torch.float32, device=dev)
    active = torch.zeros(na, dtype=torch.bool, device=dev)

    positions = torch.zeros(n, dtype=torch.int32, device=dev)  # all at the root
    root_sum = gh.sum(dim=0)
    node_sum[0] = root_sum if collective is None else collective.allreduce(root_sum)
    active[0] = True
    # lossguide leaf budget: a tree starts as 1 leaf; each split adds 1.
    budget = torch.tensor(max(max_leaves - 1, 0) if growth == "lossguide" else na,
                          device=dev)

    f_off = 0  # this position's first global feature id
    if feature_axis is not None:
        from repro_torch.dist import group as G  # dist imports this module

        shard = G.current_shard()
        f_off = shard.group.mesh.coords(shard.position)[feature_axis] * f

    hist_prev = None

    for level in range(max_depth):
        off, n_nodes = level_offset(level), 2**level
        lvl = slice(off, off + n_nodes)

        # --- BuildPartialHistograms ---------------------------------------
        in_level = (positions >= off) & (positions < off + n_nodes)
        local = torch.where(in_level, positions - off, n_nodes).to(torch.int32)
        full = level == 0 or sharded  # sharded: no subtraction
        if hist_builder is not None:
            hist = hist_builder(bins, gh, local, n_nodes, max_bins)
        elif full and row_ids is not None:
            hist = bins.histograms_rows(gh, local, row_ids, n_nodes, max_bins)
        elif full and packed_mode:
            hist = bins.histograms(gh, local, n_nodes, max_bins)
        elif full:
            hist = H.build_histograms(bins, gh, local, n_nodes, max_bins)
        else:
            hist = _histograms_by_subtraction(bins, gh, local, hist_prev,
                                              n_nodes, max_bins, row_ids=row_ids)
        if collective is not None:  # AllReduceHistograms
            hist = collective.allreduce_hist(hist)
        hist_prev = hist

        # --- EvaluateSplit --------------------------------------------------
        parent = node_sum[lvl]
        feature_mask = (SMP.level_feature_mask(ctx, level, n_nodes, f)
                        if ctx is not None else None)
        if mono_on:
            lvl_lo, lvl_hi = lower[lvl], upper[lvl]
            sp = S.evaluate_splits(hist, parent, params, feature_mask=feature_mask,
                                   monotone=mono,
                                   node_bounds=torch.stack([lvl_lo, lvl_hi], dim=-1))
        else:
            sp = S.evaluate_splits(hist, parent, params, feature_mask=feature_mask)
        if feature_axis is not None:
            sp = _combine_feature_shards(sp, f_off, feature_axis)
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
        lvl_leaf = S.leaf_value(parent, params.reg_lambda)
        if mono_on:  # leaf weights respect the inherited bounds
            lvl_leaf = torch.clamp(lvl_leaf, lvl_lo, lvl_hi)
        leaf_value[lvl] = torch.where(stays_leaf, lvl_leaf, 0.0)

        # Children's sums come from the split evaluation (no extra pass).
        kids = slice(2 * off + 1, 2 * (off + n_nodes) + 1)
        node_sum[kids] = torch.where(
            will_split[:, None, None],
            torch.stack([sp.left_sum, sp.right_sum], dim=1), 0.0,
        ).reshape(-1, 2)
        active[kids] = will_split.repeat_interleave(2)

        if mono_on:
            # Monotone bound propagation (XGBoost's scheme): the midpoint of
            # the clipped child weights becomes the dividing bound on the
            # constrained side; the other side inherits the parent's bound.
            wl = torch.clamp(S.leaf_value(sp.left_sum, params.reg_lambda), lvl_lo, lvl_hi)
            wr = torch.clamp(S.leaf_value(sp.right_sum, params.reg_lambda), lvl_lo, lvl_hi)
            mid = 0.5 * (wl + wr)
            csign = mono[sp.feature.to(torch.int64)]
            keep = ~will_split
            lo_kids = torch.stack([torch.where(csign < 0, mid, lvl_lo),
                                   torch.where(csign > 0, mid, lvl_lo)], dim=1)
            hi_kids = torch.stack([torch.where(csign > 0, mid, lvl_hi),
                                   torch.where(csign < 0, mid, lvl_hi)], dim=1)
            lower[kids] = torch.where(keep[:, None], float("-inf"), lo_kids).reshape(-1)
            upper[kids] = torch.where(keep[:, None], float("inf"), hi_kids).reshape(-1)

        # --- RepartitionInstances ------------------------------------------
        split_mask = torch.zeros(na, dtype=torch.bool, device=dev)
        split_mask[lvl] = will_split
        if packed_mode:
            positions = P.update_positions_on(bins, positions, split_mask, feature,
                                              split_bin, default_left, missing_bin,
                                              row_ids=row_ids)
        elif feature_axis is None:
            positions = P.update_positions(bins, positions, split_mask, feature,
                                           split_bin, default_left, missing_bin)
        else:
            positions = _update_positions_feature_sharded(
                bins, positions, split_mask, feature, split_bin, default_left,
                missing_bin, f_off, feature_axis)

    # Final level: every still-active node is a leaf.
    off, n_nodes = level_offset(max_depth), 2**max_depth
    lvl = slice(off, off + n_nodes)
    is_leaf[lvl] = active[lvl]
    final_leaf = S.leaf_value(node_sum[lvl], params.reg_lambda)
    if mono_on:
        final_leaf = torch.clamp(final_leaf, lower[lvl], upper[lvl])
    leaf_value[lvl] = torch.where(active[lvl], final_leaf, 0.0)

    # Raw-space thresholds for prediction on unquantised rows.
    col = torch.clamp(split_bin, 0, cuts.shape[1] - 1).to(torch.int64)
    if feature_axis is None:
        threshold = cuts[feature.to(torch.int64), col]
    else:  # the owner's cut, psum'd over the feature axis
        owned = (feature >= f_off) & (feature < f_off + f)
        local_thr = cuts[torch.clamp(feature - f_off, 0, f - 1).to(torch.int64), col]
        threshold = G.psum(torch.where(owned, local_thr, 0.0), feature_axis)
    threshold = torch.where(is_leaf, float("inf"), threshold)
    return Tree(feature, split_bin, threshold, default_left, leaf_value,
                is_leaf, gain)


def _histograms_by_subtraction(
    bins,  # a bins type or dense (n, f) bins
    gh: torch.Tensor,  # (n, 2)
    local: torch.Tensor,  # (n,) int32 level-local child index, n_nodes = inactive
    hist_prev: torch.Tensor,  # (n_nodes/2, f, max_bins, 2) parents' full hist
    n_nodes: int,
    max_bins: int,
    row_ids: torch.Tensor | None = None,  # sampled growth: slot -> row id
) -> torch.Tensor:
    """Level histogram via the subtraction trick (`repro/core/tree.py`,
    DESIGN.md §7.5).

    Per parent, only the smaller child (by instance count) is histogrammed;
    its sibling is parent - child. Since sum_p min(left_p, right_p) <=
    floor(n/2), a fixed n//2 compaction buffer always suffices. Every step
    has a size known from the shapes, so no level waits on the device.

    With `row_ids` (sampled growth on packed words) everything runs in
    buffer space — gh and local are (m,)-shaped, the compaction buffer is
    m//2 — and only the row ids handed to the kernel map slots to rows.
    """
    n = gh.shape[0]
    dev = gh.device
    n_par = n_nodes // 2
    m = n // 2
    local64 = local.to(torch.int64)
    row = torch.arange(n, device=dev)
    lane = row & (SMP.SPREAD_LANES - 1)

    # Instance counts per child -> smaller-child bit per parent (ties: left).
    # Each child counts into SMP.SPREAD_LANES lanes, summed after: one counter
    # per child would serialise every row's atomic add on the card, and
    # bincount's data-dependent size would cost a host sync.
    ones = torch.ones((), dtype=torch.int64, device=dev).expand(n)
    cnt = torch.zeros((n_nodes + 1) * SMP.SPREAD_LANES, dtype=torch.int64, device=dev)
    cnt = cnt.index_add_(0, local64 * SMP.SPREAD_LANES + lane, ones)
    cnt = cnt.view(n_nodes + 1, SMP.SPREAD_LANES).sum(dim=1)
    small_bit = (cnt[1:n_nodes:2] < cnt[0:n_nodes:2]).to(torch.int64)

    is_active = local64 < n_nodes
    par = torch.clamp(local64 >> 1, max=n_par - 1)
    sel = is_active & ((local64 & 1) == small_bit[par])

    # Compact selected row ids into the n//2 buffer (sentinel n = padding):
    # each selected row goes to its rank among the selected, every other row
    # to one of SMP.SPREAD_LANES slots past the buffer, which are dropped.
    order = torch.cumsum(sel, dim=0) - 1
    buf = torch.full((m + SMP.SPREAD_LANES,), n, dtype=torch.int64, device=dev)
    buf = buf.scatter_(0, torch.where(sel, order, m + lane), row)[:m]
    parent_ext = torch.cat([
        torch.where(sel, par, n_par),
        torch.full((1,), n_par, dtype=torch.int64, device=dev),
    ])
    pos_c = parent_ext[torch.clamp(buf, max=n)]
    gh_c = gh[torch.clamp(buf, max=n - 1)]
    # Padding slots carry row id n; with `row_ids`, slots map to rows and a
    # padding slot to the buffer's last row, as in the reference (so a
    # streamed fit splits the buffer into the reference's segments). Their
    # position is the dump slot, so they contribute nothing.
    if not isinstance(bins, torch.Tensor):  # any bins type
        if row_ids is not None:
            buf = row_ids.to(torch.int64)[torch.clamp(buf, max=n - 1)]
        hist_small = bins.histograms_rows(gh_c, pos_c, buf, n_par, max_bins)
    else:
        hist_small = H.build_histograms(bins[torch.clamp(buf, max=n - 1)], gh_c, pos_c,
                                        n_par, max_bins)

    other = hist_prev - hist_small
    built_left = (small_bit == 0)[:, None, None, None]
    left = torch.where(built_left, hist_small, other)
    right = torch.where(built_left, other, hist_small)
    f = hist_prev.shape[1]
    return torch.stack([left, right], dim=1).reshape(n_nodes, f, max_bins, 2)


def _combine_feature_shards(sp: S.Splits, f_off: int, feature_axis: str) -> S.Splits:
    """The global best split of each node from every feature shard's best
    (`repro/core/tree.py` `_combine_feature_shards`).

    The six fields travel as one record of 8 float32 words a node (gain,
    feature, split_bin, default_left, left (G, H), right (G, H); the
    integers reinterpreted, the bool as 0 / 1), all-gathered over the
    feature axis in one exchange. The first maximum in shard order wins,
    as `jnp.argmax` picks it: among equal gains the lowest global feature
    id, the unsharded scan's choice."""
    from repro_torch.dist import group as G  # dist imports this module

    def as_words(t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.int32)[:, None].view(torch.float32)

    n = sp.gain.shape[0]
    rec = torch.cat([sp.gain[:, None], as_words(sp.feature + f_off), as_words(sp.split_bin),
                     as_words(sp.default_left), sp.left_sum, sp.right_sum], dim=1)
    every = G.all_gather(rec, feature_axis).view(-1, n, 8)  # (p, n, 8) in shard order
    win = torch.argmax(every[..., 0], dim=0)  # the first maximum
    best = torch.gather(every, 0, win[None, :, None].expand(1, n, 8))[0]
    ints = best[:, 1:4].contiguous().view(torch.int32)
    return S.Splits(best[:, 0].contiguous(), ints[:, 0].contiguous(), ints[:, 1].contiguous(),
                    ints[:, 2] != 0, best[:, 4:6].contiguous(), best[:, 6:8].contiguous())


def _update_positions_feature_sharded(
    bins: torch.Tensor,  # (n, f_local) int32: this position's features
    positions: torch.Tensor,  # (n,) int32 arena node ids, -1 = inactive
    split_mask: torch.Tensor,  # (n_arena,) bool
    feature: torch.Tensor,  # (n_arena,) int32 GLOBAL feature ids
    split_bin: torch.Tensor,
    default_left: torch.Tensor,
    missing_bin: int,
    f_off: int,  # this position's first global feature id
    feature_axis: str,
) -> torch.Tensor:
    """RepartitionInstances when a split's feature may live on another
    feature shard (`repro/core/tree.py` `_update_positions_feature_sharded`):
    the owner computes each row's route (1 left, 2 right, 0 otherwise), an
    int8 psum over the feature axis hands it to every position (exact: one
    shard adds a non-zero value), and child = 2 pos + route."""
    from repro_torch.dist import group as G  # dist imports this module

    f_local = bins.shape[1]
    pos = torch.clamp(positions, min=0).to(torch.int64)
    splits_here = split_mask[pos] & (positions >= 0)
    f_glob = feature[pos]
    owned = (f_glob >= f_off) & (f_glob < f_off + f_local)
    f_loc = torch.clamp(f_glob - f_off, 0, f_local - 1).to(torch.int64)
    b = torch.gather(bins, 1, f_loc[:, None])[:, 0]
    go_left = torch.where(b == missing_bin, default_left[pos], b <= split_bin[pos])
    route = torch.where(splits_here & owned, torch.where(go_left, 1, 2), 0).to(torch.int8)
    route = G.psum(route, feature_axis).to(torch.int64)
    return torch.where(splits_here, 2 * pos + route, -1).to(torch.int32)
