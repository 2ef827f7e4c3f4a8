"""Boosted trees in plain torch: level histograms, the split scan, leaf
weights, the partition, and the margins they add up to.

The semantics are the paper's depthwise growth (Algorithm 1) as the system
states it: every level histograms (g, h) over (node, feature, bin); a split
(f, b, d) sends a row left when its bin is at most b, a missing bin (the
last) to side d; candidates are the value bins 0 .. max_bins - 3; the gain

    1/2 [GL^2 / (HL + lam) + GR^2 / (HR + lam) - G^2 / (H + lam)]

counts only where both children hold hessian mass min_child_weight or more;
missing values go left only where that gains strictly more; a node splits
where its best gain is positive (gamma 0), ties going to the lowest (feature,
bin); a leaf weighs -G / (H + lam), times the learning rate.

Two uses:

- `judge` follows a fitted model tree by tree, round by round, over the
  reference's own bins: each round's float64 (g, h) come from the
  program's state at that round, the margins that the program's own
  trees and leaves add up to, worked out again in float64. At every node
  the program split it scores the program's split against the best one
  there, at every leaf it weighs the leaf again; at the end it holds the
  program's training margins against that sum. So no difference carries
  from one round into the next: each round is judged from the program's
  own place, as a served model's tokens are.
- `grow` puts the reference in the program's place (the control and the
  planted faults): it chooses the splits itself, in a given precision.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from perfbench.reference import objectives as OBJ

ROW_BLOCK_ELEMENTS = 1 << 25  # (row, feature) entries a histogram block
# min_child_weight is judged with this slack, as a share of the tree's root
# hessian: the program's node sums are float32, the root's a sum over every
# row and each child's its parent's less its sibling's, so a node's hessian
# is good to a few float32 roundings of the root's, and a child within that
# of the limit may fall on either side. The best split is taken over the
# candidates clear of the limit by the slack, the program's over those
# within it.
MCW_SLACK = 2.0**-18


@dataclass(frozen=True)
class Params:
    max_depth: int
    max_bins: int
    learning_rate: float
    reg_lambda: float
    min_child_weight: float
    objective: str


@dataclass
class Trees:
    """Fitted trees as arenas (T, 2^(D+1) - 1), the program's layout:
    leaf weights with the learning rate in them."""

    feature: torch.Tensor
    split_bin: torch.Tensor
    default_left: torch.Tensor
    leaf_value: torch.Tensor
    is_leaf: torch.Tensor
    threshold: torch.Tensor


def histograms(bins: torch.Tensor, gh: torch.Tensor, local: torch.Tensor, n_nodes: int,
               max_bins: int, acc: torch.dtype) -> torch.Tensor:
    """(n_nodes, F, B, 2) sums of gh over the rows whose `local` node index
    lies in [0, n_nodes), accumulated in `acc`, in blocks of rows."""
    n_features = bins.shape[0]
    hist = torch.zeros((n_nodes * n_features * max_bins, 2), dtype=acc, device=gh.device)
    rows = torch.nonzero((local >= 0) & (local < n_nodes))[:, 0]
    block = max(1, ROW_BLOCK_ELEMENTS // n_features)
    feats = torch.arange(n_features, device=gh.device)[:, None]
    for r0 in range(0, rows.shape[0], block):
        r = rows[r0:r0 + block]
        idx = (local[r][None, :] * n_features + feats) * max_bins + bins[:, r].to(torch.int64)
        src = gh[r].to(acc)[None].expand(n_features, -1, -1)
        hist.index_add_(0, idx.reshape(-1), src.reshape(-1, 2))
    return hist.view(n_nodes, n_features, max_bins, 2)


def scan(hist: torch.Tensor, p: Params, dtype: torch.dtype, slack: float = 0.0):
    """Gains of every candidate of every node in `dtype`: (gain with the
    missing bin right, gain with it left), each (N, F, B - 2), -inf where a
    child's hessian is under min_child_weight less `slack`; the nodes' (G,
    H); and the left hessians with the missing bin right (N, F, B - 2)."""
    hist = hist.to(dtype)
    tot = hist[:, 0].sum(dim=1)  # (N, 2): every row of a node is in feature 0
    g_tot, h_tot = tot[:, None, None, 0], tot[:, None, None, 1]
    g, h = hist[..., 0], hist[..., 1]
    gl = torch.cumsum(g[..., :-1], dim=-1)[..., :-1]
    hl = torch.cumsum(h[..., :-1], dim=-1)[..., :-1]
    gm, hm = g[..., -1:], h[..., -1:]
    lam = p.reg_lambda
    mcw = p.min_child_weight - slack
    parent = g_tot * g_tot / (h_tot + lam)

    def gain(gl_, hl_):
        gr_, hr_ = g_tot - gl_, h_tot - hl_
        val = 0.5 * (gl_ * gl_ / (hl_ + lam) + gr_ * gr_ / (hr_ + lam) - parent)
        return torch.where((hl_ >= mcw) & (hr_ >= mcw), val, float("-inf"))

    return gain(gl, hl), gain(gl + gm, hl + hm), tot, hl


def best_splits(gain_r: torch.Tensor, gain_l: torch.Tensor):
    """Per node: the best gain, its feature, bin and missing direction, the
    first maximum in (feature, bin) order."""
    dl = gain_l > gain_r
    gain = torch.where(dl, gain_l, gain_r)
    n, n_features, n_cand = gain.shape
    flat = torch.argmax(gain.reshape(n, -1), dim=1)
    nodes = torch.arange(n, device=gain.device)
    f, b = flat // n_cand, flat % n_cand
    return gain[nodes, f, b], f, b, dl[nodes, f, b]


def route(bins: torch.Tensor, node: torch.Tensor, rows: torch.Tensor, feature: torch.Tensor,
          split_bin: torch.Tensor, default_left: torch.Tensor, max_bins: int) -> torch.Tensor:
    """New arena nodes of `rows`, each at a node split by (feature,
    split_bin, default_left), all (A,) arena arrays."""
    at = node[rows]
    f = feature[at].to(torch.int64)
    v = bins[f, rows].to(torch.int64)
    left = torch.where(v == max_bins - 1, default_left[at], v <= split_bin[at].to(torch.int64))
    return torch.where(left, 2 * at + 1, 2 * at + 2)


@dataclass
class Readings:
    """What `judge` found, and the work of each level.

    Compared: `split_regret`, the widest shortfall of a chosen split's gain
    below the node's best (relative to the larger of the best and the
    median best gain of the fit; a node left a leaf where a split gains
    counts its best gain); `leaf_gap`, the leaves' gaps weighted by their
    rows, sum rows |w - w_ref| / sum rows |w_ref|; `margin_gap`, the root
    mean square of the gaps between the program's final training margins
    and the float64 sum of its own trees' leaves, over that of the sum;
    `threshold_mismatch`, splits whose raw threshold is not the
    reference's cut. Read, not compared: the widest leaf and margin gaps
    and where the widest leaf gap was."""

    split_regret: float = 0.0
    leaf_gap: float = 0.0
    margin_gap: float = 0.0
    threshold_mismatch: int = 0
    leaf_gap_max: float = 0.0
    margin_gap_max: float = 0.0
    worst_leaf: dict = field(default_factory=dict)
    worst_split: dict = field(default_factory=dict)
    hist_rows: list = field(default_factory=list)  # [round][level] rows histogrammed


def node_sums(gh: torch.Tensor, local: torch.Tensor, n_nodes: int, acc: torch.dtype):
    """(n_nodes, 2) sums of gh over each node's rows."""
    keep = (local >= 0) & (local < n_nodes)
    out = torch.zeros((n_nodes, 2), dtype=acc, device=gh.device)
    return out.index_add_(0, local[keep], gh[keep].to(acc))


def _level_hist(bins, gh, node, level, prev, max_bins, acc):
    """Full histograms of the level's nodes, the subtraction trick below the
    root: the left children built over their rows, the right ones as the
    parent's less the left."""
    off, nn = 2**level - 1, 2**level
    local = node - off
    if level == 0:
        return histograms(bins, gh, local, 1, max_bins, acc)
    left_parent = torch.where((local >= 0) & (local < nn) & (local % 2 == 0), local // 2, -1)
    left = histograms(bins, gh, left_parent, nn // 2, max_bins, acc)
    return torch.stack([left, prev - left], dim=1).reshape(nn, *left.shape[1:])


def judge(trees: Trees, margins: torch.Tensor, bins: torch.Tensor, cut: torch.Tensor,
          y: torch.Tensor, p: Params, blocks: OBJ.QueryBlocks | None = None,
          base_score: float = 0.0) -> Readings:
    """Follow the program's trees (arenas on the reference's device) and
    its final training margins (n,), in float64."""
    f64 = torch.float64
    n = y.shape[0]
    dev = y.device
    depth, mb = p.max_depth, p.max_bins
    m = torch.full((n,), float(base_score), dtype=f64, device=dev)
    out = Readings()
    best_split, chosen, best_leafy = [], [], []  # over the fit's split / leaf nodes
    split_where = []
    leaf_prog, leaf_ref, leaf_rows, leaf_where = [], [], [], []
    all_rows = torch.arange(n, device=dev)
    for t in range(trees.feature.shape[0]):
        feature, split_bin = trees.feature[t], trees.split_bin[t]
        default_left, is_leaf = trees.default_left[t], trees.is_leaf[t]
        gh = OBJ.gradient(p.objective, m, y, f64, blocks)
        node = torch.zeros(n, dtype=torch.int64, device=dev)
        active = torch.zeros_like(is_leaf)
        active[0] = True
        weight = torch.zeros(is_leaf.shape[0], dtype=f64, device=dev)
        prev = None
        hist_rows = []
        for level in range(depth + 1):
            off, nn = 2**level - 1, 2**level
            lvl = slice(off, off + nn)
            local = node - off
            at_level = (local >= 0) & (local < nn)
            counts = torch.bincount(local[at_level], minlength=nn)
            if level == depth:
                tot = node_sums(gh, local, nn, f64)
            else:
                hist = _level_hist(bins, gh, node, level, prev, mb, f64)
                if level == 0:
                    slack = MCW_SLACK * float(hist[0, 0, :, 1].sum())
                gain_r, gain_l, tot, hl_all = scan(hist, p, f64, -slack)
                loose_r, loose_l, _, _ = scan(hist, p, f64, slack)
                if level == 0:
                    hist_rows.append(n)
                else:
                    pairs = counts.view(-1, 2)
                    split_par = active[lvl].view(-1, 2)[:, 0]
                    hist_rows.append(int(torch.where(split_par, pairs.min(dim=1).values,
                                                     0).sum()))
            act = active[lvl]
            leaves = act & (is_leaf[lvl] | torch.tensor(level == depth, device=dev))
            weight[lvl] = torch.where(leaves, -tot[:, 0] / (tot[:, 1] + p.reg_lambda)
                                      * p.learning_rate, 0.0)
            leaf_prog.append(trees.leaf_value[t, lvl][leaves].to(f64))
            leaf_ref.append(weight[lvl][leaves])
            leaf_rows.append(counts[leaves].to(f64))
            leaf_where.append(torch.stack([torch.full_like(counts[leaves], t),
                                           torch.nonzero(leaves)[:, 0] + off, counts[leaves]], 1))
            if level == depth:
                break
            best, _, _, _ = best_splits(gain_r, gain_l)
            splits = act & ~is_leaf[lvl]
            nodes = torch.nonzero(splits)[:, 0]
            f_p = feature[lvl][nodes].to(torch.int64)
            b_p = split_bin[lvl][nodes].to(torch.int64)
            ok = (b_p >= 0) & (b_p < gain_r.shape[2]) & (f_p >= 0) & (f_p < gain_r.shape[1])
            fc, bc = torch.clamp(f_p, 0, gain_r.shape[1] - 1), torch.clamp(b_p, 0, gain_r.shape[2] - 1)
            pick = torch.where(default_left[lvl][nodes], loose_l[nodes, fc, bc],
                               loose_r[nodes, fc, bc])
            best_split.append(best[nodes])
            chosen.append(torch.where(ok, pick, float("-inf")))
            dl_p = default_left[lvl][nodes]
            hl_p = hl_all[nodes, fc, bc] + torch.where(dl_p, hist[nodes, fc, -1, 1], 0.0)
            split_where.append(torch.stack([
                torch.full_like(hl_p, t), (nodes + off).to(f64), f_p.to(f64), b_p.to(f64),
                dl_p.to(f64), counts[nodes].to(f64), tot[nodes, 1], hl_p, tot[nodes, 1] - hl_p],
                dim=1))
            best_leafy.append(best[act & is_leaf[lvl]])
            thr = cut[fc, torch.clamp(bc, max=cut.shape[1] - 1)]
            out.threshold_mismatch += int((trees.threshold[t, off + nodes] != thr).sum())
            moving = at_level & splits[torch.clamp(local, 0, nn - 1)]
            rows = all_rows[moving]
            node[rows] = route(bins, node, rows, feature, split_bin, default_left, mb)
            active[2 * off + 1:2 * off + 1 + 2 * nn] = splits.repeat_interleave(2)
            prev = hist
        m += trees.leaf_value[t].to(f64)[node]  # the program's state, its own leaves
        out.hist_rows.append(hist_rows)
    bs, ch = torch.cat(best_split), torch.cat(chosen)
    finite_best = bs[torch.isfinite(bs)]
    scale = float(finite_best.median()) if finite_best.numel() else 1.0
    scale = max(scale, 1e-30)
    regret = torch.where(torch.isfinite(ch),
                         torch.clamp(bs - ch, min=0.0) / torch.clamp(bs, min=scale),
                         float("inf"))
    bl = torch.cat(best_leafy)
    missed = torch.clamp(torch.where(torch.isfinite(bl), bl, 0.0), min=0.0) / torch.clamp(
        bl, min=scale)
    out.split_regret = float(torch.cat([regret, missed, regret.new_zeros(1)]).max())
    if regret.numel():
        w = int(torch.argmax(torch.nan_to_num(regret, posinf=1e308)))
        keys = ("round", "node", "feature", "bin", "default_left", "rows", "hessian",
                "left_hessian", "right_hessian")
        out.worst_split = dict(zip(keys, torch.cat(split_where)[w].tolist()))
        out.worst_split.update(best=float(bs[w]), chosen=float(ch[w]), regret=float(regret[w]),
                               slack=slack)
    lp, lr_, rows_ = torch.cat(leaf_prog), torch.cat(leaf_ref), torch.cat(leaf_rows)
    out.leaf_gap = float((rows_ * (lp - lr_).abs()).sum() / max(float((rows_ * lr_.abs()).sum()),
                                                               1e-300))
    leaf_scale = max(float(lr_.abs().median()) if lr_.numel() else 0.0, 1e-30)
    rel = (lp - lr_).abs() / torch.clamp(lr_.abs(), min=leaf_scale)
    out.leaf_gap_max = float(rel.max())
    w = int(torch.argmax(rel))
    t_, a_, r_ = torch.cat(leaf_where)[w].tolist()
    out.worst_leaf = {"round": t_, "node": a_, "rows": r_, "program": float(lp[w]),
                      "reference": float(lr_[w])}
    dm = margins.reshape(-1).to(f64) - m
    out.margin_gap = float(dm.square().mean().sqrt() / max(float(m.square().mean().sqrt()), 1e-300))
    out.margin_gap_max = float(dm.abs().max() / max(float(m.abs().max()), 1e-300))
    return out


@dataclass
class Fault:
    """A fault planted in the reference put in the program's place: a round
    whose trees leave the margins unchanged (`stale_round`), half of the rows
    left out of (g, h) with the rest doubled (`half_batch`), one leaf of one
    round altered by a factor (`alter_round`, `alter_factor`)."""

    stale_round: int = -1
    half_batch: bool = False
    alter_round: int = -1
    alter_factor: float = 1.1


def grow(bins: torch.Tensor, cut: torch.Tensor, y: torch.Tensor, p: Params, rounds: int,
         dtype: torch.dtype, blocks: OBJ.QueryBlocks | None = None,
         fault: Fault | None = None, base_score: float = 0.0):
    """The reference in the program's place: (Trees, final margins (n,)).
    The cuts and bins are the reference's (integers from float32 features);
    every float of the arithmetic, (g, h), histograms, gains, leaf weights
    and margins, is in `dtype`, the histograms accumulated one precision
    wider (float32 -> float64, bfloat16 -> float32) and rounded back."""
    fault = fault or Fault()
    acc = torch.float64 if dtype == torch.float32 else torch.float32
    n = y.shape[0]
    dev = y.device
    depth, mb = p.max_depth, p.max_bins
    a = 2 ** (depth + 1) - 1
    m = torch.full((n,), float(base_score), dtype=dtype, device=dev)
    fields = {k: [] for k in ("feature", "split_bin", "default_left", "leaf_value",
                              "is_leaf", "threshold")}
    all_rows = torch.arange(n, device=dev)
    for r in range(rounds):
        gh = OBJ.gradient(p.objective, m, y, dtype, blocks)
        if fault.half_batch:
            gh = gh * (2.0 * (all_rows % 2 == 0)).to(dtype)[:, None]
        feature = torch.zeros(a, dtype=torch.int32, device=dev)
        split_bin = torch.zeros(a, dtype=torch.int32, device=dev)
        default_left = torch.zeros(a, dtype=torch.bool, device=dev)
        is_leaf = torch.zeros(a, dtype=torch.bool, device=dev)
        weight = torch.zeros(a, dtype=dtype, device=dev)
        active = torch.zeros(a, dtype=torch.bool, device=dev)
        active[0] = True
        node = torch.zeros(n, dtype=torch.int64, device=dev)
        prev = None
        for level in range(depth + 1):
            off, nn = 2**level - 1, 2**level
            lvl = slice(off, off + nn)
            if level == depth:
                tot = node_sums(gh, node - off, nn, acc).to(dtype)
            else:
                hist = _level_hist(bins, gh, node, level, prev, mb, acc).to(dtype)
                gain_r, gain_l, tot, _ = scan(hist, p, dtype)
            act = active[lvl]
            leaf_w = (-tot[:, 0] / (tot[:, 1] + p.reg_lambda) * p.learning_rate).to(dtype)
            if level == depth:
                is_leaf[lvl] = act
                weight[lvl] = torch.where(act, leaf_w, 0.0)
                break
            best, f, b, dl = best_splits(gain_r, gain_l)
            splits = act & (best > 0) & torch.isfinite(best)
            is_leaf[lvl] = act & ~splits
            weight[lvl] = torch.where(act & ~splits, leaf_w, 0.0)
            feature[lvl] = torch.where(splits, f, 0).to(torch.int32)
            split_bin[lvl] = torch.where(splits, b, 0).to(torch.int32)
            default_left[lvl] = splits & dl
            local = node - off
            moving = (local >= 0) & (local < nn) & splits[torch.clamp(local, 0, nn - 1)]
            rows = all_rows[moving]
            node[rows] = route(bins, node, rows, feature, split_bin, default_left, mb)
            active[2 * off + 1:2 * off + 1 + 2 * nn] = splits.repeat_interleave(2)
            prev = hist.to(acc)
        if r == fault.alter_round:  # the leaf that holds the most rows
            most = int(torch.argmax(torch.bincount(node, minlength=a)))
            weight[most] = weight[most] * fault.alter_factor
        if r != fault.stale_round:
            m = (m + weight[node]).to(dtype)
        thr = cut[feature.to(torch.int64), torch.clamp(split_bin.to(torch.int64),
                                                        max=cut.shape[1] - 1)]
        for k, v in (("feature", feature), ("split_bin", split_bin),
                     ("default_left", default_left), ("leaf_value", weight.to(torch.float32)),
                     ("is_leaf", is_leaf),
                     ("threshold", torch.where(is_leaf, float("inf"), thr))):
            fields[k].append(v)
    return Trees(**{k: torch.stack(v) for k, v in fields.items()}), m.to(torch.float32)
