"""Stochastic training context: per-tree sampling and constraints;
counterpart of `repro.core.sampling` (DESIGN.md §12, §17).

XGBoost's stochastic regularisers (Chen & Guestrin 2016 §2.3), GOSS (Ke et
al. 2017) and monotone constraints, threaded through `grow_tree` as one
object:

  * `StochasticParams` — the static policy (subsample / colsample
    fractions, GOSS rates, monotone constraint vector). `stochastic_params`
    returns None when every knob is at its default, and the booster then
    runs the program it runs without sampling.
  * `TreeContext` — one tree's state: its draw path `(seed, round, class)`,
    the sampled-row buffer (or None in masked mode), the per-tree feature
    mask and the device the draws are made on.

Draws. Every random number comes from `uniform(path, shape, device)`.
`path` is the reference's chain of `fold_in`s as integers: the seed, the
absolute round, the class, then the draw site's tag (and the level for the
per-level and per-node column draws). The reference folds the same chain
into its JAX key, so a test that replaces `uniform` with the reference's
`jax.random.uniform` at that key replays the reference's draws exactly,
and every selection made from them (sorts, ranks, compaction) must then
equal the reference's bit for bit.

The port's own `uniform` seeds a `torch.Generator` on the device with a
splitmix64 mix of the path: deterministic for a path, independent of any
global RNG state, and free of host reads. The CPU's generator and the
card's (Philox) give different streams for the same path, and neither is
the reference's (JAX's threefry), so a fit with sampling is reproducible on
one kind of device, not across kinds.

Row subsampling has two executions with the same semantics:

  * compact mode (the default growth): the `m = round(n * subsample)`
    selected row ids are compacted, ascending, into a buffer, and the tree
    grows over that buffer only (histograms through the row-id kernel).
  * masked mode (`use_kernel_histograms=True`): unselected rows keep their
    (g, h) zeroed instead.

GOSS rides the same two executions: keep the top `a * n` rows by |g|,
uniformly sample `b * n` of the rest and multiply their (g, h) by
`(1 - a) / b`.

The reference's sharded arguments (`n_total`, `row_offset`, `axis_name`)
are not ported: multi-device fits are ROADMAP queue 1 item 5.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

# Fixed tags keep the draw sites' streams disjoint (the reference's values).
TAG_ROWS = 0x517C0DE1
TAG_COLS_TREE = 0x517C0DE2
TAG_COLS_LEVEL = 0x517C0DE3
TAG_COLS_NODE = 0x517C0DE4
TAG_GOSS = 0x517C0DE5

# Counters and dump slots of the row compactions (`compact_row_ids`, the
# subtraction trick's in core/tree.py) are spread over this many lanes, so
# that rows do not all hit one address on the card.
SPREAD_LANES = 1024

_M64 = (1 << 64) - 1


class StochasticParams(NamedTuple):
    """The sampling and constraint policy. `monotone` is a per-feature
    tuple of {-1, 0, +1} or None; fractions are in (0, 1]."""

    subsample: float = 1.0
    colsample_bytree: float = 1.0
    colsample_bylevel: float = 1.0
    colsample_bynode: float = 1.0
    monotone: tuple | None = None
    sampling_method: str = "uniform"
    top_rate: float = 0.2
    other_rate: float = 0.1

    @property
    def row_sampling(self) -> bool:
        return self.subsample < 1.0

    @property
    def goss(self) -> bool:
        return self.sampling_method == "goss"

    @property
    def monotone_on(self) -> bool:
        return self.monotone is not None and any(self.monotone)


def stochastic_params(cfg) -> StochasticParams | None:
    """BoosterConfig -> StochasticParams, or None when every knob is at its
    default (the seed alone then changes nothing)."""
    mono = cfg.monotone_constraints
    if mono is not None and not any(mono):
        mono = None
    if (
        cfg.subsample >= 1.0
        and cfg.colsample_bytree >= 1.0
        and cfg.colsample_bylevel >= 1.0
        and cfg.colsample_bynode >= 1.0
        and mono is None
        and cfg.sampling_method == "uniform"
    ):
        return None
    return StochasticParams(
        subsample=cfg.subsample,
        colsample_bytree=cfg.colsample_bytree,
        colsample_bylevel=cfg.colsample_bylevel,
        colsample_bynode=cfg.colsample_bynode,
        monotone=mono,
        sampling_method=cfg.sampling_method,
        top_rate=cfg.top_rate,
        other_rate=cfg.other_rate,
    )


@dataclass(frozen=True)
class TreeContext:
    """One tree's stochastic state, threaded through grow_tree.

    key: the tree's draw path (seed, round, class), as integers.
    row_ids: (m,) int32 ascending row ids of the subsample, or None (masked
      mode, or no row sampling). When set, the gh grown with it is already
      gathered to the buffer, and positions, histograms and routing all
      live in buffer space.
    feature_mask: (f,) bool per-tree column sample, or None. Level and node
      masks are drawn inside grow_tree (they need the level).
    params: the StochasticParams policy.
    device: where the draws are made (the tree's device).
    """

    key: tuple
    row_ids: torch.Tensor | None
    feature_mask: torch.Tensor | None
    params: StochasticParams
    device: torch.device


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def path_seed(path) -> int:
    """A 64-bit seed from a draw path: splitmix64 folded over its integers."""
    h = 0
    for v in path:
        h = _splitmix64(h ^ (int(v) & _M64))
    return h


def uniform(path, shape, device) -> torch.Tensor:
    """float32 uniforms in [0, 1) of `shape` on `device`, a function of
    `path` only: a generator of that device seeded by `path_seed(path)`.
    The CPU's and the card's generators give different streams for one
    path."""
    gen = torch.Generator(device=device)
    gen.manual_seed(path_seed(path))
    return torch.rand(shape, generator=gen, device=device, dtype=torch.float32)


def sample_size(n: int, frac: float) -> int:
    """round(n * frac) (ties to even), at least 1."""
    return max(1, int(round(n * frac)))


def _rank_along_last(u: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its last axis (0 = smallest; ties: the
    lower index first). One stable sort and the scatter of its inverse
    permutation: the reference's double argsort."""
    order = torch.argsort(u, dim=-1, stable=True)
    ranks = torch.arange(u.shape[-1], device=u.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ranks)


def row_selection_mask(key: tuple, n: int, m: int, device) -> torch.Tensor:
    """(n,) bool with exactly m True: the rows of the m smallest uniforms."""
    u = uniform((*key, TAG_ROWS), (n,), device)
    order = torch.argsort(u, stable=True)
    return torch.zeros(n, dtype=torch.bool, device=device).index_fill_(0, order[:m], True)


def compact_row_ids(sel: torch.Tensor, m: int) -> torch.Tensor:
    """A selection mask with m True entries -> its (m,) int32 row ids,
    ascending: each selected row goes to its rank among the selected (a
    cumulative sum), with no data-dependent size and so no host read."""
    n = sel.shape[0]
    row = torch.arange(n, device=sel.device)
    slot = torch.where(sel, torch.cumsum(sel, dim=0) - 1, m + (row & (SPREAD_LANES - 1)))
    buf = torch.zeros(m + SPREAD_LANES, dtype=torch.int64, device=sel.device)
    return buf.scatter_(0, slot, row)[:m].to(torch.int32)


def goss_sizes(n_total: int, params: StochasticParams) -> tuple[int, int]:
    """(m_top, m_other): GOSS's buffer sizes. m_other is clipped so that
    top + rest never exceeds n_total (round(n a) + round(n b) > n)."""
    m_top = sample_size(n_total, params.top_rate)
    m_other = min(sample_size(n_total, params.other_rate), n_total - m_top)
    return m_top, max(m_other, 0)


def goss_selection(key: tuple, g_abs: torch.Tensor, m_top: int,
                   m_other: int) -> tuple[torch.Tensor, torch.Tensor]:
    """GOSS: the m_top rows of largest |g| (ties: the lower row), then
    m_other of the rest uniformly. Returns (selected, rest) bool masks;
    `rest` marks the rows whose (g, h) are scaled by (1 - a) / b."""
    top = _rank_along_last(-g_abs) < m_top
    u = uniform((*key, TAG_GOSS), tuple(g_abs.shape), g_abs.device)
    u = torch.where(top, float("inf"), u)  # top rows are never drawn again
    rest = _rank_along_last(u) < m_other
    return top | rest, rest


def feature_sample_mask(key: tuple, k: int, f: int, base_mask: torch.Tensor | None = None,
                        n_nodes: int | None = None, device=None) -> torch.Tensor:
    """k features without replacement from base_mask's allowed set: the k
    smallest uniforms (disallowed features score +inf). (f,) bool, or
    (n_nodes, f) with a draw of its own per node. `device` defaults to
    base_mask's."""
    if device is None:
        if base_mask is None:
            raise ValueError("feature_sample_mask needs a device or a base_mask")
        device = base_mask.device
    shape = (f,) if n_nodes is None else (n_nodes, f)
    u = uniform(key, shape, device)
    if base_mask is not None:
        u = torch.where(base_mask, u, float("inf"))
    return _rank_along_last(u) < k


def tree_feature_mask(key: tuple, f: int, params: StochasticParams,
                      device) -> torch.Tensor | None:
    """The per-tree column sample (colsample_bytree), or None when off."""
    if params.colsample_bytree >= 1.0:
        return None
    k = sample_size(f, params.colsample_bytree)
    return feature_sample_mask((*key, TAG_COLS_TREE), k, f, device=device)


def level_feature_counts(f: int, params: StochasticParams) -> tuple[int, int]:
    """(k_level, k_node): per-level and per-node sample sizes, nested as
    XGBoost nests them (bylevel samples from bytree's set, bynode from
    bylevel's)."""
    k_tree = (sample_size(f, params.colsample_bytree)
              if params.colsample_bytree < 1.0 else f)
    k_level = (sample_size(k_tree, params.colsample_bylevel)
               if params.colsample_bylevel < 1.0 else k_tree)
    k_node = (sample_size(k_level, params.colsample_bynode)
              if params.colsample_bynode < 1.0 else k_level)
    return k_level, k_node


def level_feature_mask(ctx: TreeContext, level: int, n_nodes: int,
                       f: int) -> torch.Tensor | None:
    """The tree ∩ level ∩ node feature mask of one level: (f,) or
    (n_nodes, f) bool, or None when no column sampling is on."""
    p = ctx.params
    mask = ctx.feature_mask
    if p.colsample_bylevel >= 1.0 and p.colsample_bynode >= 1.0:
        return mask
    k_level, k_node = level_feature_counts(f, p)
    if p.colsample_bylevel < 1.0:
        mask = feature_sample_mask((*ctx.key, TAG_COLS_LEVEL, level), k_level, f,
                                   base_mask=mask, device=ctx.device)
    if p.colsample_bynode < 1.0:
        mask = feature_sample_mask((*ctx.key, TAG_COLS_NODE, level), k_node, f,
                                   base_mask=mask, n_nodes=n_nodes, device=ctx.device)
    return mask


def make_tree_context(
    params: StochasticParams,
    tree_key: tuple,
    gh: torch.Tensor,
    n_features: int,
    *,
    compact: bool = True,
    n_total: int | None = None,
    row_offset=0,
    axis_name=None,
) -> tuple[TreeContext, torch.Tensor]:
    """The tree's context and the gh that grow_tree takes with it.

    compact=True: gh gathered to the (m, 2) sampled-row buffer whose row
    ids are ctx.row_ids. compact=False (masked mode): gh with unselected
    rows zeroed, ctx.row_ids None. GOSS multiplies the sampled small-gradient
    rows' g and h by float32((1 - a) / b) in both modes, so each row's
    products are the same floats either way."""
    n_local = gh.shape[0]
    if n_total not in (None, n_local) or row_offset != 0 or axis_name is not None:
        raise NotImplementedError(
            "sharded sampling (n_total, row_offset, axis_name) is not ported yet: "
            "multi-device fits are ROADMAP queue 1 item 5")
    n = n_local
    row_ids = None
    if params.goss:
        m_top, m_other = goss_sizes(n, params)
        sel, rest = goss_selection(tree_key, gh[:, 0].abs(), m_top, m_other)
        amp = (1.0 - params.top_rate) / params.other_rate  # Python double, then float32
        w = torch.where(rest, torch.full((), amp, dtype=torch.float32, device=gh.device),
                        torch.ones((), dtype=torch.float32, device=gh.device))
        if compact:
            row_ids = compact_row_ids(sel, m_top + m_other)
            rid = row_ids.to(torch.int64)
            gh = gh[rid] * w[rid][:, None]
        else:
            gh = torch.where(sel[:, None], gh * w[:, None], 0.0)
    elif params.row_sampling:
        m = sample_size(n, params.subsample)
        sel = row_selection_mask(tree_key, n, m, gh.device)
        if compact:
            row_ids = compact_row_ids(sel, m)
            gh = gh[row_ids.to(torch.int64)]
        else:
            gh = torch.where(sel[:, None], gh, 0.0)
    ctx = TreeContext(key=tuple(tree_key), row_ids=row_ids,
                      feature_mask=tree_feature_mask(tree_key, n_features, params, gh.device),
                      params=params, device=gh.device)
    return ctx, gh
