"""Row-sharded GBDT training (paper §2.3, Algorithm 1); counterpart of
`repro.dist.runner`.

Rows are split over the mesh's data axes, "each GPU processes a subset of
training instances": every shard builds its rows' histograms, a
`Collective` combines them (the paper's AllReduceHistograms: psum, ring or
hierarchical, optionally compressed), and every shard grows the same tree
from the reduced histograms; positions and margins stay on their shard.
Each shard runs in a thread of `group.spmd` on its position's device, with
the port's single-device code: one `grow_tree` a tree with the collective
passed in, its kernels launched once a shard.

The matrix is sharded three ways (`shard_bins`): packed words are repacked
a shard (cached on the DeviceDMatrix for each shard count and device set,
as the reference caches them), dense bins are sliced from one `unpack()`,
and a resident ExternalDMatrix's chunk stack is split into whole chunks.
Streamed paging is refused. Sampling runs in masked mode: each shard draws
the global selection over all rows from the same path and keeps its slice
(GOSS gathers the rows' gradients from every shard first), so a sharded
fit draws what the single-device fit draws.

`make_chunk_runner` gives `Booster._run_rounds` one round at a time
(`run.step`): the eval sets, the metrics and the chunk's one host read stay
in the booster, which has one round loop for both fits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Sequence

import torch

from repro_torch.core import compress as C
from repro_torch.core import objectives as O
from repro_torch.core import resilience as RES
from repro_torch.core import sampling as SMP
from repro_torch.core import tree as T
from repro_torch.dist.collective import Collective, get_collective, round_comm_stats
from repro_torch.dist.group import spmd


class RoundInputs(NamedTuple):
    """What one shard's round takes: its rows' bins, margins and labels,
    the replicated cuts, and the round's draw path (seed, absolute round),
    or None without sampling."""

    data: Any  # this shard's bins type (PackedBins, ChunkedPackedBins) or dense bins
    margins: torch.Tensor  # (n_local, k)
    y: torch.Tensor  # (n_local,)
    cuts: torch.Tensor  # (f, n_cuts), replicated
    rkey: tuple | None = None  # (seed, absolute round), replicated


def _on(bins, dev: torch.device):
    """A bins type or dense bins on `dev`."""
    if isinstance(bins, torch.Tensor):
        return bins.to(dev)
    return dataclasses.replace(bins, packed=bins.packed.to(dev))


def shard_bins(cfg, dmat, mesh, data_axes: Sequence[str]):
    """Each shard's training representation on its device, in shard order,
    with the rows a shard holds: the reference's three ways to shard
    (`runner.py` `make_chunk_runner`), with its errors."""
    from repro_torch.core.dmatrix import ExternalDMatrix

    n_shards, _, first = mesh.shards(data_axes)
    devs = [mesh.device(p) for p in first]
    n = dmat.n_rows
    if n % n_shards != 0:
        raise ValueError(
            f"n_rows={n} must be divisible by the {n_shards} data shards "
            "(truncate or pad upstream)"
        )
    n_per = n // n_shards
    if isinstance(dmat, ExternalDMatrix):
        if dmat.resolved_paging() == "stream":
            raise NotImplementedError(
                "streamed out-of-core growth is single-shard with the default "
                "builders; use resident paging for sharded or kernel fits"
            )
        # Whole chunks are the sharding unit (each decodes on its own), so
        # shard boundaries must fall on chunk boundaries.
        if n % dmat.chunk_rows != 0:
            raise ValueError(
                f"external-memory training with mesh= requires n_rows={n} "
                f"to be a multiple of chunk_rows={dmat.chunk_rows} (the "
                "last chunk must be full so shards get whole chunks)"
            )
        if dmat.n_chunks % n_shards != 0:
            raise ValueError(
                f"n_chunks={dmat.n_chunks} must be divisible by the "
                f"{n_shards} data shards; pick chunk_rows so chunks "
                "distribute evenly"
            )
        stack = dmat.packed_bins().packed
        per = dmat.n_chunks // n_shards
        return [C.ChunkedPackedBins(stack[s * per:(s + 1) * per].to(d), dmat.bits,
                                    dmat.chunk_rows, n_per)
                for s, d in enumerate(devs)], n_per
    if cfg.compress_matrix:
        # Repacked a shard so each shard's words decode on their own, and
        # cached on the matrix: the dense transient exists once for each
        # shard count (and set of devices), not once a fit.
        key = (n_shards, tuple(devs))
        words = dmat._shard_pack_cache.get(key)
        if words is None:
            bins = dmat.matrix.unpack()
            words = [C.pack(bins[s * n_per:(s + 1) * n_per], dmat.bits).to(d)
                     for s, d in enumerate(devs)]
            dmat._shard_pack_cache[key] = words
        return [C.PackedBins(w, dmat.bits, n_per) for w in words], n_per
    bins = dmat.matrix.unpack()
    return [bins[s * n_per:(s + 1) * n_per].to(d) for s, d in enumerate(devs)], n_per


def shard_features(bins: torch.Tensor, cuts: torch.Tensor, mesh, row_axes: Sequence[str],
                   feature_axis: str | None) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Each position's (dense bin block, cut rows) on its device, in position
    order, for `grow_tree(feature_axis=)`: what `shard_map`'s
    `in_specs=(P(row_axes, feature_axis), P(feature_axis, None))` hand the
    reference. Rows split over `row_axes` in the runner's order (shard s
    holds rows [s * n_local, (s + 1) * n_local)), features over
    `feature_axis` by its index (None: every position holds them all);
    rows or features that do not divide evenly raise, as `shard_map`
    refuses them."""
    row_axes = tuple(row_axes)
    if feature_axis is not None and feature_axis in row_axes:
        raise ValueError(f"feature_axis {feature_axis!r} is also a row axis {row_axes}")
    n, f = bins.shape
    if cuts.shape[0] != f:
        raise ValueError(f"cuts cover {cuts.shape[0]} features, the bins {f}")
    n_row, shard_of, _ = mesh.shards(row_axes)
    n_feat = 1 if feature_axis is None else mesh.shape[feature_axis]
    if n % n_row != 0:
        raise ValueError(f"n_rows={n} must be divisible by the {n_row} row shards "
                         f"over {row_axes}")
    if f % n_feat != 0:
        raise ValueError(f"n_features={f} must be divisible by the {n_feat} feature "
                         f"shards over {feature_axis!r} (pad the features)")
    n_per, f_per = n // n_row, f // n_feat
    out = []
    for p in range(mesh.size):
        j = 0 if feature_axis is None else mesh.coords(p)[feature_axis]
        s, dev, cols = shard_of[p], mesh.device(p), slice(j * f_per, (j + 1) * f_per)
        out.append((bins[s * n_per:(s + 1) * n_per, cols].to(dev).contiguous(),
                    cuts[cols].to(dev).contiguous()))
    return out


def make_distributed_round(cfg, obj: O.Objective, mesh, data_axes: Sequence[str] = ("data",),
                           collective: Collective | None = None):
    """The per-round function: `fn(inputs)` takes one `RoundInputs` a mesh
    position and returns, a position, (trees, new margins, ok, fallbacks):
    the round's k trees (every position's the same), its rows' margins,
    the all-reduced finite flag (None with numeric_check="off") and the
    round's count of compressed allreduces that fell back (None without
    compression)."""
    if collective is None:
        collective = get_collective("psum", mesh, data_axes)
    from repro_torch.core import booster as B  # booster imports this module lazily

    k = obj.n_outputs(cfg.n_classes)
    cfg_kw = O.config_kwargs(cfg)
    stoch = SMP.stochastic_params(cfg)
    sentinel = cfg.numeric_check != "off"
    compressed = collective.compression is not None
    n_shards, shard_of, _ = mesh.shards(data_axes)

    def round_body(inputs: RoundInputs, position: int):
        data, margins, y, cuts, rkey = inputs
        collective.begin_round()
        n_local = margins.shape[0]
        n_features = data.n_features if not isinstance(data, torch.Tensor) else data.shape[1]
        gh_all = obj.grad(margins, y, **cfg_kw)
        gh_raw = gh_all
        if cfg.numeric_check == "clamp":
            gh_all = RES.clamp_gradients(gh_all)
        trees = []
        for c in range(k):
            gh_c, ctx = gh_all[:, c, :].contiguous(), None
            if stoch is not None:
                # Every shard draws the global selection from the same
                # path, then keeps its rows; GOSS gathers |g| of all rows
                # in the runner's row order first.
                ctx, gh_c = SMP.make_tree_context(
                    stoch, (*rkey, c), gh_c, n_features, compact=False,
                    n_total=n_local * n_shards,
                    row_offset=shard_of[position] * n_local,
                    axis_name=tuple(data_axes))
            trees.append(T.grow_tree(
                data, gh_c, cuts, cfg.max_depth, cfg.max_bins, cfg.split_params,
                growth=cfg.growth, max_leaves=cfg.max_leaves or 2**cfg.max_depth,
                ctx=ctx, collective=collective))
        new_margins = B._apply_trees(cfg, trees, data, margins)
        ok = None
        if sentinel:
            # Gradients and margins are the shard's, the trees everyone's:
            # a shard that sees a non-finite value poisons the round for
            # all, so the bad count is all-reduced before the policy.
            ok_local = RES.finite_flags(gh_raw, *(t.leaf_value for t in trees), new_margins)
            ok = collective.allreduce(torch.where(ok_local, 0, 1).to(torch.int32)) == 0
            if cfg.numeric_check == "warn_skip":
                trees = [t._replace(leaf_value=torch.where(ok, t.leaf_value, 0.0),
                                    gain=torch.where(ok, t.gain, float("-inf")))
                         for t in trees]
                new_margins = torch.where(ok, new_margins, margins)
        return trees, new_margins, ok, collective.fallback_count() if compressed else None

    def fn(inputs: Sequence[RoundInputs]):
        return spmd(mesh, round_body, inputs, list(range(mesh.size)))

    return fn


class ChunkRunner:
    """The sharded strategy behind `Booster.fit(dtrain, mesh=...)`.

    `step(round_abs, margins)` runs one round on every shard from the
    global (n, k) margins on the booster's device and returns (trees,
    margins, ok, fallbacks): the round's trees and the global margins on
    that device, the all-reduced finite flag and the fallback count (0-d
    device tensors, or None). `comm_stats` is the analytic per-round
    `CommStats`; `fallback_events` counts the fit's fallbacks once the
    booster has read them with a chunk's metrics.
    """

    def __init__(self, cfg, obj, dmat, mesh, data_axes, coll: Collective, device):
        self.cfg, self.mesh, self.device = cfg, mesh, device
        self.data_axes = tuple(data_axes)
        _, self.shard_of, self.first = mesh.shards(self.data_axes)
        bins, self.n_per = shard_bins(cfg, dmat, mesh, self.data_axes)
        # A position's inputs on its device (a position outside the data
        # axes repeats its shard's rows).
        devs = [mesh.device(p) for p in range(mesh.size)]
        self.bins = [_on(bins[s], d) for s, d in zip(self.shard_of, devs)]
        self.y = [dmat.label[s * self.n_per:(s + 1) * self.n_per].to(d)
                  for s, d in zip(self.shard_of, devs)]
        self.cuts = [dmat.cuts.to(d) for d in devs]
        self.round_fn = make_distributed_round(cfg, obj, mesh, self.data_axes, coll)
        self.stoch = SMP.stochastic_params(cfg) is not None
        self.fallback_events = 0
        self.comm_stats = round_comm_stats(
            coll, max_depth=cfg.max_depth, n_features=int(dmat.cuts.shape[0]),
            max_bins=cfg.max_bins, n_trees_per_round=obj.n_outputs(cfg.n_classes),
            sentinel=cfg.numeric_check != "off")

    def inputs(self, round_abs: int, margins: torch.Tensor) -> list[RoundInputs]:
        """Each position's `RoundInputs` of a round, from the global margins."""
        rkey = (self.cfg.seed, round_abs) if self.stoch else None
        n = self.n_per
        return [RoundInputs(self.bins[p], margins[s * n:(s + 1) * n].to(self.mesh.device(p)),
                            self.y[p], self.cuts[p], rkey)
                for p, s in enumerate(self.shard_of)]

    def step(self, round_abs: int, margins: torch.Tensor):
        out = self.round_fn(self.inputs(round_abs, margins))
        trees, _, ok, fb = out[0]
        trees = [T.Tree(*(a.to(self.device) for a in t)) for t in trees]
        margins = torch.cat([out[p][1].to(self.device) for p in self.first])
        return (trees, margins, None if ok is None else ok.to(self.device),
                None if fb is None else fb.to(self.device))


def make_chunk_runner(cfg, obj: O.Objective, dmat, mesh, data_axes: Sequence[str] = ("data",),
                      collective="psum", compression: str | None = None,
                      comm_tolerance: float = 0.05, device=None) -> ChunkRunner:
    """Shard `dmat` over `mesh`'s data axes and return the `ChunkRunner`
    whose `step` the booster calls a round. `device` is where the global
    margins and the trees are handed back (default: the matrix's)."""
    coll = get_collective(collective, mesh, data_axes, compression=compression,
                          tolerance=comm_tolerance)
    return ChunkRunner(cfg, obj, dmat, mesh, data_axes, coll,
                       dmat.device if device is None else device)


def train_distributed(x, y, cfg, mesh, data_axes: Sequence[str] = ("data",),
                      verbose_every: int = 0, device=None):
    """Shim: quantise x on `device` and run `Booster.fit(dtrain,
    mesh=mesh)`; returns the Booster, as single-device training does."""
    from repro_torch.core.booster import Booster
    from repro_torch.core.dmatrix import DeviceDMatrix

    dtrain = DeviceDMatrix(x, label=y, max_bins=cfg.max_bins,
                           device=mesh.device(0) if device is None else device)
    return Booster(cfg).fit(dtrain, verbose_every=verbose_every, mesh=mesh,
                            data_axes=data_axes)
