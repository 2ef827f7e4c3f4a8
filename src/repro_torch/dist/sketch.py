"""Sharded quantile sketch construction (paper §quantiles); counterpart of
`repro.dist.sketch`.

  * Device phase: with a mesh, each shard fills NaN with +inf and sorts its
    row shard's columns on its own device (one thread a position through
    `group.spmd`), and counts the finite entries. No communication.
  * Host phase: each shard's sorted columns become exact summaries by
    `StreamingQuantileSketch.push_sorted`, and the shards' sketches combine
    by a log-depth pairwise tree merge. Merging exact summaries is exact and
    associative, so with enough capacity the cuts are the sequential
    sketch's; under pruning a leaf sees O(log S) prune rounds, not S − 1.

`sharded_sketch_cuts` is the one call; `ExternalDMatrix(sketch_shards=)`
merges its per-shard sketches through `tree_merge`.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.quantile import DEFAULT_MAX_BINS, StreamingQuantileSketch
from repro_torch.device import as_tensor, resolve_device
from repro_torch.dist.group import spmd


def tree_merge(sketches: Sequence[StreamingQuantileSketch]) -> StreamingQuantileSketch:
    """Merge sketches pairwise in log-depth order: round t merges sketch 2k
    with 2k + 1 until one remains. Mutates the sketches (each merge folds
    right into left) and returns the survivor."""
    sketches = list(sketches)
    if not sketches:
        raise ValueError("tree_merge needs at least one sketch")
    while len(sketches) > 1:
        nxt = [sketches[i].merge(sketches[i + 1]) for i in range(0, len(sketches) - 1, 2)]
        if len(sketches) % 2:
            nxt.append(sketches[-1])
        sketches = nxt
    return sketches[0]


def _device_sort_phase(x, mesh, data_axes) -> tuple[np.ndarray, np.ndarray]:
    """Every shard's columns sorted on its device: (n_shards, shard_rows,
    n_features) ascending with NaN as a +inf tail, and (n_shards,
    n_features) finite counts, on the host. A position that repeats another
    shard (a mesh axis outside `data_axes`) sorts nothing."""
    n_shards, shard_of, first = mesh.shards(tuple(data_axes))
    n, f = x.shape
    if n % n_shards:
        raise ValueError(
            f"rows ({n}) must divide evenly across {n_shards} shards for "
            f"the device sketch phase"
        )
    per = n // n_shards

    def sort_shard(p: int):
        s = shard_of[p]
        if first[s] != p:
            return None
        xs = as_tensor(x[s * per:(s + 1) * per], mesh.device(p))
        finite = torch.isfinite(xs)
        srt = torch.sort(torch.where(finite, xs, float("inf")), dim=0).values
        return srt.cpu().numpy(), finite.sum(dim=0).to(torch.int32).cpu().numpy()

    out = spmd(mesh, sort_shard, list(range(mesh.size)))
    srt = np.stack([out[p][0] for p in first])
    nv = np.stack([out[p][1] for p in first])
    return srt, nv


def sharded_sketch_cuts(
    x,
    *,
    max_bins: int = DEFAULT_MAX_BINS,
    capacity: int = 1024,
    mesh=None,
    data_axes: Sequence[str] = ("data",),
    n_shards: int | None = None,
    device=None,
) -> torch.Tensor:
    """Quantile cuts through per-shard sketches and the log-depth merge,
    shaped like `compute_cuts(x, max_bins)`.

    With `mesh`, the sort runs on each shard's device and the shards are
    the mesh's data-axis extent; the cuts land on the mesh's first device.
    Without one, `n_shards` (default 1) splits the rows on the host (the
    same merge tree) and the cuts land on `device` (the card unless "cpu").
    """
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, np.float32)
    n, f = x.shape
    if mesh is not None:
        srt, nv = _device_sort_phase(x, mesh, data_axes)
        sketches = []
        for s in range(srt.shape[0]):
            sk = StreamingQuantileSketch(f, max_bins, capacity)
            sk.push_sorted(srt[s], nv[s])
            sketches.append(sk)
        return tree_merge(sketches).get_cuts(mesh.device(0))
    shards = max(1, int(n_shards or 1))
    bounds = np.linspace(0, n, shards + 1, dtype=np.int64)
    sketches = []
    for s in range(shards):
        sk = StreamingQuantileSketch(f, max_bins, capacity)
        part = x[bounds[s]: bounds[s + 1]]
        if part.shape[0]:
            sk.push(part)
        sketches.append(sk)
    return tree_merge(sketches).get_cuts(resolve_device(device))
