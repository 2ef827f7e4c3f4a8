"""Scale-out subsystem of the port; counterpart of `repro.dist` (DESIGN.md §15).

  * `Mesh` / `make_mesh` — devices shaped by named axes (several positions
    may share one device), and `spmd`, the executor that runs a function
    once per position, each in its own thread: what `shard_map` is to the
    reference.
  * `Collective` + `PsumCollective` / `RingCollective` /
    `HierarchicalCollective`, picked by name through
    `Booster.fit(mesh=, collective=)` or `get_collective`;
    `register_collective` adds strategies.
  * `CommStats` / `round_comm_stats` — the analytic per-round wire bytes
    and collective calls on `Booster.comm_stats`.
  * `sharded_sketch_cuts` / `tree_merge` — the data-parallel quantile
    sketch (sorted shards, log-depth merge).
  * `RoundInputs` / `make_distributed_round` / `make_chunk_runner` — the
    sharded round behind `fit(mesh=)`; `shard_features` — each position's
    bin block and cut rows for `grow_tree(feature_axis=)`.
"""
from repro_torch.dist.collective import (
    Collective,
    CommStats,
    HierarchicalCollective,
    PsumCollective,
    RingCollective,
    collective_names,
    get_collective,
    register_collective,
    round_comm_stats,
)
from repro_torch.dist.group import spmd
from repro_torch.dist.mesh import Mesh, make_mesh
from repro_torch.dist.runner import (
    RoundInputs,
    make_chunk_runner,
    make_distributed_round,
    shard_features,
    train_distributed,
)
from repro_torch.dist.sketch import sharded_sketch_cuts, tree_merge

__all__ = [
    "Collective",
    "CommStats",
    "HierarchicalCollective",
    "Mesh",
    "PsumCollective",
    "RingCollective",
    "RoundInputs",
    "collective_names",
    "get_collective",
    "make_chunk_runner",
    "make_distributed_round",
    "make_mesh",
    "register_collective",
    "round_comm_stats",
    "shard_features",
    "sharded_sketch_cuts",
    "spmd",
    "train_distributed",
    "tree_merge",
]
