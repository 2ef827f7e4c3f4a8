"""Wrapper of the ensemble-traversal CUDA kernel (`csrc/ensemble_traversal.cu`).

Counterpart of `repro.kernels.ensemble_traversal.ensemble_margins_kernel`:
raw rows (NaN = missing) through all trees, margins (N, K) without
base_score, tree t feeding class t % K. The kernel reads the model as packed
8-byte nodes (`pack_nodes`, once per model). It serves every model the
reference serves: the plan below picks, from the card's shared memory, how
many classes a block accumulates, whether it stages the tree arenas
(double-buffered) or reads them through L2, and whether the block's rows sit
in shared memory.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build as B

# The plan's numbers, from tools/traversal_parts.py on an H100 80GB HBM3 at
# 700 W (1M rows x 28 features, 500 trees at depth 6 and 8, 700 trees x 7
# classes, random arenas in which a depth-6 walk stops after ~2.9 levels;
# 100k rows x 10-160 trees). At 500 trees of depth 6 whose every walk goes
# the full depth, as in a fitted model, the plan's 256 rows x 12 arenas a
# stage took 2.63 ms, the sweep's best cell (512 x 8) 2.57:
# * 256 rows a block. 512 took 2.40 / 3.36 / 4.29 ms against 2.40 / 3.76 /
#   4.34 at 1M rows, but 0.052 / 0.080 / 0.145 ms against 0.045 / 0.060 /
#   0.113 at 100k rows x 40 / 80 / 160 trees (fewer blocks than slots).
# * SMEM_TARGET: four blocks an SM (4 x (56 + 1 reserved) KB of 228 KB;
#   1,024 threads, all that the kernel's 64 registers a thread allow).
#   Stages of 12 depth-6 arenas took 2.40 ms, of 21 (three blocks an SM)
#   2.97.
# * Stages of a multiple of WALK_TREES arenas: a short group walks its last
#   tree again in its spare chains (depth 8: 4 arenas 3.76 ms, 5 arenas 4.99).
# * The row tile from ROW_TILE_TREES trees a block: its transposing copy
#   costs more than it saves at 10 trees (0.0238 ms against 0.0222 with the
#   rows read from global memory), ties at 20 (0.0281 against 0.0278) and
#   saves from 40 on (0.0389 against 0.0422).
THREADS = 256  # rows per block
SMEM_TARGET = 56 * 1024  # shared memory a block aims for
NODE_BYTES = 8  # {threshold or leaf value f32; feature | default_left << 30 | is_leaf << 31}
BARRIER_BYTES = 16  # the two stages' mbarriers
KREG = 8  # class tiles up to this many sum in registers, wider ones in shared memory
WALK_TREES = 4  # trees a thread walks at once (G in the kernel)
ROW_TILE_TREES = 16  # trees a block walks from which its rows sit in shared memory
MAX_FEATURE = 2**30  # feature indices take the node word's low 30 bits
_DEFAULT_LEFT, _LEAF = 1 << 30, 1 << 31


def pack_nodes(feature: torch.Tensor, threshold: torch.Tensor, default_left: torch.Tensor,
               leaf_value: torch.Tensor, is_leaf: torch.Tensor) -> torch.Tensor:
    """(T, A) arena fields -> (T, A + A % 2, 2) int32 packed nodes: [..., 0]
    holds the threshold's bits, or the leaf value's on a leaf; [..., 1] the
    feature (0 on a leaf) | default_left << 30 | is_leaf << 31. The arena is
    padded to an even length (16-byte arenas for the kernel's bulk copies)
    with a leaf of value 0 that no walk reaches. Plain torch, any device."""
    is_leaf = is_leaf.to(torch.bool)
    feat = torch.where(is_leaf, 0, feature.to(torch.int64))
    if bool(((feat < 0) | (feat >= MAX_FEATURE)).any()):
        raise ValueError(f"feature indices must lie in [0, 2**30) to pack the nodes, got "
                         f"[{int(feat.min())}, {int(feat.max())}]")
    value = torch.where(is_leaf, leaf_value.to(torch.float32), threshold.to(torch.float32))
    meta = (feat | default_left.to(torch.int64) * _DEFAULT_LEFT
            | is_leaf.to(torch.int64) * _LEAF)
    meta = torch.where(meta >= 2**31, meta - 2**32, meta).to(torch.int32)
    nodes = torch.stack([value.view(torch.int32), meta], dim=-1)
    if nodes.shape[1] % 2:
        pad = torch.tensor([0, -(2**31)], dtype=torch.int32, device=nodes.device)
        nodes = torch.cat([nodes, pad.expand(nodes.shape[0], 1, 2)], dim=1)
    return nodes.contiguous()


def node_fields(nodes: torch.Tensor):
    """Packed nodes (T, A, 2) -> (value f32, feature int64, default_left bool,
    is_leaf bool), each (T, A): the fields the traversal reads."""
    meta = nodes[..., 1].to(torch.int64) & 0xFFFFFFFF
    return (nodes[..., 0].view(torch.float32), meta & (MAX_FEATURE - 1),
            (meta & _DEFAULT_LEFT) != 0, (meta & _LEAF) != 0)


class TraversalPlan(NamedTuple):
    class_tile: int  # classes a block accumulates (grid y = ceil(K / class_tile))
    trees_blk: int  # tree arenas in each of the two stages; 0 = read through L2
    row_tile: int  # 1 = the block's rows in shared memory, 0 = read from global memory


def traversal_plan(n_trees: int, arena: int, n_classes: int, n_features: int,
                   smem_bytes: int) -> TraversalPlan:
    """Shared memory of a block (`smem_bytes` at most) for: per-class sums
    past KREG classes (class_tile x THREADS floats), two stages of
    `trees_blk` arenas of `arena` packed nodes, and the row tile (THREADS x
    n_features floats). All classes take one block while their sums fit beside two
    arenas; otherwise the classes are tiled over the grid, at most half of
    SMEM_TARGET of sums a block. Arenas are staged while two fit beside the
    sums, else read through L2. The rows sit in shared memory where the
    block walks ROW_TILE_TREES trees or more and the tile fits beside the
    rest; the stages take what is left of SMEM_TARGET, in multiples of
    WALK_TREES arenas, but at least WALK_TREES where they fit."""
    def sums(tile: int) -> int:
        return 0 if tile <= KREG else tile * THREADS * 4

    tree = arena * NODE_BYTES
    tile = n_classes
    if BARRIER_BYTES + sums(n_classes) + 2 * tree > smem_bytes:
        tiles = math.ceil(n_classes / max(1, SMEM_TARGET // 2 // (THREADS * 4)))
        tile = math.ceil(n_classes / tiles)
    block_trees = n_trees // n_classes * tile
    fixed = BARRIER_BYTES + sums(tile)
    staged = fixed + 2 * tree <= smem_bytes
    x_tile = THREADS * n_features * 4
    row_tile = (block_trees >= ROW_TILE_TREES
                and fixed + x_tile + (2 * tree if staged else 0) <= smem_bytes)
    if not staged:
        return TraversalPlan(tile, 0, int(row_tile))
    fixed += x_tile if row_tile else 0
    budget = min(smem_bytes, max(SMEM_TARGET, fixed + 2 * WALK_TREES * tree))
    fit = max(1, (budget - fixed) // (2 * tree))
    if fit > WALK_TREES:
        fit -= fit % WALK_TREES
    return TraversalPlan(tile, min(block_trees, fit), int(row_tile))


def ensemble_margins_kernel(
    nodes: torch.Tensor,  # (T, A) x 2 int32, from pack_nodes
    x: torch.Tensor,  # (N, F) f32, NaN = missing
    n_classes: int,
    max_depth: int,
) -> torch.Tensor:
    """Margins (N, n_classes) f32, bit-identical to `ref.ensemble_margins_ref`
    on the arena fields the nodes were packed from."""
    B.expect(nodes, "nodes", torch.int32, 3)
    B.expect(x, "x", torch.float32, 2)
    n_trees, arena, two = nodes.shape
    if two != 2 or arena % 2 or nodes.data_ptr() % 16:
        raise ValueError(f"nodes must come from pack_nodes, got shape {tuple(nodes.shape)}")
    n_rows, n_features = x.shape
    if n_trees % n_classes:
        raise ValueError(f"{n_trees} trees do not fill rounds of {n_classes} classes")
    dev = x.device
    if n_rows == 0 or n_trees == 0:
        return torch.zeros((n_rows, n_classes), dtype=torch.float32, device=dev)
    out = torch.empty((n_rows, n_classes), dtype=torch.float32, device=dev)
    plan = traversal_plan(n_trees, arena, n_classes, n_features,
                          B.device_limits(dev.index).smem_block)
    B.launch("rt_ensemble_margins", dev,
             nodes.data_ptr(), x.data_ptr(), out.data_ptr(), n_trees, arena, n_rows, n_features,
             n_classes, max_depth, *plan, THREADS)
    B.count(ensemble_margins_kernel)
    return out


ensemble_margins_kernel.launches = 0
