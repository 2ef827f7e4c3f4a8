"""Wrapper of the histogram CUDA kernel (`csrc/histogram.cu`).

Counterpart of `repro.kernels.histogram.build_histograms_packed_kernel`: the
same contract (packed words, (g, h) pairs and level-local positions in,
(n_nodes, F, max_bins, 2) out), computed with privatised shared-memory
histograms and atomics instead of one-hot matmuls.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build as B

# A block sweeps at least this many words per row stripe, so the flush of
# its private histogram stays small beside the work that filled it.
MIN_WORDS_PER_BLOCK = 1024
# Aim for this many blocks per streaming multiprocessor over the grid.
BLOCKS_PER_SM = 2
THREADS = 512  # threads per block


class HistogramPlan(NamedTuple):
    node_tile: int  # nodes per block (grid z = ceil(n_nodes / node_tile))
    feat_group: int  # features per block (grid y)
    words_per_block: int  # packed words per row stripe (grid x)


def launch_plan(n_words: int, n_features: int, n_nodes: int, max_bins: int,
                n_sm: int, smem_bytes: int) -> HistogramPlan:
    """Size a block's private histogram from the shared-memory limit: as many
    nodes as fit for one feature (the rest go to further node tiles on the
    grid's z axis), then as many features as fit beside them."""
    per_node = max_bins * 8  # one feature, one node: max_bins (g, h) floats
    node_tile = min(n_nodes, smem_bytes // per_node)
    if node_tile < 1:
        raise ValueError(
            f"max_bins={max_bins} needs {per_node} B of shared memory per "
            f"node, more than the {smem_bytes} B a block may use"
        )
    feat_group = min(n_features, smem_bytes // (node_tile * per_node))
    tiles = math.ceil(n_features / feat_group) * math.ceil(n_nodes / node_tile)
    row_blocks = max(1, min(math.ceil(n_words / MIN_WORDS_PER_BLOCK),
                            math.ceil(BLOCKS_PER_SM * n_sm / tiles)))
    return HistogramPlan(node_tile, feat_group, math.ceil(n_words / row_blocks))


def build_histograms_packed_kernel(
    packed: torch.Tensor,  # (F, W) int32 words
    gh: torch.Tensor,  # (N, 2) float32
    positions: torch.Tensor,  # (N,) int32, n_nodes = inactive
    n_nodes: int,
    max_bins: int,
    bits: int,
) -> torch.Tensor:
    """Histogram (n_nodes, F, max_bins, 2) float32 on the card. Float
    summation order is that of the atomics, not fixed from run to run."""
    B.expect(packed, "packed", torch.int32, 2)
    B.expect(gh, "gh", torch.float32, 2)
    B.expect(positions, "positions", torch.int32, 1)
    f, w = packed.shape
    n = gh.shape[0]
    if gh.shape[1] != 2 or positions.shape[0] != n:
        raise ValueError(f"gh must be (N, 2) and positions (N,), got "
                         f"{tuple(gh.shape)} and {tuple(positions.shape)}")
    if w * (32 // bits) < n:
        raise ValueError(f"{w} words of {bits}-bit symbols hold fewer than {n} rows")
    if gh.data_ptr() % 8:
        gh = gh.clone()  # the kernel reads (g, h) as one 8-byte float2
    dev = packed.device
    plan = launch_plan(w, f, n_nodes, max_bins, *B.device_limits(dev.index))
    out = torch.zeros((n_nodes, f, max_bins, 2), dtype=torch.float32, device=dev)
    err = B.lib().rt_histogram_packed(
        packed.data_ptr(), gh.data_ptr(), positions.data_ptr(), out.data_ptr(),
        n, f, w, n_nodes, max_bins, bits, *plan, THREADS, B.stream(dev),
    )
    B.check(err, "histogram_packed")
    build_histograms_packed_kernel.launches += 1
    return out


build_histograms_packed_kernel.launches = 0
