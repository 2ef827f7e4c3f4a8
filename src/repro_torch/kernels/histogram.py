"""Wrappers of the histogram CUDA kernels (`csrc/histogram.cu`).

All three compute the contract of `repro.core.histogram` (packed words,
(g, h) pairs and level-local positions in, (n_nodes, F, max_bins, 2) out):

* `build_histograms_packed_kernel`, counterpart of
  `repro.kernels.histogram.build_histograms_packed_kernel`: privatised
  shared-memory histograms and atomics instead of one-hot matmuls, one
  64-bit compare-and-swap per (g, h) and warp-aggregated adds where a warp
  shows repeated bins.
* `build_histograms_rows_kernel`, the same privatised design over a
  compacted row buffer (slot i holds row `row_ids[i]`), with several word
  loads in flight per slot, one 64-bit compare-and-swap per (g, h) and
  warp-aggregated adds where a warp shows repeated bins: the kernel behind
  `core.histogram.build_histograms_packed_rows`, which the subtraction trick
  calls below the root.
* `histogram_packed`, counterpart of `repro.kernels.histogram.histogram_packed`:
  no private histogram, every (row, feature) adds straight into the output,
  lanes of a warp with the same (node, bin) summed first and added with one
  8-byte atomic, each warp starting at its own feature.

Both private kernels take their grid from `launch_plan`, each with its own
target of resident blocks per SM. Both flush their private histograms with
global atomics into an output that the wrapper zeroes, or, given `out=`,
into the caller's buffer as it stands: the streamed external-memory path
(`core/stream.py`) adds one chunk's launch after another into one running
histogram that way. Given `chunk_rows`, both read the
external-memory chunk stack instead of the flat words: `packed` is then
(n_chunks, F, words_per_chunk), row r's words are chunk r // chunk_rows's
at offset r % chunk_rows, a chunk's padding rows (and the rows past the
real ones of a short last chunk) add nothing, and the whole stack is read
in one launch (the kernels' chunked instantiation, `kChunked`). The plan
sizes the privatised kernel's grid over the stack's n_chunks *
words_per_chunk words as it sizes it over flat words.

Float summation order is that of the atomics, not fixed from run to run.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build as B

# A block sweeps at least this many words (or slots) per stripe, so the
# flush of its private histogram stays small beside the work that filled it.
MIN_WORDS_PER_BLOCK = 1024
# The plan caps a block's private histogram so that this many blocks fit in
# one SM's shared memory: on spread-out bins, at one 224 KB block per SM the
# row-id kernel took 2-2.5x its time at four 56 KB blocks.
MIN_BLOCKS_PER_SM = 3
# The privatised kernel's own target: at 8 nodes two blocks of 7 features
# beat three of 4 and one of 14 on both word sets at 1M and 11M rows
# (PERF.md §6); at 1 and 32 nodes the targets of two and three give the
# same plan.
PRIVATE_BLOCKS_PER_SM = 2
THREADS = 512  # threads per block


class HistogramPlan(NamedTuple):
    node_tile: int  # nodes per block (grid z = ceil(n_nodes / node_tile))
    feat_group: int  # features per block (grid y)
    words_per_block: int  # packed words (or buffer slots) per stripe (grid x)
    smem_bytes: int  # a block's private histogram
    blocks_per_sm: int  # blocks whose shared memory and threads fit on one SM


def launch_plan(n_words: int, n_features: int, n_nodes: int, max_bins: int,
                limits: B.DeviceLimits,
                blocks_per_sm: int = MIN_BLOCKS_PER_SM) -> HistogramPlan:
    """Size a block's private histogram for occupancy: at most an SM's
    shared memory over `blocks_per_sm` (less the per-block reserve), so
    that that many blocks fit; nodes first (the rest go to further node
    tiles on the grid's z axis), then features beside them (feature groups
    on y), each split evenly. The stripes on x make about one wave of
    resident blocks. The row kernel passes its slot count as `n_words`."""
    per_node = max_bins * 8  # one feature, one node: max_bins (g, h) floats
    cap = min(limits.smem_block,
              limits.smem_sm // blocks_per_sm - limits.smem_reserved)
    if per_node > cap:  # one node's bins alone: take what one block may use
        cap = limits.smem_block
    if per_node > cap:
        raise ValueError(
            f"max_bins={max_bins} needs {per_node} B of shared memory per "
            f"node, more than the {cap} B a block may use"
        )
    node_tiles = math.ceil(n_nodes / (cap // per_node))
    node_tile = math.ceil(n_nodes / node_tiles)
    groups = math.ceil(n_features / (cap // (node_tile * per_node)))
    feat_group = math.ceil(n_features / groups)
    smem = feat_group * node_tile * per_node
    per_sm = min(limits.smem_sm // (smem + limits.smem_reserved),
                 limits.threads_sm // THREADS)
    row_blocks = max(1, min(math.ceil(n_words / MIN_WORDS_PER_BLOCK),
                            math.ceil(per_sm * limits.n_sm / (groups * node_tiles))))
    return HistogramPlan(node_tile, feat_group, math.ceil(n_words / row_blocks),
                         smem, per_sm)


def _check_inputs(packed: torch.Tensor, gh: torch.Tensor, positions: torch.Tensor,
                  n_nodes: int, bits: int, chunk_rows: int | None = None) -> torch.Tensor:
    """Argument checks shared by the three wrappers; returns gh 8-byte
    aligned, since the kernels read each (g, h) as one float2. With
    `chunk_rows`, packed is a chunk stack whose chunks hold chunk_rows rows."""
    B.expect(packed, "packed", torch.int32, 2 if chunk_rows is None else 3)
    if chunk_rows is not None and not (
            chunk_rows > 0 and packed.shape[2] == -(-chunk_rows // (32 // bits))):
        raise ValueError(f"a chunk of {chunk_rows} rows of {bits}-bit symbols "
                         f"takes {-(-chunk_rows // (32 // bits))} words, the "
                         f"stack has {packed.shape[2]}")
    B.expect(gh, "gh", torch.float32, 2)
    B.expect(positions, "positions", torch.int32, 1)
    if gh.shape[1] != 2 or positions.shape[0] != gh.shape[0]:
        raise ValueError(f"gh must be (N, 2) and positions (N,), got "
                         f"{tuple(gh.shape)} and {tuple(positions.shape)}")
    if not 1 <= bits <= 32:
        raise ValueError(f"bits must be in [1, 32], got {bits}")
    if n_nodes < 1:
        raise ValueError(f"n_nodes must be positive, got {n_nodes}")
    return gh.clone() if gh.data_ptr() % 8 else gh


def _output(out: torch.Tensor | None, n_nodes: int, f: int, max_bins: int,
            dev: torch.device) -> torch.Tensor:
    """The histogram the kernel adds into: zeros, or the caller's `out`
    (checked, never zeroed)."""
    if out is None:
        return torch.zeros((n_nodes, f, max_bins, 2), dtype=torch.float32, device=dev)
    B.expect(out, "out", torch.float32, 4)
    if tuple(out.shape) != (n_nodes, f, max_bins, 2) or out.device != dev:
        raise ValueError(f"out must be ({n_nodes}, {f}, {max_bins}, 2) float32 on {dev}, "
                         f"got {tuple(out.shape)} on {out.device}")
    return out


def _words(packed: torch.Tensor, chunk_rows: int | None) -> tuple[int, int, int]:
    """(features, words a feature row, rows the words hold) of the flat
    words or of the chunk stack, whose chunks' words the kernels walk as one
    range of n_chunks * words_per_chunk."""
    if chunk_rows is None:
        f, w = packed.shape
        return f, w, None
    n_chunks, f, wpc = packed.shape
    return f, n_chunks * wpc, n_chunks * chunk_rows


def _chunk_args(packed: torch.Tensor, chunk_rows: int | None) -> tuple[int, int]:
    """(chunk_rows, words_per_chunk) for the C entry points: (0, 0) for the
    flat words, which selects the kernels' flat instantiation."""
    return (0, 0) if chunk_rows is None else (chunk_rows, packed.shape[2])


def build_histograms_packed_kernel(
    packed: torch.Tensor,  # (F, W) int32 words, or (n_chunks, F, words_per_chunk)
    gh: torch.Tensor,  # (N, 2) float32
    positions: torch.Tensor,  # (N,) int32, n_nodes (or -1) = inactive
    n_nodes: int,
    max_bins: int,
    bits: int,
    chunk_rows: int | None = None,  # given: packed is the chunk stack
    out: torch.Tensor | None = None,  # given: added into, not zeroed
) -> torch.Tensor:
    """Histogram (n_nodes, F, max_bins, 2) float32 on the card, through
    privatised shared-memory histograms; over the chunk stack in one launch
    when `chunk_rows` is given; added into `out` when given."""
    gh = _check_inputs(packed, gh, positions, n_nodes, bits, chunk_rows)
    f, w, held = _words(packed, chunk_rows)
    n = gh.shape[0]
    if (w * (32 // bits) if held is None else held) < n:
        raise ValueError(f"the packed words hold fewer than {n} rows")
    dev = packed.device
    out = _output(out, n_nodes, f, max_bins, dev)
    if w == 0 or f == 0:
        return out
    plan = launch_plan(w, f, n_nodes, max_bins, B.device_limits(dev.index),
                       PRIVATE_BLOCKS_PER_SM)
    err = B.lib().rt_histogram_private(
        packed.data_ptr(), gh.data_ptr(), positions.data_ptr(), out.data_ptr(),
        n, f, w, n_nodes, max_bins, bits, plan.node_tile, plan.feat_group,
        plan.words_per_block, plan.blocks_per_sm, THREADS, *_chunk_args(packed, chunk_rows),
        B.stream(dev),
    )
    B.check(err, "histogram_private")
    build_histograms_packed_kernel.launches += 1
    return out


def build_histograms_rows_kernel(
    packed: torch.Tensor,  # (F, W) int32 words, or (n_chunks, F, words_per_chunk)
    gh_sel: torch.Tensor,  # (m, 2) float32, (g, h) of each slot's row
    pos_sel: torch.Tensor,  # (m,) int32 node of each slot, n_nodes = dump
    row_ids: torch.Tensor,  # (m,) int32 row of each slot, past the words = padding
    n_nodes: int,
    max_bins: int,
    bits: int,
    chunk_rows: int | None = None,  # given: packed is the chunk stack
    out: torch.Tensor | None = None,  # given: added into, not zeroed
) -> torch.Tensor:
    """Histogram (n_nodes, F, max_bins, 2) float32 of the rows in a compacted
    buffer, added into `out` when given. A slot at the dump position, or
    whose row id lies outside the packed words (the stack's n_chunks *
    chunk_rows rows when `chunk_rows` is given), contributes nothing and its
    row is never read."""
    gh_sel = _check_inputs(packed, gh_sel, pos_sel, n_nodes, bits, chunk_rows)
    B.expect(row_ids, "row_ids", torch.int32, 1)
    if row_ids.shape[0] != pos_sel.shape[0]:
        raise ValueError(f"row_ids must be (m,) like pos_sel, got "
                         f"{tuple(row_ids.shape)} and {tuple(pos_sel.shape)}")
    f, w, _ = _words(packed, chunk_rows)
    m = pos_sel.shape[0]
    dev = packed.device
    out = _output(out, n_nodes, f, max_bins, dev)
    if m == 0 or w == 0 or f == 0:
        return out
    plan = launch_plan(m, f, n_nodes, max_bins, B.device_limits(dev.index))
    err = B.lib().rt_histogram_rows(
        packed.data_ptr(), gh_sel.data_ptr(), pos_sel.data_ptr(),
        row_ids.data_ptr(), out.data_ptr(), m, f, w, n_nodes, max_bins, bits,
        plan.node_tile, plan.feat_group, plan.words_per_block, THREADS,
        *_chunk_args(packed, chunk_rows), B.stream(dev),
    )
    B.check(err, "histogram_rows")
    build_histograms_rows_kernel.launches += 1
    return out


def histogram_packed(
    packed: torch.Tensor,  # (F, W) int32 words
    gh: torch.Tensor,  # (N, 2) float32
    positions: torch.Tensor,  # (N,) int32; n_nodes or -1 = inactive
    n_nodes: int,
    max_bins: int,
    bits: int,
) -> torch.Tensor:
    """Histogram (n_nodes, F, max_bins, 2) float32 on the card, every add a
    global atomic into the output."""
    gh = _check_inputs(packed, gh, positions, n_nodes, bits)
    f, w = packed.shape
    n = gh.shape[0]
    if w * (32 // bits) < n:
        raise ValueError(f"{w} words of {bits}-bit symbols hold fewer than {n} rows")
    dev = packed.device
    out = torch.zeros((n_nodes, f, max_bins, 2), dtype=torch.float32, device=dev)
    if w == 0 or f == 0:
        return out
    err = B.lib().rt_histogram_packed(
        packed.data_ptr(), gh.data_ptr(), positions.data_ptr(), out.data_ptr(),
        n, f, w, n_nodes, max_bins, bits, THREADS, B.stream(dev),
    )
    B.check(err, "histogram_packed")
    histogram_packed.launches += 1
    return out


def occupancy(kind: str, plan: HistogramPlan | None, bits: int) -> int:
    """Resident blocks per SM of one histogram kernel ("private", "rows" or
    "packed") at `plan`'s shared memory on the current card, as the CUDA
    runtime computes it; `histogram_packed` takes no plan."""
    kernel = ("private", "rows", "packed").index(kind)
    smem, plan_blocks = (plan.smem_bytes, plan.blocks_per_sm) if plan else (0, 0)
    blocks = ctypes.c_int(0)
    B.check(B.lib().rt_histogram_occupancy(kernel, bits, THREADS, smem, plan_blocks,
                                           ctypes.addressof(blocks)),
            "rt_histogram_occupancy")
    return blocks.value


build_histograms_packed_kernel.launches = 0
build_histograms_rows_kernel.launches = 0
histogram_packed.launches = 0
