"""Wrappers of the histogram CUDA kernels (`csrc/histogram.cu`).

All three compute the contract of `repro.core.histogram` (packed words,
(g, h) pairs and level-local positions in, (n_nodes, F, max_bins, 2) out),
in 64-bit fixed point (`kernels/fixed.py`): each row's (g, h) quantised at
the call's exponent and added as integers, each sum converted once to
float32. The result is the same bits on every call and is `torch.equal` to
the fixed-point plain versions (`kernels/ref.py`, `*_fixed_ref`):

* `build_histograms_packed_kernel`, counterpart of
  `repro.kernels.histogram.build_histograms_packed_kernel`: privatised
  shared-memory histograms and atomics instead of one-hot matmuls (each
  int64 of a (g, h) added as two native 32-bit atomics and a carry) and
  warp-aggregated adds where a warp shows repeated bins.
* `build_histograms_rows_kernel`, the same privatised design over a
  compacted row buffer (slot i holds row `row_ids[i]`), with several word
  loads in flight per slot: the kernel behind
  `core.histogram.build_histograms_packed_rows`, which the subtraction trick
  calls below the root.
* `histogram_packed`, counterpart of `repro.kernels.histogram.histogram_packed`,
  whose TPU kernel owns each (node block, feature block) output tile over
  all row blocks: here a thread-block cluster owns a tile (`packed_plan`),
  its blocks splitting the words, each adding into a private int64 tile in
  shared memory as #1 does (its missing bin too: node totals less the
  other bins), then summing the cluster's tiles through distributed shared
  memory and storing float32 into the output. No global atomics, no int64
  accumulator, no conversion pass: a call is the exponent's launch and
  this one.

The two private kernels never add a symbol of the missing bin
(`max_bins - 1`): each block adds minus the sum of its other bins into the
missing entry of each of its (node, feature)s, and its share of the node
totals (the feature groups of a stripe split the rows' totals between
them) into the missing entry of every feature; over the blocks that is the
missing bin, exactly (integers). Their private histograms hold
`max_bins - 1` bins a feature and node, 16 bytes a bin. The privatised
kernel takes one 1024-thread block an SM (`private_plan`), whose private
histogram may fill the SM's shared memory: 32 nodes at 256 bins (130 KB a
feature) in one node tile, every word read once.

Each takes the call's exponent (`exponent=`, an int32 0-d tensor on the
card, read by the kernel through a pointer) or computes it from its own gh
with `fixed_exponent`, one launch that also zeroes the private kernels'
int64 accumulator: a private kernel's call without `out=` is three launches
(the exponent and the zeroing, the histogram, the conversion pass
`dequantise_kernel`). Given `out=` (int64), the private kernels add into the
caller's accumulator as it stands, unconverted: the streamed
external-memory path (`core/stream.py`) adds one chunk's launch after
another into one running slab that way, at the pass's one exponent, and
converts once. Given `chunk_rows`, the private kernels read the
external-memory chunk stack instead of the flat words: `packed` is then
(n_chunks, F, words_per_chunk), row r's words are chunk r // chunk_rows's
at offset r % chunk_rows, a chunk's padding rows (and the rows past the
real ones of a short last chunk) add nothing, and the whole stack is read
in one launch (the kernels' chunked instantiation, `kChunked`). The plan
sizes the privatised kernel's grid over the stack's n_chunks *
words_per_chunk words as it sizes it over flat words.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build as B

# A block sweeps at least this many words (or slots) per stripe, so the
# flush of its private histogram stays small beside the work that filled it.
MIN_WORDS_PER_BLOCK = 1024
# The plan caps a block's private histogram so that this many blocks fit in
# one SM's shared memory: on spread-out bins, at one 224 KB block per SM the
# row-id kernel took 2-2.5x its time at four 56 KB blocks (float bodies).
MIN_BLOCKS_PER_SM = 3
# Threads per block of the row-id kernel, and of #1 where a word holds more
# than four symbols (the cluster kernel: `packed_threads`).
THREADS = 512
# The privatised kernel's blocks where a word holds at most four symbols:
# 1024 threads, one an SM (64 registers a thread fill its registers), so
# that a block may take the SM's whole shared memory: 32 nodes at 256 bins
# in one node tile, every word read once. Two 512-thread blocks an SM took
# two tiles: 0.4909 against 0.3341 ms by events at 32 nodes, Higgs-shaped
# words (PERF.md §6, tools/private_plans.py). Wider-symbol words keep two
# 512-thread blocks an SM (PRIVATE_NARROW_BLOCKS_PER_SM).
PRIVATE_THREADS = 1024
PRIVATE_BLOCKS_PER_SM = 1
PRIVATE_NARROW_BLOCKS_PER_SM = 2
# A stripe of #1 holds at least this many rows per bin that its block
# flushes (feat_group x node_tile x (max_bins - 1)): at 8 nodes, four
# waves of 1,894-word stripes took 0.248 ms where one wave of 7,576 took
# 0.225; at 32 nodes four waves of 13,158 beat one of 50,000 (0.334
# against 0.421; PERF.md §6).
FLUSH_ROWS = 2
# Bytes a (g, h) bin takes in the kernels' private histograms: two int64.
BIN_BYTES = 16
DEQUANTISE_THREADS = 256  # threads per block of the conversion pass
# The cluster kernel (`histogram_packed`): its cluster sizes (the portable
# ones, no per-card attribute), and a row's own work (its position, (g, h)
# and their quantisation), which every feature group of a tile repeats,
# counted as a share of one feature's symbols in `packed_plan`'s cost.
CLUSTER_SIZES = (1, 2, 4, 8)
ROW_WORK = 0.5


class HistogramPlan(NamedTuple):
    node_tile: int  # nodes per block (grid z = ceil(n_nodes / node_tile))
    feat_group: int  # features per block (grid y)
    words_per_block: int  # packed words (or buffer slots) per stripe (grid x)
    smem_bytes: int  # a block's private histogram and share of the node totals
    blocks_per_sm: int  # blocks whose shared memory and threads fit on one SM
    threads: int  # threads per block


def private_bytes(feat_group: int, node_tile: int, max_bins: int) -> int:
    """A block's dynamic shared memory: feat_group x node_tile x the
    max_bins - 1 bins it adds, an int64 (g, h) each, then its share of the
    node totals (csrc/histogram.cu private_launch_shape)."""
    return (feat_group * node_tile * (max_bins - 1) + node_tile) * BIN_BYTES


# Cached: a plan is host time in every wrapper call (row buffers' sizes vary).
@functools.lru_cache(maxsize=256)
def launch_plan(n_words: int, n_features: int, n_nodes: int, max_bins: int,
                limits: B.DeviceLimits,
                blocks_per_sm: int = MIN_BLOCKS_PER_SM,
                threads: int = THREADS) -> HistogramPlan:
    """Size a block's private histogram for occupancy: at most an SM's
    shared memory over `blocks_per_sm` (less the per-block reserve), so
    that that many blocks fit; nodes first (the rest go to further node
    tiles on the grid's z axis), then features beside them (feature groups
    on y), each split evenly. The stripes on x make about one wave of
    resident blocks of `threads` threads. The row kernel passes its slot
    count as `n_words`."""
    per_node = private_bytes(1, 1, max_bins)  # one feature, one node
    cap = min(limits.smem_block,
              limits.smem_sm // blocks_per_sm - limits.smem_reserved)
    if per_node > cap:  # one node's bins alone: take what one block may use
        cap = limits.smem_block
    if per_node > cap:
        raise ValueError(
            f"max_bins={max_bins} needs {per_node} B of shared memory per "
            f"node, more than the {cap} B a block may use")
    node_tiles = math.ceil(n_nodes / (cap // per_node))
    node_tile = math.ceil(n_nodes / node_tiles)
    per_feature = node_tile * (max_bins - 1) * BIN_BYTES  # its bins at the tile's nodes
    fit = ((cap - private_bytes(0, node_tile, max_bins)) // per_feature if per_feature
           else n_features)
    groups = math.ceil(n_features / max(1, min(fit, n_features)))
    feat_group = math.ceil(n_features / groups)
    smem = private_bytes(feat_group, node_tile, max_bins)
    per_sm = min(limits.smem_sm // (smem + limits.smem_reserved),
                 limits.threads_sm // threads)
    row_blocks = max(1, min(math.ceil(n_words / MIN_WORDS_PER_BLOCK),
                            math.ceil(per_sm * limits.n_sm / (groups * node_tiles))))
    return HistogramPlan(node_tile, feat_group, math.ceil(n_words / row_blocks),
                         smem, per_sm, threads)


@functools.lru_cache(maxsize=256)
def private_plan(n_words: int, n_features: int, n_nodes: int, max_bins: int, bits: int,
                 limits: B.DeviceLimits) -> HistogramPlan:
    """The privatised kernel's plan. Where a word holds at most four symbols:
    `launch_plan` for one PRIVATE_THREADS block an SM, its stripes then made
    for four waves of such blocks, or two, or one, the most at which a
    stripe's rows number at least FLUSH_ROWS times the bins its block
    flushes. Where a word holds more: two 512-thread blocks an SM."""
    spw = 32 // bits
    if spw > 4:
        return launch_plan(n_words, n_features, n_nodes, max_bins, limits,
                           PRIVATE_NARROW_BLOCKS_PER_SM)
    plan = launch_plan(n_words, n_features, n_nodes, max_bins, limits,
                       PRIVATE_BLOCKS_PER_SM, PRIVATE_THREADS)
    blocks_a_stripe = (math.ceil(n_features / plan.feat_group)
                       * math.ceil(n_nodes / plan.node_tile))
    flushed = plan.feat_group * plan.node_tile * (max_bins - 1)
    for waves in (4, 2, 1):
        stripes = max(1, min(math.ceil(n_words / MIN_WORDS_PER_BLOCK),
                             math.ceil(waves * PRIVATE_BLOCKS_PER_SM * limits.n_sm
                                       / blocks_a_stripe)))
        words = math.ceil(n_words / stripes)
        if words * spw >= FLUSH_ROWS * flushed:
            break
    return plan._replace(words_per_block=words)


class PackedPlan(NamedTuple):
    node_tile: int  # nodes a tile (grid z = ceil(n_nodes / node_tile))
    feat_group: int  # features a tile (grid y)
    cluster: int  # blocks a cluster, each a stripe of the words (grid x)
    words_per_block: int  # a stripe: ceil(n_words / cluster)
    smem_bytes: int  # a block's private tile and its warps' node totals
    threads: int  # threads per block


def packed_threads(bits: int) -> int:
    """The cluster kernel's threads a block (csrc/histogram.cu
    cluster_threads): 1024 up to four symbols a word, 512 up to ten, 256
    for 16 and 32 (1- and 2-bit words), whose rows' registers would spill
    at 128 a thread."""
    spw = 32 // bits
    return 256 if spw > 10 else THREADS if spw > 4 else PRIVATE_THREADS


def packed_bytes(feat_group: int, node_tile: int, max_bins: int, threads: int) -> int:
    """A cluster block's shared memory: its private tile, feat_group x
    node_tile x max_bins (g, h) pairs of int64, and each of its warps' node
    totals (csrc/histogram.cu cluster_tile_bytes)."""
    return (feat_group * node_tile * max_bins + threads // 32 * node_tile) * BIN_BYTES


@functools.lru_cache(maxsize=256)
def packed_plan(n_words: int, n_features: int, n_nodes: int, max_bins: int, bits: int,
                limits: B.DeviceLimits) -> PackedPlan:
    """The cluster kernel's plan. Node tiles as few as the opt-in shared
    memory allows, split evenly; then, of every feature group size that
    fits beside them and every cluster size, the one whose blocks finish
    first: waves of the card's clusters (an SM a block, a GPC's share of 8
    SMs at a time: the SMs rounded down to a multiple of 8) times a
    block's words times its features (plus ROW_WORK for the rows), ties to
    fewer blocks. One node's bins that do not fit a block raise."""
    threads = packed_threads(bits)
    per_node = packed_bytes(1, 1, max_bins, threads)
    if per_node > limits.smem_block:
        raise ValueError(f"max_bins={max_bins} needs {per_node} B of shared memory per "
                         f"node, more than the {limits.smem_block} B a block may use")
    node_tiles = math.ceil(n_nodes / (limits.smem_block // per_node))
    node_tile = math.ceil(n_nodes / node_tiles)
    per_feature = packed_bytes(1, node_tile, max_bins, 0)  # its bins at the tile's nodes
    room = limits.smem_block - packed_bytes(0, node_tile, max_bins, threads)
    fit = max(1, min(n_features, room // per_feature))
    slots = max(8, limits.n_sm // 8 * 8)
    best = None
    for most in range(fit, 0, -1):
        groups = math.ceil(n_features / most)
        feat_group = math.ceil(n_features / groups)
        for cluster in CLUSTER_SIZES:
            blocks = node_tiles * groups * cluster
            words = max(1, math.ceil(n_words / cluster))
            cost = math.ceil(blocks / slots) * words * (feat_group + ROW_WORK)
            if best is None or (cost, blocks) < best[0]:
                best = ((cost, blocks), feat_group, cluster, words)
    _, feat_group, cluster, words = best
    return PackedPlan(node_tile, feat_group, cluster, words,
                      packed_bytes(feat_group, node_tile, max_bins, threads), threads)


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


def fixed_exponent(gh: torch.Tensor, zero: torch.Tensor | None = None) -> torch.Tensor:
    """The call's exponent (`fixed.exponent(gh)`, its plain version, bit for
    bit) for the (n, 2) float32 (g, h) on the card, an int32 0-d tensor there,
    in one launch that also zeroes `zero` (a contiguous int64 tensor on the
    same card) when given."""
    B.expect(gh, "gh", torch.float32, 2)
    if gh.shape[1] != 2 or gh.data_ptr() % 8:
        raise ValueError(f"gh must be (N, 2) and 8-byte aligned, got {tuple(gh.shape)}")
    if zero is not None:
        B.expect(zero, "zero", torch.int64, zero.ndim)
        if zero.device != gh.device:
            raise ValueError(f"zero must be on {gh.device}, got {zero.device}")
    k = torch.empty((), dtype=torch.int32, device=gh.device)
    B.launch("rt_fixed_exponent", gh.device, gh.data_ptr(), gh.shape[0], k.data_ptr(),
             zero.data_ptr() if zero is not None else None,
             zero.numel() if zero is not None else 0)
    B.count(fixed_exponent)
    return k


def _check_exponent(exponent: torch.Tensor | None, dev: torch.device) -> None:
    if exponent is not None:
        B.expect(exponent, "exponent", torch.int32, 0)
        if exponent.device != dev:
            raise ValueError(f"exponent must be on {dev}, got {exponent.device}")


def _accumulator(out: torch.Tensor | None, exponent: torch.Tensor | None,
                 gh: torch.Tensor, n_nodes: int, f: int,
                 max_bins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(the int64 accumulator the kernel adds into, the call's exponent):
    the caller's `out` (checked, never zeroed) or a new one, zeroed in the
    exponent kernel's launch when the exponent is computed from gh."""
    dev = gh.device
    _check_exponent(exponent, dev)
    if out is not None:
        B.expect(out, "out", torch.int64, 4)
        if tuple(out.shape) != (n_nodes, f, max_bins, 2) or out.device != dev:
            raise ValueError(f"out must be ({n_nodes}, {f}, {max_bins}, 2) int64 on "
                             f"{dev}, got {tuple(out.shape)} on {out.device}")
        return out, exponent if exponent is not None else fixed_exponent(gh)
    acc = torch.empty((n_nodes, f, max_bins, 2), dtype=torch.int64, device=dev)
    if exponent is None:
        return acc, fixed_exponent(gh, zero=acc)
    return acc.zero_(), exponent


def dequantise_kernel(acc: torch.Tensor, exponent: torch.Tensor) -> torch.Tensor:
    """float32 histogram from an int64 accumulator at `exponent`, through
    the conversion pass (`fixed.dequantise` computes the same bits)."""
    B.expect(exponent, "exponent", torch.int32, 0)
    if not acc.is_contiguous() or acc.dtype != torch.int64 or not acc.is_cuda:
        raise ValueError("acc must be a contiguous int64 CUDA tensor")
    out = torch.empty(acc.shape, dtype=torch.float32, device=acc.device)
    if acc.numel():
        B.launch("rt_histogram_dequantise", acc.device, acc.data_ptr(),
                 exponent.data_ptr(), out.data_ptr(), acc.numel(), DEQUANTISE_THREADS)
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
    out: torch.Tensor | None = None,  # given: int64 accumulator, added into
    exponent: torch.Tensor | None = None,  # int32 0-d; None: from gh
) -> torch.Tensor:
    """Histogram (n_nodes, F, max_bins, 2) float32 on the card, through
    privatised shared-memory histograms; over the chunk stack in one launch
    when `chunk_rows` is given. Given `out`, the quantised rows are added
    into that int64 accumulator, which is returned unconverted."""
    gh = _check_inputs(packed, gh, positions, n_nodes, bits, chunk_rows)
    f, w, held = _words(packed, chunk_rows)
    n = gh.shape[0]
    if (w * (32 // bits) if held is None else held) < n:
        raise ValueError(f"the packed words hold fewer than {n} rows")
    dev = packed.device
    acc, k = _accumulator(out, exponent, gh, n_nodes, f, max_bins)
    if w > 0 and f > 0:
        plan = private_plan(w, f, n_nodes, max_bins, bits, B.device_limits(dev.index))
        B.launch("rt_histogram_private", dev,
                 packed.data_ptr(), gh.data_ptr(), positions.data_ptr(), acc.data_ptr(),
                 k.data_ptr(), n, f, w, n_nodes, max_bins, bits, plan.node_tile,
                 plan.feat_group, plan.words_per_block, plan.threads,
                 *_chunk_args(packed, chunk_rows))
        B.count(build_histograms_packed_kernel)
    return acc if out is not None else dequantise_kernel(acc, k)


def build_histograms_rows_kernel(
    packed: torch.Tensor,  # (F, W) int32 words, or (n_chunks, F, words_per_chunk)
    gh_sel: torch.Tensor,  # (m, 2) float32, (g, h) of each slot's row
    pos_sel: torch.Tensor,  # (m,) int32 node of each slot, n_nodes = dump
    row_ids: torch.Tensor,  # (m,) int32 row of each slot, past the words = padding
    n_nodes: int,
    max_bins: int,
    bits: int,
    chunk_rows: int | None = None,  # given: packed is the chunk stack
    out: torch.Tensor | None = None,  # given: int64 accumulator, added into
    exponent: torch.Tensor | None = None,  # int32 0-d; None: from gh_sel
) -> torch.Tensor:
    """Histogram (n_nodes, F, max_bins, 2) float32 of the rows in a compacted
    buffer; given `out`, added into that int64 accumulator, which is
    returned unconverted. A slot at the dump position, or whose row id lies
    outside the packed words (the stack's n_chunks * chunk_rows rows when
    `chunk_rows` is given), contributes nothing and its row is never
    read."""
    gh_sel = _check_inputs(packed, gh_sel, pos_sel, n_nodes, bits, chunk_rows)
    B.expect(row_ids, "row_ids", torch.int32, 1)
    if row_ids.shape[0] != pos_sel.shape[0]:
        raise ValueError(f"row_ids must be (m,) like pos_sel, got "
                         f"{tuple(row_ids.shape)} and {tuple(pos_sel.shape)}")
    f, w, _ = _words(packed, chunk_rows)
    m = pos_sel.shape[0]
    dev = packed.device
    acc, k = _accumulator(out, exponent, gh_sel, n_nodes, f, max_bins)
    if m > 0 and w > 0 and f > 0:
        plan = launch_plan(m, f, n_nodes, max_bins, B.device_limits(dev.index))
        B.launch("rt_histogram_rows", dev,
                 packed.data_ptr(), gh_sel.data_ptr(), pos_sel.data_ptr(),
                 row_ids.data_ptr(), acc.data_ptr(), k.data_ptr(), m, f, w, n_nodes,
                 max_bins, bits, plan.node_tile, plan.feat_group, plan.words_per_block,
                 plan.threads, *_chunk_args(packed, chunk_rows))
        B.count(build_histograms_rows_kernel)
    return acc if out is not None else dequantise_kernel(acc, k)


def histogram_packed(
    packed: torch.Tensor,  # (F, W) int32 words
    gh: torch.Tensor,  # (N, 2) float32
    positions: torch.Tensor,  # (N,) int32; n_nodes or -1 = inactive
    n_nodes: int,
    max_bins: int,
    bits: int,
    exponent: torch.Tensor | None = None,  # int32 0-d; None: from gh
) -> torch.Tensor:
    """Histogram (n_nodes, F, max_bins, 2) float32 on the card, each output
    tile summed and converted by the thread-block cluster that owns it
    (`packed_plan`); with `exponent`, in one launch. One node's max_bins
    bins must fit a block's shared memory (`packed_plan` raises)."""
    gh = _check_inputs(packed, gh, positions, n_nodes, bits)
    f, w = packed.shape
    n = gh.shape[0]
    if w * (32 // bits) < n:
        raise ValueError(f"{w} words of {bits}-bit symbols hold fewer than {n} rows")
    dev = packed.device
    _check_exponent(exponent, dev)
    out = torch.empty((n_nodes, f, max_bins, 2), dtype=torch.float32, device=dev)
    if f == 0:
        return out
    plan = packed_plan(w, f, n_nodes, max_bins, bits, B.device_limits(dev.index))
    k = exponent if exponent is not None else fixed_exponent(gh)
    B.launch("rt_histogram_packed", dev,
             packed.data_ptr(), gh.data_ptr(), positions.data_ptr(), out.data_ptr(),
             k.data_ptr(), n, f, w, n_nodes, max_bins, bits, plan.node_tile,
             plan.feat_group, plan.cluster, plan.words_per_block, plan.threads)
    B.count(histogram_packed)
    return out


def occupancy(kind: str, plan: HistogramPlan | PackedPlan, bits: int,
              clusters: bool = False) -> int:
    """Resident blocks per SM of one histogram kernel ("private", "rows" or
    "packed") at `plan`'s threads and shared memory on the current card, as
    the CUDA runtime computes it; with `clusters`, the cluster kernel's
    clusters of `plan.cluster` blocks that the whole card holds at once."""
    kernel = ("private", "rows", "packed").index(kind)
    out = ctypes.c_int(0)
    B.check(B.lib().rt_histogram_occupancy(kernel, bits, plan.threads, plan.smem_bytes,
                                           plan.cluster if clusters else 0,
                                           ctypes.addressof(out)),
            "rt_histogram_occupancy")
    return out.value


# The kernels `device_kernels` names, by the code the C side gives a node.
KERNEL_NAMES = {0: "fixed_exponent_kernel", 1: "histogram_private_kernel",
                2: "histogram_rows_kernel", 3: "histogram_cluster_kernel",
                4: "histogram_dequantise_kernel", -1: "another kernel",
                -2: "not a kernel"}


def device_kernels(call, device: torch.device, max_nodes: int = 64) -> list[str]:
    """What one `call()` puts on `device`'s stream, in launch order, by
    kernel name (`KERNEL_NAMES`): the call is captured into a CUDA graph
    that is never launched, so the count is the device's own record, not the
    wrappers' counters. The call first runs once on the capture's stream,
    uncaptured, so that the caching allocator holds its buffers there."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    codes = (ctypes.c_int * max_nodes)()
    n_nodes = ctypes.c_int(0)
    with torch.cuda.stream(side):
        call()
        side.synchronize()
        B.check(B.lib().rt_capture_begin(side.cuda_stream), "capture_begin")
        try:
            call()
        finally:
            B.check(B.lib().rt_capture_kernels(side.cuda_stream, ctypes.addressof(codes),
                                               max_nodes, ctypes.addressof(n_nodes)),
                    "capture_kernels")
    if n_nodes.value > max_nodes:
        raise ValueError(f"the call made {n_nodes.value} device nodes, more than {max_nodes}")
    return [KERNEL_NAMES[codes[i]] for i in range(n_nodes.value)]


build_histograms_packed_kernel.launches = 0
build_histograms_rows_kernel.launches = 0
histogram_packed.launches = 0
fixed_exponent.launches = 0
