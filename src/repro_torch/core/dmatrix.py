"""DeviceDMatrix — the quantised, compressed training matrix (paper Figure 1,
left boxes); counterpart of the constructor of `repro.core.dmatrix.DeviceDMatrix`.

Construction runs quantile generation (`compute_cuts`) -> quantisation
(`quantize`) -> bit-packing (`compress`) ONCE, on the matrix's device.
Evaluation and prediction sets share the training cuts through `ref=`, so
bin-space traversal agrees exactly with raw-threshold traversal:

    dtrain = DeviceDMatrix(x_train, label=y_train)        # cuda by default
    dvalid = DeviceDMatrix(x_valid, label=y_valid, ref=dtrain)
    drank = DeviceDMatrix(x, label=rel, group_ids=qid)   # rank:pairwise

Two batch-iterator constructors, as in the reference:

  * `DeviceDMatrix.from_batches(batches)` assembles the SAME in-memory
    matrix from an iterator of chunks, bit for bit the matrix of the
    concatenated array.
  * `ExternalDMatrix(batches, chunk_rows=...)` never builds the flat
    matrix: cut points stream through `StreamingQuantileSketch` (or come
    from `cuts="exact"`, an array or `ref=`), each chunk is quantised and
    bit-packed on its own, and the packed chunks live on the host as one
    (n_chunks, n_features, words_per_chunk) uint32 stack with a crc32 per
    chunk. Training either pages the stack onto the device once
    ("resident" paging: both histogram kernels read the whole stack in
    one launch a level) or streams it ("stream" paging, `core/stream.py`:
    the stack stays on the host and `ChunkPager` stages one chunk at a
    time through a ring of pinned and device slots on a copy stream, the
    kernels launched once a chunk).

    dext = ExternalDMatrix(batches, chunk_rows=131072)   # cuda by default
    bst = Booster(n_rounds=100).fit(dext)
    dbig = ExternalDMatrix(batches, paging="stream", prefetch_chunks=2)

A fit on an ExternalDMatrix, resident or streamed, is bit for bit the fit
on the DeviceDMatrix of the same rows and cuts: on the CPU the plain
versions add in row order either way; on the card every layout adds the
same 64-bit fixed-point integers at the same exponent (`kernels/fixed.py`,
`core/stream.py`). `sketch_shards=k` builds one sketch a shard of chunks and merges
them by `dist.tree_merge`, as the reference does.
"""
from __future__ import annotations

import collections
import warnings

import numpy as np
import torch

from repro_torch.core import compress as C
from repro_torch.core import quantile as Q
from repro_torch.core import resilience as RES
from repro_torch.device import as_tensor, resolve_device
from repro_torch.testing import faults as FA


def _split_batch_item(item, index: int):
    """One iterator item -> (x, label | None, group_ids | None)."""
    if isinstance(item, (tuple, list)):
        if not 1 <= len(item) <= 3:
            raise ValueError(
                f"batch {index}: expected x, (x, y) or (x, y, group_ids), "
                f"got a {len(item)}-tuple"
            )
        return tuple(item) + (None,) * (3 - len(item))
    return item, None, None


def _collect_batches(batches):
    """Validate and materialise a batch iterator as host float32 chunks.

    Every chunk must be a 2-D numeric array with the same n_features and
    the same dtype as the first chunk, and labels/group_ids must be present
    either for every chunk or for none, with lengths matching their chunk —
    anything else raises a ValueError naming the offending batch (instead
    of an opaque shape error deep inside quantise/compress).

    Returns (x_chunks, label or None, group_ids or None, n_features).
    """
    xs, ys, gs = [], [], []
    n_features = None
    dtype0 = None
    for i, item in enumerate(batches):
        x, y, g = _split_batch_item(item, i)
        x = np.asarray(x)
        if x.dtype == object or not (
            np.issubdtype(x.dtype, np.number) or x.dtype == np.bool_
        ):
            raise ValueError(
                f"batch {i} has non-numeric dtype {x.dtype!r}; batches must "
                "be numeric 2-D arrays"
            )
        if x.ndim != 2:
            raise ValueError(
                f"batch {i} must be 2-D (rows, n_features), got shape {x.shape}"
            )
        if x.shape[0] == 0:
            raise ValueError(f"batch {i} is empty (0 rows)")
        if x.shape[1] == 0:
            raise ValueError(f"batch {i} has 0 features")
        if n_features is None:
            n_features, dtype0 = x.shape[1], x.dtype
        else:
            if x.shape[1] != n_features:
                raise ValueError(
                    f"batch {i} has {x.shape[1]} features but batch 0 had "
                    f"{n_features}; all batches must agree"
                )
            if x.dtype != dtype0:
                raise ValueError(
                    f"batch {i} has dtype {x.dtype!r} but batch 0 had "
                    f"{dtype0!r}; all batches must agree"
                )
        if (y is None) != (not ys) and i > 0:
            raise ValueError(
                f"batch {i} {'has no label but earlier batches did' if y is None else 'has a label but earlier batches did not'}"
                "; labels must be given for every batch or for none"
            )
        if y is not None:
            y = np.asarray(y, np.float32).reshape(-1)
            if y.shape[0] != x.shape[0]:
                raise ValueError(
                    f"batch {i}: label has {y.shape[0]} rows, x has {x.shape[0]}"
                )
            if not np.isfinite(y).all():
                raise ValueError(
                    f"batch {i}: label contains non-finite values (NaN/inf); "
                    "clean or drop those rows before training"
                )
            ys.append(y)
        if (g is None) != (not gs) and i > 0:
            raise ValueError(
                f"batch {i}: group_ids must be given for every batch or none"
            )
        if g is not None:
            g = np.asarray(g, np.int32).reshape(-1)
            if g.shape[0] != x.shape[0]:
                raise ValueError(
                    f"batch {i}: group_ids has {g.shape[0]} rows, "
                    f"x has {x.shape[0]}"
                )
            gs.append(g)
        xf = np.ascontiguousarray(x, np.float32)
        if np.isinf(xf).any():
            raise ValueError(
                f"batch {i} contains infinite feature values; replace ±inf "
                "with NaN (legal missing marker) or a large finite value "
                "before quantisation"
            )
        xs.append(xf)
    if not xs:
        raise ValueError("batch iterator produced no batches")
    label = np.concatenate(ys) if ys else None
    groups = np.concatenate(gs) if gs else None
    return xs, label, groups, n_features



def _push_chunk_sorted(sk: "Q.StreamingQuantileSketch", chunk: np.ndarray,
                       device: torch.device) -> None:
    """Fold one host chunk into a sketch via the sorted fast path: the
    chunk's columns sorted on `device` (`torch.sort`; a sort is exact, so
    the sorted columns are the reference's `np.sort`'s), NaN filled with
    +inf so it sorts to the tail, then `push_sorted` on the host with each
    column's finite count."""
    x = torch.as_tensor(chunk, device=device)
    finite = torch.isfinite(x)
    cols = torch.sort(torch.where(finite, x, float("inf")), dim=0).values
    sk.push_sorted(cols.cpu().numpy(), finite.sum(dim=0).cpu().numpy())


def cuts_equal(a: torch.Tensor | None, b: torch.Tensor | None) -> bool:
    """Identity-or-value equality of two cut-point arrays."""
    if a is b:
        return True
    if a is None or b is None:
        return False
    return a.device == b.device and torch.equal(a, b)


class DeviceDMatrix:
    """Device-resident quantised + compressed data matrix.

    Args:
      x: (n_rows, n_features) float array (numpy or torch), NaN = missing.
      label: optional (n_rows,) targets; required for `Booster.fit`.
      group_ids: optional (n_rows,) int query-group ids (rank:pairwise and
        ndcg@k), kept as an int32 tensor on the matrix's device. Ids need
        not be contiguous or sorted.
      max_bins: total bins per feature incl. the reserved missing bin.
      ref: another DeviceDMatrix whose cut points, max_bins and device to
        reuse — required for evaluation and prediction sets.
      cuts: optional precomputed (n_features, max_bins - 2) cut array.
        Mutually exclusive with `ref`.
      device: "cuda" (the default, None) or "cpu". Without a card a CUDA
        matrix raises instead of falling back to the CPU.
    """

    def __init__(
        self,
        x,
        label=None,
        *,
        group_ids=None,
        max_bins: int = Q.DEFAULT_MAX_BINS,
        ref: "DeviceDMatrix | None" = None,
        cuts=None,
        device=None,
    ):
        if ref is not None and device is None:
            device = ref.device
        dev = resolve_device(device)
        if ref is not None and dev != ref.device:
            raise ValueError(f"ref lives on {ref.device}, not on {dev}")
        x = as_tensor(x, dev)
        if x.ndim != 2:
            raise ValueError(f"x must be 2-D (n_rows, n_features), got {tuple(x.shape)}")
        if x.shape[0] == 0:
            raise ValueError(
                "x has 0 rows; cannot build a DeviceDMatrix from an empty matrix"
            )
        if x.shape[1] == 0:
            raise ValueError(
                "x has 0 features; every row needs at least one feature column"
            )
        if bool(torch.isinf(x).any()):
            raise ValueError(
                "x contains infinite feature values; replace ±inf with NaN "
                "(the legal missing marker) or a large finite value before "
                "quantisation"
            )
        if ref is not None:
            if cuts is not None:
                raise ValueError(
                    "pass either ref= or cuts=, not both (ref already "
                    "carries its cut points)"
                )
            cuts = ref.cuts
            max_bins = ref.max_bins
            if x.shape[1] != ref.n_features:
                raise ValueError(
                    f"ref has {ref.n_features} features, x has {x.shape[1]}"
                )
        elif cuts is not None:
            cuts = as_tensor(cuts, dev)
            nvb = Q.n_value_bins(max_bins)
            if tuple(cuts.shape) != (x.shape[1], nvb - 1):
                raise ValueError(
                    f"cuts must have shape ({x.shape[1]}, {nvb - 1}) for "
                    f"max_bins={max_bins}, got {tuple(cuts.shape)}"
                )
        else:
            cuts = Q.compute_cuts(x, max_bins)
        self.device = dev
        bins = Q.quantize(x, cuts)
        self.matrix: C.CompressedMatrix = C.compress(bins, cuts, max_bins)
        # Per-shard repacked words of sharded fits, keyed by shard count and
        # devices: paid once a (matrix, mesh), not once a fit (dist.runner).
        self._shard_pack_cache: dict = {}
        self.label = None if label is None else as_tensor(label, dev).reshape(-1)
        if self.label is not None and self.label.shape[0] != self.n_rows:
            raise ValueError(
                f"label has {self.label.shape[0]} rows, x has {self.n_rows}"
            )
        if self.label is not None and not bool(torch.isfinite(self.label).all()):
            raise ValueError(
                "label contains non-finite values (NaN/inf); clean or drop "
                "those rows before training"
            )
        # Checked here, not left to the gradient: the pairwise kernel would
        # read a short group_ids past its end.
        self.group_ids = (None if group_ids is None
                          else as_tensor(group_ids, dev, torch.int32).reshape(-1))
        if self.group_ids is not None and self.group_ids.shape[0] != self.n_rows:
            raise ValueError(
                f"group_ids has {self.group_ids.shape[0]} rows, x has {self.n_rows}"
            )

    @property
    def cuts(self) -> torch.Tensor:
        return self.matrix.cuts

    @property
    def max_bins(self) -> int:
        return self.matrix.max_bins

    @property
    def bits(self) -> int:
        return self.matrix.bits

    @property
    def n_rows(self) -> int:
        return self.matrix.n_rows

    @property
    def n_features(self) -> int:
        return self.matrix.n_features

    @property
    def nbytes(self) -> int:
        """Device bytes held: packed words + cut points + labels/groups."""
        total = self.matrix.nbytes_compressed() + self.cuts.numel() * 4
        if self.label is not None:
            total += self.label.shape[0] * 4
        if self.group_ids is not None:
            total += self.group_ids.shape[0] * 4
        return total

    @classmethod
    def from_batches(
        cls,
        batches,
        *,
        max_bins: int = Q.DEFAULT_MAX_BINS,
        ref: "DeviceDMatrix | None" = None,
        device=None,
    ) -> "DeviceDMatrix":
        """Build the in-memory matrix from an iterator of chunks.

        `batches` yields `x`, `(x, y)` or `(x, y, group_ids)` chunks; they
        are validated (consistent n_features/dtype, matching label lengths
        — a clear ValueError naming the batch) and assembled into exactly
        the matrix `DeviceDMatrix(concat(chunks), ...)` would produce, bit
        for bit. For data that must never be resident all at once, use
        `ExternalDMatrix` instead.
        """
        xs, label, groups, _ = _collect_batches(batches)
        x = xs[0] if len(xs) == 1 else np.concatenate(xs)
        return cls(x, label=label, group_ids=groups, max_bins=max_bins, ref=ref,
                   device=device)

    def packed_bins(self) -> C.PackedBins:
        return self.matrix.as_packed_bins()

    def compression_ratio(self) -> float:
        return self.matrix.compression_ratio()

    def same_cuts(self, other) -> bool:
        return cuts_equal(self.cuts, getattr(other, "cuts", None))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"DeviceDMatrix({self.n_rows}x{self.n_features}, {self.bits}-bit, "
            f"max_bins={self.max_bins}, {self.device}"
            f"{', labelled' if self.label is not None else ''}"
            f"{', grouped' if self.group_ids is not None else ''})"
        )


class ChunkPager:
    """Bounded prefetcher over a sequence of chunk indices, through a ring
    of `slots` chunk slots.

    `load_fn(i)` does a chunk's host work (the fault sites, the crc32 check
    and retries: `ExternalDMatrix._host_chunk`). Iterating yields `(index,
    chunk)` pairs in the order of `indices`. The pager keeps up to `depth`
    chunks issued ahead of the one the consumer holds, so the ring has
    depth + 1 slots (fewer when there are fewer indices); `depth <= 0` loads
    each chunk when it is asked for. The same yields in the same order
    either way: the consumer's arithmetic never depends on the depth.

    On a card (`device` a CUDA device) each slot owns one chunk's words in
    pinned host memory and on the device, allocated once for the pager
    (`device_slots` counts the device ones). Issuing chunk i: the host work,
    a memcpy into its slot's pinned buffer, then `copy_(...,
    non_blocking=True)` into the slot's device buffer on the pager's own
    copy stream and an event recorded after it. The consumer's stream waits
    on that event before the chunk is handed out, so the copies of the
    chunks issued ahead run while the kernels on the current one do. Two
    reuse hazards, both guarded:
      * a pinned buffer is not written before the copy that reads it has
        run: the host waits on that copy's event first;
      * a device buffer is not overwritten before the kernels that read it
        have run: the consumer's stream records an event when the consumer
        asks for the next chunk, and the copy stream waits on it before the
        next copy into that slot.
    The chunk handed out IS the slot's device buffer: read it before asking
    for the next chunk, or clone it. Elsewhere (`device` None: the CPU, or a
    stack already on the device) `load_fn` returns the chunk itself, a
    tensor of its own.

    The issuing runs on the consumer's thread. A worker thread that staged
    the chunks (the reference's design) cost more in handing the
    interpreter lock back and forth than it overlapped: on the card a
    streamed fit took twice as long with it at prefetch 2 as at prefetch 0
    (PERF.md §6, `tools/pager_parts.py`).

    An exception raised by `load_fn` (after its own retry policy is
    exhausted) is raised to the consumer in its chunk's turn, after the
    chunks before it; nothing past it is issued. `close()` (called when
    iteration ends, breaks or raises) orders the consumer's stream after
    every copy issued, so the slots may be freed.
    """

    def __init__(self, load_fn, indices, depth: int, device: torch.device | None = None,
                 slot_shape: tuple[int, int] | None = None):
        self._load = load_fn
        self._indices = list(indices)
        self.slots = max(1, min(depth + 1, len(self._indices)))
        self._cuda = device is not None and device.type == "cuda"
        self.device_slots = 0
        if self._cuda:
            self._device = device
            self._pinned = [torch.empty(slot_shape, dtype=torch.int32, pin_memory=True)
                            for _ in range(self.slots)]
            self._dev = [torch.empty(slot_shape, dtype=torch.int32, device=device)
                         for _ in range(self.slots)]
            self.device_slots = self.slots
            self._copied: list = [None] * self.slots  # each slot's last copy event
            self._released: list = [None] * self.slots  # its last reader's event
            self._copy_stream = torch.cuda.Stream(device=device)

    def _issue(self, i: int, slot: int):
        """Chunk i into `slot`: (chunk, copy event or None, exception or None)."""
        try:
            host = self._load(i)
        except Exception as exc:  # raised to the consumer in this chunk's turn
            return None, None, exc
        if not self._cuda:
            return host, None, None
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()  # the pinned buffer's last copy has run
        self._pinned[slot].copy_(torch.from_numpy(host.view(np.int32)))
        with torch.cuda.stream(self._copy_stream):
            if self._released[slot] is not None:
                self._copy_stream.wait_event(self._released[slot])  # its readers ran
            self._dev[slot].copy_(self._pinned[slot], non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        self._copied[slot] = copied
        return self._dev[slot], copied, None

    def __iter__(self):
        issued: collections.deque = collections.deque()
        n = len(self._indices)
        try:
            for pos, i in enumerate(self._indices):
                while len(issued) < self.slots and pos + len(issued) < n:
                    if issued and issued[-1][2] is not None:
                        break  # nothing past a failed chunk is issued
                    nxt = pos + len(issued)
                    issued.append(self._issue(self._indices[nxt], nxt % self.slots))
                chunk, copied, exc = issued.popleft()
                if exc is not None:
                    raise exc
                if copied is not None:
                    torch.cuda.current_stream(self._device).wait_event(copied)
                yield i, chunk
                if self._cuda:
                    released = torch.cuda.Event()
                    released.record(torch.cuda.current_stream(self._device))
                    self._released[pos % self.slots] = released
        finally:
            self.close()

    def close(self) -> None:
        """Order the consumer's stream after every copy issued, so the slots
        may be freed (idempotent)."""
        if self._cuda:
            torch.cuda.current_stream(self._device).wait_stream(self._copy_stream)

    def __enter__(self) -> "ChunkPager":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False



def _normalize_verify(verify) -> str:
    """verify_chunks knob -> one of 'once' | 'always' | 'never'."""
    if verify is True:
        return "once"
    if verify is False:
        return "never"
    if verify in ("once", "always", "never"):
        return verify
    raise ValueError(
        "verify_chunks must be True ('once'), False ('never'), 'once', "
        f"'always' or 'never', got {verify!r}"
    )




class ExternalDMatrix:
    """External-memory training matrix: host-resident bit-packed chunks.

    The flat (n_rows, n_features) matrix never exists on the device — not
    as floats, not as dense bins. Cut points come from a streaming quantile
    sketch (one pass over the chunks, bounded memory), each chunk is then
    quantised and bit-packed on its own (on the device, one chunk at a
    time), and the packed chunks are kept on the host as one
    (n_chunks, n_features, words_per_chunk) uint32 stack, with a crc32 of
    each chunk recorded at build. With resident paging `packed_bins()`
    pages the stack onto the device once (cached; `unload()` drops it) as a
    `ChunkedPackedBins` that the booster grows every tree from: both
    histogram kernels read the whole stack in one launch a level. With
    streamed paging the booster grows from `stream.StreamedChunkedBins`,
    which pages chunks through `chunk_pager` pass after pass, and
    `stream_stats` keeps the last streamed fit's counters.

    Labels, group ids and per-round gradients stay on the device (they are
    O(n), the matrix is O(n * f)).

    A fit on this matrix is bit for bit the fit on the DeviceDMatrix of
    the same rows and cuts, on the CPU (the plain versions add in row order
    either way) and on the card (every layout adds the same 64-bit
    fixed-point integers at the same exponent).

    Args:
      batches: iterator of `x`, `(x, y)` or `(x, y, group_ids)` chunks
        (validated like `DeviceDMatrix.from_batches`; incoming chunk sizes
        are arbitrary — rows are re-chunked to `chunk_rows`).
      chunk_rows: rows per stored chunk.
      max_bins: total bins per feature incl. the reserved missing bin.
      ref: reuse another matrix's cut points, max_bins and device
        (evaluation sets; overrides `cuts`).
      cuts: "sketch" (default — a StreamingQuantileSketch over the chunks,
        each chunk's columns sorted on the device), "exact" (the whole
        float matrix gathered once for `compute_cuts`: the cuts of the
        in-memory matrix), or a precomputed (n_features, max_bins - 2) array.
      sketch_capacity: per-feature summary size for cuts="sketch".
      sketch_shards: with cuts="sketch", one sketch a shard (chunk i to
        shard i % k, at most one shard a chunk), combined by the log-depth
        tree merge (`dist.sketch.tree_merge`); 1 = one sequential sketch.
      verify_chunks: crc32 policy for page-in. True or "once" (default):
        each chunk is verified the first time it is paged in and again
        after any load retry; "always": on every page-in; False or "never":
        not at all. A mismatch raises ChunkIntegrityError naming the chunk.
      load_retries / load_backoff: page-in failures (I/O errors, integrity
        failures) are retried this many times with exponential backoff.
      paging: "resident" (the stack paged onto the device once), "stream"
        (the stack stays on the host; a fit pages it one chunk at a time,
        about 13 passes over it a depth-6 round, with at most
        prefetch_chunks + 1 chunks on the device), or "auto" (default),
        which is "stream" when the stack would take more than half the
        card's memory and "resident" otherwise.
      prefetch_chunks: chunks the pager issues ahead of the one in use when
        chunks are paged one at a time (a streamed fit, and
        `iter_device_chunks` on a matrix that is not resident): on a card
        their copies run while the kernels on the current chunk do; 0
        loads each chunk when it is asked for.
      device: "cuda" (the default, None) or "cpu"; with `ref`, ref's.
    """

    def __init__(
        self,
        batches,
        *,
        chunk_rows: int = 131072,
        max_bins: int = Q.DEFAULT_MAX_BINS,
        ref=None,
        cuts="sketch",
        sketch_capacity: int = 1024,
        sketch_shards: int = 1,
        verify_chunks: bool | str = True,
        load_retries: int = 2,
        load_backoff: float = 0.05,
        paging: str = "auto",
        prefetch_chunks: int = 2,
        device=None,
    ):
        if chunk_rows <= 0:
            raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
        _check_paging(paging, prefetch_chunks)
        if ref is not None and device is None:
            device = ref.device
        dev = resolve_device(device)
        if ref is not None and dev != ref.device:
            raise ValueError(f"ref lives on {ref.device}, not on {dev}")
        xs, label, groups, n_features = _collect_batches(batches)
        n_rows = sum(c.shape[0] for c in xs)
        xs = _rechunk(xs, chunk_rows)

        if ref is not None:
            if n_features != ref.n_features:
                raise ValueError(
                    f"ref has {ref.n_features} features, batches have "
                    f"{n_features}"
                )
            cut_arr = ref.cuts
            max_bins = ref.max_bins
        elif isinstance(cuts, str):
            if cuts == "exact":
                cut_arr = Q.compute_cuts(as_tensor(np.concatenate(xs), dev), max_bins)
            elif cuts == "sketch":
                if sketch_shards < 1:
                    raise ValueError(
                        f"sketch_shards must be >= 1, got {sketch_shards}"
                    )
                shards = min(sketch_shards, len(xs))
                if shards > 1:
                    # One sketch a shard of chunks (chunk i to shard i % k),
                    # combined by the log-depth tree merge (dist.sketch).
                    from repro_torch.dist.sketch import tree_merge

                    sketches = []
                    for s in range(shards):
                        sk = Q.StreamingQuantileSketch(n_features, max_bins,
                                                       capacity=sketch_capacity)
                        for chunk in xs[s::shards]:
                            _push_chunk_sorted(sk, chunk, dev)
                        sketches.append(sk)
                    sketch = tree_merge(sketches)
                else:
                    sketch = Q.StreamingQuantileSketch(n_features, max_bins,
                                                       capacity=sketch_capacity)
                    for chunk in xs:
                        _push_chunk_sorted(sketch, chunk, dev)
                cut_arr = sketch.get_cuts(dev)
            else:
                raise ValueError(
                    f"cuts must be 'sketch', 'exact' or an array, got {cuts!r}"
                )
        else:
            cut_arr = as_tensor(cuts, dev)
            nvb = Q.n_value_bins(max_bins)
            if tuple(cut_arr.shape) != (n_features, nvb - 1):
                raise ValueError(
                    f"cuts must have shape ({n_features}, {nvb - 1}), "
                    f"got {tuple(cut_arr.shape)}"
                )

        # Quantise + pack chunk by chunk on the device: the dense transients
        # (float chunk, int32 bin chunk) are bounded by chunk_rows. The bit
        # width is fixed from max_bins, so every chunk packs alike without a
        # second pass over the data.
        bits = C.bits_needed(max_bins - 1)
        chunks = (Q.quantize(as_tensor(chunk, dev), cut_arr) for chunk in xs)
        self._init_stack(chunks, n_rows, n_features, bits, chunk_rows)
        self._finish(cut_arr, max_bins, label, groups, dev, verify_chunks,
                     load_retries, load_backoff, paging, prefetch_chunks)

    def _init_stack(self, bin_chunks, n_rows: int, n_features: int, bits: int,
                    chunk_rows: int) -> None:
        """Pack each (rows, n_features) bin chunk (on any device) into the
        host stack; record the crc32s."""
        spw = C.symbols_per_word(bits)
        words_per_chunk = -(-chunk_rows // spw)
        n_chunks = -(-n_rows // chunk_rows)
        host = np.zeros((n_chunks, n_features, words_per_chunk), np.uint32)
        for i, bins in enumerate(bin_chunks):
            packed = C.pack(bins, bits).cpu().numpy().view(np.uint32)
            host[i, :, : packed.shape[1]] = packed
        self._host_packed = host
        self._device_stack: torch.Tensor | None = None
        self.bits = bits
        self.chunk_rows = chunk_rows
        self.n_rows = n_rows
        self._chunk_crcs = RES.crc32_chunks(host)
        self._verified = np.zeros(n_chunks, np.bool_)

    def _finish(self, cuts, max_bins, label, group_ids, dev, verify_chunks,
                load_retries, load_backoff, paging, prefetch_chunks) -> None:
        self.device = dev
        self.cuts = cuts
        self.max_bins = max_bins
        self.label = None if label is None else as_tensor(label, dev).reshape(-1)
        self.group_ids = (None if group_ids is None
                          else as_tensor(group_ids, dev, torch.int32).reshape(-1))
        for name, v in (("label", self.label), ("group_ids", self.group_ids)):
            if v is not None and v.shape[0] != self.n_rows:
                raise ValueError(f"{name} has {v.shape[0]} rows, the matrix {self.n_rows}")
        self.verify_chunks = _normalize_verify(verify_chunks)
        self.load_retries = load_retries
        self.load_backoff = load_backoff
        self.paging = paging
        self.prefetch_chunks = prefetch_chunks
        self.stream_stats = None  # the last streamed fit's bins (core/stream.py)

    @classmethod
    def from_dmatrix(cls, dmat: "DeviceDMatrix", *, chunk_rows: int,
                     **kw) -> "ExternalDMatrix":
        """Convert an in-memory DeviceDMatrix to external memory — the
        `fit(on_oom="external")` degradation path. Bins are recovered from
        the packed words one chunk of rows at a time, on the host (this
        runs right after a device OOM: the whole matrix is never unpacked
        on the device), and re-packed at the stack's width; cuts, labels
        and groups are shared, so training on the result is the in-memory
        fit (bit for bit on the CPU)."""
        if chunk_rows <= 0:
            raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
        words = dmat.matrix.packed.cpu()
        spw = C.symbols_per_word(dmat.bits)

        def chunks():
            for s in range(0, dmat.n_rows, chunk_rows):
                rows = min(chunk_rows, dmat.n_rows - s)
                w0, w1 = s // spw, -(-(s + rows) // spw)
                bins = C.unpack(words[:, w0:w1], dmat.bits, (w1 - w0) * spw)
                yield bins[s - w0 * spw: s - w0 * spw + rows]

        return cls._from_host_bins(chunks(), dmat.n_rows, dmat.n_features, dmat.cuts,
                                   dmat.max_bins, dmat.label, dmat.group_ids,
                                   chunk_rows, device=dmat.device, **kw)

    @classmethod
    def _from_host_bins(cls, bin_chunks, n_rows, n_features, cuts, max_bins, label,
                        group_ids, chunk_rows, *, device=None,
                        verify_chunks: bool | str = True, load_retries: int = 2,
                        load_backoff: float = 0.05, paging: str = "auto",
                        prefetch_chunks: int = 2):
        """Build from already-quantised host bin chunks of chunk_rows rows
        (from_dmatrix / rechunk): the float->bins pipeline is skipped,
        everything downstream of quantisation is __init__'s."""
        if chunk_rows <= 0:
            raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
        _check_paging(paging, prefetch_chunks)
        self = cls.__new__(cls)
        self._init_stack(bin_chunks, n_rows, n_features, C.bits_needed(max_bins - 1),
                         chunk_rows)
        self._finish(cuts, max_bins, label, group_ids, resolve_device(device),
                     verify_chunks, load_retries, load_backoff, paging,
                     prefetch_chunks)
        return self

    def rechunk(self, chunk_rows: int) -> "ExternalDMatrix":
        """A new ExternalDMatrix over the same data with a different chunk
        size (the OOM path halves chunk_rows until the fit fits). Chunks
        are decoded on the host and re-packed; cuts, labels and groups are
        shared."""
        bins = self._decode_host_bins()
        return type(self)._from_host_bins(
            (bins[s: s + chunk_rows] for s in range(0, self.n_rows, chunk_rows)),
            self.n_rows, self.n_features, self.cuts, self.max_bins, self.label,
            self.group_ids, chunk_rows, device=self.device,
            verify_chunks=self.verify_chunks, load_retries=self.load_retries,
            load_backoff=self.load_backoff, paging=self.paging,
            prefetch_chunks=self.prefetch_chunks,
        )

    def _decode_host_bins(self) -> torch.Tensor:
        """The dense (n_rows, n_features) int32 bins, on the host (transient:
        only rechunk and tests materialise it)."""
        return C.unpack_chunked(torch.from_numpy(self._host_packed.view(np.int32)),
                                self.bits, self.chunk_rows, self.n_rows)

    @classmethod
    def from_arrays(
        cls, x, label=None, *, group_ids=None, chunk_rows: int = 131072, **kw
    ) -> "ExternalDMatrix":
        """Artificially chunk an in-memory array (tests, benchmarks, the
        estimators' `chunk_rows=`, and the parity check against
        `DeviceDMatrix`)."""
        x = np.asarray(x, np.float32)

        def batches():
            for s in range(0, x.shape[0], chunk_rows):
                xb = x[s: s + chunk_rows]
                yb = None if label is None else np.asarray(label)[s: s + chunk_rows]
                gb = None if group_ids is None else np.asarray(group_ids)[s: s + chunk_rows]
                if gb is not None:
                    yield xb, yb, gb
                elif yb is not None:
                    yield xb, yb
                else:
                    yield xb
        return cls(batches(), chunk_rows=chunk_rows, **kw)

    # --- surface -----------------------------------------------------------
    @property
    def n_chunks(self) -> int:
        return self._host_packed.shape[0]

    @property
    def n_features(self) -> int:
        return self._host_packed.shape[1]

    @property
    def nbytes_host(self) -> int:
        """Host bytes held by the packed chunk stack."""
        return self._host_packed.nbytes

    @property
    def nbytes_device(self) -> int:
        """Device bytes the paged-in stack holds (0 when paged out)."""
        if self._device_stack is None:
            return 0
        return self._device_stack.numel() * 4

    def resolved_paging(self) -> str:
        """The effective paging mode: "resident" or "stream".

        "auto" is "stream" when the device is a card and the stack would
        take more than half its memory (`torch.cuda.mem_get_info`'s total),
        leaving room for gradients, histograms and transients, as the
        reference resolves it from its device's memory limit; "resident"
        otherwise, the CPU always."""
        if self.paging != "auto":
            return self.paging
        if self.device.type == "cuda":
            total = torch.cuda.mem_get_info(self.device)[1]
            if self.nbytes_host > 0.5 * total:
                return "stream"
        return "resident"

    def packed_bins(self) -> C.ChunkedPackedBins:
        """Page the compressed chunk stack onto the device (cached) as the
        representation the resident rounds read, whatever `paging` says (a
        streamed fit never calls it). Page-in verifies per-chunk crc32s and
        retries transient failures."""
        if self._device_stack is None:
            self._device_stack = self._page_in()
        return C.ChunkedPackedBins(
            packed=self._device_stack,
            bits=self.bits,
            chunk_rows=self.chunk_rows,
            n_rows=self.n_rows,
        )

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        """A host word array as int32 bit patterns on the device: a copy,
        never a view of the host stack, on the CPU too."""
        return torch.from_numpy(host.view(np.int32)).to(self.device, copy=True)

    def _page_in(self) -> torch.Tensor:
        """Host -> device copy with integrity verification and
        retry/backoff. The chunk_load / chunk_corrupt fault sites live here.
        Verification follows verify_chunks: "once" verifies only stacks with
        unverified chunks (first page-in, or after a retry cleared the
        flags), "always" every page-in, "never" none."""

        def attempt():
            FA.check("chunk_load")
            stack = FA.corrupt_array("chunk_corrupt", self._host_packed)
            if self.verify_chunks == "always" or (
                self.verify_chunks == "once" and not self._verified.all()
            ):
                RES.verify_chunk_crcs(
                    stack, self._chunk_crcs,
                    context=f"ExternalDMatrix({self.n_rows}x{self.n_features})",
                )
                self._verified[:] = True
            return self._to_device(stack)

        def note(n, exc):
            self._verified[:] = False
            warnings.warn(
                f"chunk page-in failed ({exc}); "
                f"retry {n + 1}/{self.load_retries}"
            )

        return RES.with_retries(
            attempt, retries=self.load_retries, backoff=self.load_backoff,
            retry_on=(OSError, RES.ChunkIntegrityError), on_retry=note,
        )

    def _host_chunk(self, i: int) -> np.ndarray:
        """Chunk i's host words, checked: the per-chunk analogue of
        `_page_in`'s host work, with the same fault sites, verify policy and
        retry/backoff. A retry clears the chunk's verified flag so the
        re-attempt re-checks the crc even under the "once" policy."""

        def attempt():
            FA.check("chunk_load")
            chunk = FA.corrupt_array("chunk_corrupt", self._host_packed[i])
            if self.verify_chunks == "always" or (
                self.verify_chunks == "once" and not self._verified[i]
            ):
                RES.verify_chunk_crcs(
                    chunk[None], self._chunk_crcs[i: i + 1],
                    context=f"ExternalDMatrix chunk {i}",
                )
                self._verified[i] = True
            return chunk

        def note(n, exc):
            self._verified[i] = False
            warnings.warn(
                f"chunk {i} page-in failed ({exc}); "
                f"retry {n + 1}/{self.load_retries}"
            )

        return RES.with_retries(
            attempt, retries=self.load_retries, backoff=self.load_backoff,
            retry_on=(OSError, RES.ChunkIntegrityError), on_retry=note,
        )

    def _load_chunk(self, i: int) -> torch.Tensor:
        """Page ONE chunk host -> device, a tensor of its own (`_host_chunk`
        then a copy)."""
        return self._to_device(self._host_chunk(i))

    def chunk_pager(self, indices=None, prefetch: int | None = None) -> ChunkPager:
        """A `ChunkPager` over `indices` (default: every chunk in order).

        When the stack is already on the device the pager serves its slices
        (they were verified when paged in). Otherwise the pager issues up to
        `prefetch` chunks (default `self.prefetch_chunks`) ahead of the
        consumer: on a card through its ring of pinned and device slots on
        a copy stream (a chunk handed out is a slot, valid until the next is
        asked for), on the CPU as fresh tensors. Iterate `(index, chunk)`
        pairs."""
        if indices is None:
            indices = range(self.n_chunks)
        if self._device_stack is not None:
            stack = self._device_stack
            return ChunkPager(lambda i: stack[i], indices, 0)
        if prefetch is None:
            prefetch = self.prefetch_chunks
        if self.device.type == "cuda":
            return ChunkPager(self._host_chunk, indices, prefetch, device=self.device,
                              slot_shape=self._host_packed.shape[1:])
        return ChunkPager(self._load_chunk, indices, prefetch)

    def iter_device_chunks(self):
        """Yield each packed chunk as a device tensor, ONE at a time (the
        predict path): unless the stack is already resident, the full stack
        is never on the device, and `nbytes_device` stays 0. On a card a
        chunk is the pager's slot: valid until the next is asked for."""
        for _, chunk in self.chunk_pager():
            yield chunk

    def unload(self) -> None:
        """Drop the device copy of the chunk stack (page out). The host
        stack is retained; the next `packed_bins()` pages back in."""
        self._device_stack = None

    def same_cuts(self, other) -> bool:
        return cuts_equal(self.cuts, getattr(other, "cuts", None))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"ExternalDMatrix({self.n_rows}x{self.n_features}, "
            f"{self.n_chunks} chunks of {self.chunk_rows} rows, "
            f"{self.bits}-bit, {self.nbytes_host / 1e6:.2f} MB host, {self.device}"
            f"{', labelled' if self.label is not None else ''})"
        )


def _check_paging(paging: str, prefetch_chunks: int) -> None:
    if paging not in ("auto", "resident", "stream"):
        raise ValueError(
            f"paging must be 'auto', 'resident' or 'stream', got {paging!r}"
        )
    if prefetch_chunks < 0:
        raise ValueError(f"prefetch_chunks must be >= 0, got {prefetch_chunks}")


def _rechunk(xs: list, chunk_rows: int) -> list:
    """Re-slice a list of arbitrary-sized row chunks into uniform
    chunk_rows pieces (the last may be short) without building the full
    matrix: peak extra memory is one output chunk."""
    out, buf, buffered = [], [], 0
    for chunk in xs:
        buf.append(chunk)
        buffered += chunk.shape[0]
        while buffered >= chunk_rows:
            take, need = [], chunk_rows
            while need > 0:
                head = buf[0]
                if head.shape[0] <= need:
                    take.append(head)
                    need -= head.shape[0]
                    buf.pop(0)
                else:
                    take.append(head[:need])
                    buf[0] = head[need:]
                    need = 0
            out.append(take[0] if len(take) == 1 else np.concatenate(take))
            buffered -= chunk_rows
    if buffered:
        out.append(buf[0] if len(buf) == 1 else np.concatenate(buf))
    return out
