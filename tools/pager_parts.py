#!/usr/bin/env python3
"""The streamed pager's parts on one card, each timed on its own.

    python3 tools/pager_parts.py [--rows 1000000] [--chunk-rows 131072]

On a streamed ExternalDMatrix of Higgs-shaped rows (28 features, 256 bins,
made from --seed), prints one JSON line with, per chunk of `--chunk-rows`
rows:
  * host_memcpy_ms: a chunk's host words into a pinned buffer, by
    `torch.Tensor.copy_` and by `np.copyto` (host clock, median of 20);
  * h2d_pinned_ms / h2d_pageable_ms: the copy to the card from pinned
    memory (CUDA events, 50 back to back) and from the pageable host stack
    (synchronised host clock);
  * pager_ms: a pass of `ExternalDMatrix.chunk_pager` with no work on the
    chunks, at prefetch_chunks 0, 1 and 2 (host clock over 10 passes,
    synchronised at the end, per chunk);
  * histogram_pass_ms: the same passes with the streamed root histogram's
    work on each chunk (`histogram.histogram_chunk_update`, one launch of
    the privatised kernel), at prefetch 0 and 2, and that work alone on
    the chunks of a resident stack;
  * thread_ms: the same histogram pass through a variant of the pager in
    which a worker thread stages the chunks (the host work, the memcpy
    into the pinned slot, the copy on the copy stream) and hands them over
    a queue, as the reference's pager stages them, at depth 1 and 2;
  * pinned_stack_ms: the same pass with the whole host stack in pinned
    memory, each chunk copied straight from it (no staging memcpy), with
    the copies issued `depth` chunks ahead at depth 0 and 2.
Ends with the card's name and power limit. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import queue
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--chunk-rows", type=int, default=131_072)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import DeviceDMatrix, ExternalDMatrix
    from repro_torch.core import histogram as H
    from repro_torch.data import make_dataset

    dev = torch.device("cuda", 0)
    x, y, _ = make_dataset("higgs", args.rows, seed=args.seed)
    d = DeviceDMatrix(x[:100_000], label=y[:100_000])
    e = ExternalDMatrix.from_arrays(x, y, chunk_rows=args.chunk_rows, ref=d, paging="stream")
    del x
    host = e._host_packed
    n_chunks, f, wpc = host.shape
    chunk_bytes = f * wpc * 4
    out = {"rows": args.rows, "chunk_rows": args.chunk_rows, "n_chunks": n_chunks,
           "chunk_bytes": chunk_bytes}

    def host_ms(fn, reps=20) -> float:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    pinned = torch.empty((f, wpc), dtype=torch.int32, pin_memory=True)
    pinned_np = pinned.numpy()
    src = host[1].view(np.int32)
    out["host_memcpy_ms"] = {
        "torch_copy": host_ms(lambda: pinned.copy_(torch.from_numpy(src))),
        "np_copyto": host_ms(lambda: np.copyto(pinned_np, src))}
    slot = torch.empty((f, wpc), dtype=torch.int32, device=dev)
    for _ in range(5):
        slot.copy_(pinned, non_blocking=True)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(50):
        slot.copy_(pinned, non_blocking=True)
    b.record()
    torch.cuda.synchronize()
    out["h2d_pinned_ms"] = a.elapsed_time(b) / 50

    def pageable():
        slot.copy_(torch.from_numpy(src))
        torch.cuda.synchronize()
    out["h2d_pageable_ms"] = host_ms(pageable)

    n = e.n_rows
    gh = torch.randn((n, 2), device=dev)
    pos = torch.zeros(n, dtype=torch.int32, device=dev)

    def per_chunk_ms(run_pass, passes=10) -> float:
        run_pass()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(passes):
            run_pass()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / (passes * n_chunks)

    def hist_on(i, words, slab):
        s = i * e.chunk_rows
        t = min(s + e.chunk_rows, n)
        H.histogram_chunk_update(slab, words, gh[s:t], pos[s:t], 1, 256, e.bits)

    def pager_pass(prefetch, work):
        slab = H.new_slab(1, f, 256, dev)
        for i, words in e.chunk_pager(prefetch=prefetch):
            if work:
                hist_on(i, words, slab)

    out["pager_ms"] = {p: per_chunk_ms(lambda: pager_pass(p, False)) for p in (0, 1, 2)}
    out["histogram_pass_ms"] = {p: per_chunk_ms(lambda: pager_pass(p, True)) for p in (0, 2)}
    stack = torch.from_numpy(host.view(np.int32)).to(dev)

    def resident_pass():
        slab = H.new_slab(1, f, 256, dev)
        for i in range(n_chunks):
            hist_on(i, stack[i], slab)
    out["histogram_pass_ms"]["resident"] = per_chunk_ms(resident_pass)
    del stack

    copy_stream = torch.cuda.Stream(device=dev)
    cur = torch.cuda.current_stream(dev)

    def ring(slots, pinned_ring=True):
        return ([torch.empty((f, wpc), dtype=torch.int32, pin_memory=True)
                 for _ in range(slots)] if pinned_ring else None,
                [torch.empty((f, wpc), dtype=torch.int32, device=dev) for _ in range(slots)],
                [None] * slots, [None] * slots)

    def stage(j, k, pin, dslot, copied, released, source=None):
        """Chunk j into slot k on the copy stream; its copy event."""
        if source is None:
            if copied[k] is not None:
                copied[k].synchronize()
            pin[k].copy_(torch.from_numpy(e._host_chunk(j).view(np.int32)))
        with torch.cuda.stream(copy_stream):
            if released[k] is not None:
                copy_stream.wait_event(released[k])
            dslot[k].copy_(pin[k] if source is None else source[j], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(copy_stream)
        copied[k] = ev
        return ev

    def pinned_stack_pass(depth, source):
        slots = depth + 1
        _, dslot, copied, released = ring(slots, False)
        slab = H.new_slab(1, f, 256, dev)
        for j in range(min(slots, n_chunks)):
            stage(j, j % slots, None, dslot, copied, released, source)
        for i in range(n_chunks):
            k = i % slots
            cur.wait_event(copied[k])
            hist_on(i, dslot[k], slab)
            rel = torch.cuda.Event()
            rel.record(cur)
            released[k] = rel
            if i + slots < n_chunks:
                stage(i + slots, k, None, dslot, copied, released, source)
        cur.wait_stream(copy_stream)

    def thread_pass(depth):
        slots = depth + 1
        pin, dslot, copied, released = ring(slots)
        free, ready = queue.Queue(), queue.Queue()
        for k in range(slots):
            free.put(k)

        def worker():
            for j in range(n_chunks):
                k = free.get()
                ready.put((j, k, stage(j, k, pin, dslot, copied, released)))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        slab = H.new_slab(1, f, 256, dev)
        for _ in range(n_chunks):
            i, k, ev = ready.get()
            cur.wait_event(ev)
            hist_on(i, dslot[k], slab)
            rel = torch.cuda.Event()
            rel.record(cur)
            released[k] = rel
            free.put(k)
        t.join()
        cur.wait_stream(copy_stream)

    out["thread_ms"] = {p: per_chunk_ms(lambda: thread_pass(p)) for p in (1, 2)}
    pinned_stack = torch.from_numpy(host.view(np.int32)).pin_memory()
    out["pinned_stack_ms"] = {p: per_chunk_ms(lambda: pinned_stack_pass(p, pinned_stack))
                              for p in (0, 2)}
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
