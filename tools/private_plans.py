"""Time #1 (`histogram_private_kernel`) under every node tile of a level,
beside one `scatter_add_` of the same rows, in one process on one card.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 tools/private_plans.py [--rows N] [--nodes 1 8 32]

On the Higgs-shaped training words and on a copy with 80% of the symbols
in the missing bin (as `chip_smoke.py` makes both), at each level's node
count: for each node tile t, the most features a block holds at t beside
the block's share of the node totals (split evenly over the groups), with
512-thread blocks at two and at one an SM, and with 1024-thread blocks at
one an SM, whose stripes make 1, 2 or 4 waves of resident blocks (the
other stripes as `kernels/histogram.py::launch_plan` sizes them); and the
wrapper's own plan (`private_plan`). Each plan runs #1 through the
library's own entry point with what the wrapper adds (the exponent
kernel, which zeroes the accumulator, and the conversion pass), is first
checked `torch.equal` to the fixed-point plain version, and is then timed
by events (L2 flushed before each of 20 launches) and back to back (100
launches behind a sleeping kernel), in turns with the others and with
`scatter_add_` (every call, then every call in reverse). A plan's
`passes` is node tiles x feature groups: how often a row's node and
(g, h) are read; every feature's words are walked once a node tile.
Prints one JSON line per level and word set, and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core import DeviceDMatrix  # noqa: E402
from repro_torch.core.compress import pack, unpack  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.kernels import build as KB, ref  # noqa: E402
from repro_torch.kernels.histogram import (  # noqa: E402
    MIN_WORDS_PER_BLOCK,
    PRIVATE_THREADS,
    THREADS,
    dequantise_kernel,
    fixed_exponent,
    private_bytes,
    private_plan,
)

MAX_BINS = 256
SKEW = 0.8


def tile_plan(n_words: int, f: int, n_nodes: int, tile: int, limits,
              blocks_per_sm: int, threads: int = THREADS, waves: int = 1) -> dict | None:
    """The plan at node tile `tile` (None where one feature does not fit):
    node_tile, feat_group, words_per_block, smem_bytes, passes, threads;
    `waves` times the stripes of one wave of resident blocks."""
    cap = min(limits.smem_block, limits.smem_sm // blocks_per_sm - limits.smem_reserved)
    most = 0
    while most < f and private_bytes(most + 1, tile, MAX_BINS) <= cap:
        most += 1
    if most == 0:
        return None
    groups = math.ceil(f / most)
    fg = math.ceil(f / groups)
    tiles = math.ceil(n_nodes / tile)
    smem = private_bytes(fg, tile, MAX_BINS)
    per_sm = min(limits.smem_sm // (smem + limits.smem_reserved), limits.threads_sm // threads,
                 blocks_per_sm if threads > THREADS else limits.threads_sm)
    row_blocks = max(1, min(math.ceil(n_words / MIN_WORDS_PER_BLOCK),
                            math.ceil(waves * per_sm * limits.n_sm / (groups * tiles))))
    return {"node_tile": tile, "feat_group": fg, "words_per_block": math.ceil(n_words / row_blocks),
            "smem_bytes": smem, "blocks_per_sm": blocks_per_sm, "passes": tiles * groups,
            "threads": threads}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--nodes", type=int, nargs="+", default=[1, 8, 32])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("private_plans needs an NVIDIA card")

    dev = torch.device("cuda", 0)
    stream = KB.stream(dev)
    lib = KB.lib()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x, y, _ = make_dataset("higgs", args.rows, seed=args.seed)
    dm = DeviceDMatrix(x, label=y, max_bins=MAX_BINS)
    del x, y
    packed, bits, n = dm.matrix.packed, dm.bits, dm.n_rows
    f, w = packed.shape
    dense_higgs = unpack(packed, bits, n)
    skewed = torch.where(torch.rand(dense_higgs.shape, device=dev, generator=gen) < SKEW,
                         MAX_BINS - 1, dense_higgs)
    words = {"higgs": (packed, dense_higgs), "skewed": (pack(skewed, bits), skewed)}
    gh = torch.stack([torch.randn(n, device=dev, generator=gen),
                      torch.rand(n, device=dev, generator=gen)], 1).contiguous()
    flush = torch.empty(128 << 18, device=dev)
    limits = KB.device_limits(0)

    def events_ms(fn, iters=20) -> list[float]:
        fn()
        out = []
        for _ in range(iters):
            flush.zero_()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            out.append(s.elapsed_time(e))
        return out

    def back_to_back_ms(fn, launches=100) -> float:
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(launches):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / launches

    def private_call(words_, pos, nn, plan):
        def run():
            acc = torch.empty((nn, f, MAX_BINS, 2), dtype=torch.int64, device=dev)
            k = fixed_exponent(gh, zero=acc)
            KB.check(lib.rt_histogram_private(
                words_.data_ptr(), gh.data_ptr(), pos.data_ptr(), acc.data_ptr(), k.data_ptr(),
                n, f, w, nn, MAX_BINS, bits, plan["node_tile"], plan["feat_group"],
                plan["words_per_block"], plan["threads"], 0, 0, stream), "histogram_private")
            return dequantise_kernel(acc, k)
        return run

    def scatter_call(dense, pos, nn):
        p = pos.to(torch.int64)
        p = torch.where((p >= 0) & (p < nn), p, nn)
        idx = ((p[:, None] * f + torch.arange(f, device=dev)[None, :]) * MAX_BINS
               + dense.to(torch.int64)).reshape(-1, 1).expand(-1, 2)
        src = gh[:, None, :].expand(-1, f, 2).reshape(-1, 2)
        out = torch.zeros(((nn + 1) * f * MAX_BINS, 2), device=dev)
        return lambda: out.scatter_add_(0, idx, src)

    print(json.dumps({"device": torch.cuda.get_device_name(0), "rows": n, "features": f,
                      "bits": bits}), flush=True)
    for data, (words_, dense) in words.items():
        for nn in args.nodes:
            pos = torch.randint(0, nn + 1, (n,), device=dev, generator=gen, dtype=torch.int32)
            pos = torch.where(torch.rand(n, device=dev, generator=gen) < 0.05, -1, pos)
            pos = pos.to(torch.int32).contiguous()
            want = ref.histogram_fixed_ref(words_, gh, pos, nn, MAX_BINS, bits)
            plans = {}
            for tile in sorted({math.ceil(nn / t) for t in range(1, nn + 1)}, reverse=True):
                for per_sm in (2, 1):
                    plan = tile_plan(w, f, nn, tile, limits, per_sm)
                    key = plan and (plan["node_tile"], plan["feat_group"], plan["smem_bytes"])
                    if plan and key not in {(p["node_tile"], p["feat_group"], p["smem_bytes"])
                                            for p in plans.values()}:
                        plans[f"tile_{tile}_per_sm_{per_sm}"] = plan
                for waves in (1, 2, 4):
                    plan = tile_plan(w, f, nn, tile, limits, 1, PRIVATE_THREADS, waves)
                    if plan:
                        plans[f"tile_{tile}_wide_waves_{waves}"] = plan
            shipped = private_plan(w, f, nn, MAX_BINS, bits, limits)
            plans["shipped"] = {**shipped._asdict(), "passes": math.ceil(nn / shipped.node_tile)
                                * math.ceil(f / shipped.feat_group)}
            calls = {k: private_call(words_, pos, nn, p) for k, p in plans.items()}
            for name, call in calls.items():
                if not torch.equal(call(), want):
                    raise SystemExit(f"{name} is not the fixed-point plain version's bits "
                                     f"({data}, {nn} nodes)")
            calls["scatter_add_"] = scatter_call(dense, pos, nn)
            ev = {k: [] for k in calls}
            b2b = {k: [] for k in calls}
            for name in list(calls) + list(calls)[::-1]:
                ev[name] += events_ms(calls[name])
                b2b[name].append(back_to_back_ms(calls[name]))
            print(json.dumps({"data": data, "n_nodes": nn, "plans": plans,
                              "events_ms": {k: statistics.mean(v) for k, v in ev.items()},
                              "back_to_back_ms": {k: statistics.mean(v)
                                                  for k, v in b2b.items()}}), flush=True)
            del calls, want
    print(json.dumps({"nvidia_smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
