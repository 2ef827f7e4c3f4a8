"""Time the parts of the two private histogram kernels' design against a
parent tree's kernels, in one process on one card.

Run from the root of a checkout on a machine with an NVIDIA card:

    git archive <parent> | tar -x -C build/parent
    python3 tools/kernel_parts.py --parent build/parent [--rows N]

The parent's `kernels/csrc/histogram.cu` is built into its own library
(its C entry points take the exponent pointer, the plan's blocks per SM
and no cluster); its launch plan is read from its own
`kernels/histogram.py`. On the Higgs-shaped training words and on a copy
with 80% of the symbols in the missing bin, #1 at 1, 8 and 32 nodes and the
row-id kernel at 1, 4 and 16 parents (level positions and compacted
buffers as `chip_smoke.py` makes them), each of these calls, as its
wrapper makes it (the exponent, the zeroed int64 accumulator, the kernel,
the conversion pass), is first checked `torch.equal` to the fixed-point
plain version and then timed by events (L2 flushed before each of 20
launches) and back to back (100 launches queued behind a sleeping kernel),
in turns (every variant, then every variant in reverse):

* `parent`: the parent's kernel under the parent's plan, its exponent by
  `fixed.exponent` (about seven torch launches) and `torch.zeros`;
* `parent_one_launch_exponent`: the same kernel after this tree's exponent
  kernel, which zeroes the accumulator too (the one-launch exponent alone);
* `block_totals`: the design kept in `tools/kernel_parts.cu` without a
  cluster: the missing bin skipped, each block summing its whole stripe's
  node totals (as much as one more feature a row) and adding their
  difference into its own features' missing bins;
* `tree`: this tree's wrapper: the missing bin skipped, the stripe's node
  totals split between its feature groups;
* `other_registers` (the row-id kernel): this tree's kernel under its plan
  from a copy of `csrc/histogram.cu` with the other register cap, 64
  (`__launch_bounds__(512, 2)`) in place of 40;
* `histogram_cluster_2`, `_4`, `_8`: `tools/kernel_parts.cu` with one
  private histogram spread over a thread-block cluster of that many blocks
  (one node tile, more features a block, adds to a neighbour's nodes
  through distributed shared memory); only the sizes up to the level's
  nodes.

Both designs of `kernel_parts.cu` run under `cluster_plan`, at two
512-thread blocks an SM (`PARTS_BLOCKS_PER_SM`).

Then the exponent alone on the main (g, h): `fixed.exponent` and
`torch.zeros` of the root's accumulator against the exponent kernel. Prints
one JSON line per measurement, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
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
from repro_torch.kernels import fixed as FX  # noqa: E402
from repro_torch.kernels.histogram import (  # noqa: E402
    MIN_BLOCKS_PER_SM,
    THREADS,
    build_histograms_packed_kernel,
    build_histograms_rows_kernel,
    dequantise_kernel,
    fixed_exponent,
    launch_plan,
    private_plan,
)

MAX_BINS = 256
NODES = (1, 8, 32)
PARENTS = (1, 4, 16)
SKEW = 0.8
PARTS_BLOCKS_PER_SM = 2  # kernel_parts.cu's #1 designs: two 512-thread blocks an SM
P, I = ctypes.c_void_p, ctypes.c_int


def shared_library(sources: list[Path], name: str) -> ctypes.CDLL:
    out = ROOT / "build" / "kernel_parts"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"{name}.so"
    done = subprocess.run([KB._nvcc(), *KB.NVCC_FLAGS, "-shared", "-o", str(lib),
                           *map(str, sources)], capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(lib))


def cluster_plan(n_items: int, f: int, n_nodes: int, limits, blocks_per_sm: int,
                 cluster: int) -> tuple[int, int, int, int, int]:
    """(node_tile, feat_group, items_per_block, blocks_per_sm, cluster) of
    `kernel_parts.cu`'s design: a block holds every cluster-th node of the
    tile, max_bins - 1 bins a feature and node, its rows' totals at every
    node of the tile and the cluster's at its own nodes."""
    def nbytes(fg, tile):
        per = -(-tile // cluster)
        return (fg * per * (MAX_BINS - 1) + tile + per) * 16
    cap = min(limits.smem_block, limits.smem_sm // blocks_per_sm - limits.smem_reserved)
    tiles = 1
    while nbytes(1, -(-n_nodes // tiles)) > cap:
        tiles += 1
    tile = -(-n_nodes // tiles)
    most = 1
    while most < f and nbytes(most + 1, tile) <= cap:
        most += 1
    groups = -(-f // most)
    fg = -(-f // groups)
    per_sm = min(limits.smem_sm // (nbytes(fg, tile) + limits.smem_reserved),
                 limits.threads_sm // THREADS)
    rows = max(1, min(-(-n_items // 1024), -(-per_sm * limits.n_sm // (groups * tiles))))
    rows = -(-rows // cluster) * cluster
    return tile, fg, -(-n_items // rows), per_sm, cluster


def parent_plan_module(parent: Path):
    """The parent's `kernels/histogram.py` under its own name, for its
    `launch_plan` (a function of its arguments alone)."""
    spec = importlib.util.spec_from_file_location(
        "parent_histogram", parent / "src" / "repro_torch" / "kernels" / "histogram.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_parts needs an NVIDIA card")

    parent = shared_library(
        [args.parent / "src" / "repro_torch" / "kernels" / "csrc" / "histogram.cu"], "parent")
    parent.rt_histogram_private.argtypes = [P] * 5 + [I] * 13 + [P]
    parent.rt_histogram_rows.argtypes = [P] * 6 + [I] * 12 + [P]
    parent.rt_histogram_dequantise.argtypes = [P] * 3 + [ctypes.c_longlong, I, P]
    old = parent_plan_module(args.parent)
    spread = shared_library([ROOT / "tools" / "kernel_parts.cu"], "histogram_cluster")
    spread.parts_histogram_private.argtypes = [P] * 5 + [I] * 14 + [P]
    spread.parts_histogram_rows.argtypes = [P] * 6 + [I] * 13 + [P]
    source = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "histogram.cu").read_text()
    swaps = (("__launch_bounds__(512, 3) histogram_rows_kernel",
              "__launch_bounds__(512, 2) histogram_rows_kernel"),)
    for old_text, new_text in swaps:
        if old_text not in source:
            raise SystemExit(f"csrc/histogram.cu no longer has {old_text!r}")
        source = source.replace(old_text, new_text)
    copy = ROOT / "build" / "kernel_parts" / "other_registers.cu"
    copy.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(source)
    other = shared_library([copy], "other_registers")
    other.rt_histogram_rows.argtypes = [P] * 6 + [I] * 12 + [P]
    lib = KB.lib()

    dev = torch.device("cuda", 0)
    stream = KB.stream(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x, y, _ = make_dataset("higgs", args.rows, seed=args.seed)
    dm = DeviceDMatrix(x, label=y, max_bins=MAX_BINS)
    del x, y
    packed, bits, n = dm.matrix.packed, dm.bits, dm.n_rows
    f, w = packed.shape
    dense = unpack(packed, bits, n)
    words = {"higgs": packed,
             "skewed": pack(torch.where(torch.rand(dense.shape, device=dev, generator=gen) < SKEW,
                                        MAX_BINS - 1, dense), bits)}
    del dense
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

    def parent_dequantise(acc, k):
        out = torch.empty(acc.shape, dtype=torch.float32, device=dev)
        KB.check(parent.rt_histogram_dequantise(acc.data_ptr(), k.data_ptr(), out.data_ptr(),
                                                acc.numel(), 256, stream), "parent dequantise")
        return out

    def accumulator(gh_, nn, one_launch):
        """(zeroed int64 accumulator, exponent) as the parent's wrapper or
        this tree's makes them."""
        if one_launch:
            acc = torch.empty((nn, f, MAX_BINS, 2), dtype=torch.int64, device=dev)
            return acc, fixed_exponent(gh_, zero=acc)
        return (torch.zeros((nn, f, MAX_BINS, 2), dtype=torch.int64, device=dev),
                FX.exponent(gh_))

    def private_call(kind, words_, pos, nn):
        """#1 through what its wrapper launches, under variant `kind`."""
        if kind == "tree":
            return lambda: build_histograms_packed_kernel(words_, gh, pos, nn, MAX_BINS, bits)
        if kind.startswith("parent"):
            plan = old.launch_plan(w, f, nn, MAX_BINS, limits, old.PRIVATE_BLOCKS_PER_SM,
                                   old.BIN_BYTES)

            def run():
                acc, k = accumulator(gh, nn, kind != "parent")
                KB.check(parent.rt_histogram_private(
                    words_.data_ptr(), gh.data_ptr(), pos.data_ptr(), acc.data_ptr(),
                    k.data_ptr(), n, f, w, nn, MAX_BINS, bits, plan.node_tile,
                    plan.feat_group, plan.words_per_block, plan.blocks_per_sm, THREADS, 0, 0,
                    stream), kind)
                return parent_dequantise(acc, k)
            return run
        shape = cluster_plan(w, f, nn, limits, PARTS_BLOCKS_PER_SM,
                             1 if kind == "block_totals" else int(kind.rsplit("_", 1)[1]))
        fn = spread.parts_histogram_private

        def run():
            acc, k = accumulator(gh, nn, True)
            KB.check(fn(words_.data_ptr(), gh.data_ptr(), pos.data_ptr(), acc.data_ptr(),
                        k.data_ptr(), n, f, w, nn, MAX_BINS, bits, *shape, THREADS, 0, 0,
                        stream), kind)
            return dequantise_kernel(acc, k)
        return run

    def rows_call(kind, words_, gh_sel, pos, rid, npar):
        """The row-id kernel through what its wrapper launches."""
        m = rid.shape[0]
        if kind == "tree":
            return lambda: build_histograms_rows_kernel(words_, gh_sel, pos, rid, npar,
                                                        MAX_BINS, bits)
        if kind == "other_registers":
            plan = launch_plan(m, f, npar, MAX_BINS, limits)

            def run_other():
                acc, k = accumulator(gh_sel, npar, True)
                KB.check(other.rt_histogram_rows(
                    words_.data_ptr(), gh_sel.data_ptr(), pos.data_ptr(), rid.data_ptr(),
                    acc.data_ptr(), k.data_ptr(), m, f, w, npar, MAX_BINS, bits,
                    plan.node_tile, plan.feat_group, plan.words_per_block, THREADS, 0, 0,
                    stream), kind)
                return dequantise_kernel(acc, k)
            return run_other
        if kind.startswith("parent"):
            plan = old.launch_plan(m, f, npar, MAX_BINS, limits, bin_bytes=old.BIN_BYTES)

            def run():
                acc, k = accumulator(gh_sel, npar, kind != "parent")
                KB.check(parent.rt_histogram_rows(
                    words_.data_ptr(), gh_sel.data_ptr(), pos.data_ptr(), rid.data_ptr(),
                    acc.data_ptr(), k.data_ptr(), m, f, w, npar, MAX_BINS, bits,
                    plan.node_tile, plan.feat_group, plan.words_per_block, THREADS, 0, 0,
                    stream), kind)
                return parent_dequantise(acc, k)
            return run
        shape = cluster_plan(m, f, npar, limits, MIN_BLOCKS_PER_SM,
                             1 if kind == "block_totals" else int(kind.rsplit("_", 1)[1]))
        shape = (*shape[:3], shape[4])
        fn = spread.parts_histogram_rows

        def run():
            acc, k = accumulator(gh_sel, npar, True)
            KB.check(fn(words_.data_ptr(), gh_sel.data_ptr(), pos.data_ptr(), rid.data_ptr(),
                        acc.data_ptr(), k.data_ptr(), m, f, w, npar, MAX_BINS, bits, *shape,
                        THREADS, 0, 0, stream), kind)
            return dequantise_kernel(acc, k)
        return run

    def measure(label: dict, calls: dict, want: torch.Tensor, plans: dict) -> None:
        for kind, call in calls.items():
            got = call()
            torch.cuda.synchronize()  # a fault shows at its own variant
            if not torch.equal(got, want):
                raise SystemExit(f"{kind} is not the fixed-point plain version's bits: {label}")
        ev = {k: [] for k in calls}
        b2b = {k: [] for k in calls}
        for kind in list(calls) + list(calls)[::-1]:
            ev[kind] += events_ms(calls[kind])
            b2b[kind].append(back_to_back_ms(calls[kind]))
        print(json.dumps({**label, "plans": plans,
                          "events_ms": {k: statistics.mean(v) for k, v in ev.items()},
                          "back_to_back_ms": {k: statistics.mean(v) for k, v in b2b.items()}}),
              flush=True)

    print(json.dumps({"device": torch.cuda.get_device_name(0), "rows": n, "features": f,
                      "bits": bits}), flush=True)
    for data, wd in words.items():
        for nn in NODES:
            pos = torch.randint(0, nn + 1, (n,), device=dev, generator=gen, dtype=torch.int32)
            pos = torch.where(torch.rand(n, device=dev, generator=gen) < 0.05, -1, pos)
            pos = pos.to(torch.int32).contiguous()
            kinds = ["parent", "parent_one_launch_exponent", "block_totals", "tree",
                     *(f"histogram_cluster_{c}" for c in (2, 4, 8) if c <= nn)]
            plans = {"parent": list(old.launch_plan(w, f, nn, MAX_BINS, limits,
                                                    old.PRIVATE_BLOCKS_PER_SM, old.BIN_BYTES)),
                     "block_totals": list(cluster_plan(w, f, nn, limits,
                                                       PARTS_BLOCKS_PER_SM, 1)),
                     "tree": list(private_plan(w, f, nn, MAX_BINS, bits, limits)),
                     **{f"histogram_cluster_{c}": list(cluster_plan(
                         w, f, nn, limits, PARTS_BLOCKS_PER_SM, c))
                        for c in (2, 4, 8) if c <= nn}}
            measure({"kernel": "histogram_private", "data": data, "n_nodes": nn},
                    {k: private_call(k, wd, pos, nn) for k in kinds},
                    ref.histogram_fixed_ref(wd, gh, pos, nn, MAX_BINS, bits), plans)
        for npar in PARENTS:
            m = n // 2
            rid = torch.nonzero(torch.rand(n, device=dev, generator=gen) < 0.45)[:m, 0]
            k_ = rid.shape[0]
            rid = torch.cat([rid, torch.full((m - k_,), n, device=dev, dtype=rid.dtype)])
            pos = torch.randint(0, npar, (m,), device=dev, generator=gen, dtype=torch.int32)
            dump = torch.rand(m, device=dev, generator=gen) < 0.05
            pos = torch.where(dump | (torch.arange(m, device=dev) >= k_), npar, pos)
            rid, pos = rid.to(torch.int32).contiguous(), pos.to(torch.int32).contiguous()
            gh_sel = gh[rid.to(torch.int64).clamp(max=n - 1)].contiguous()
            kinds = ["parent", "parent_one_launch_exponent", "block_totals", "tree",
                     "other_registers",
                     *(f"histogram_cluster_{c}" for c in (2, 4, 8) if c <= npar)]
            plans = {"parent": list(old.launch_plan(m, f, npar, MAX_BINS, limits,
                                                    bin_bytes=old.BIN_BYTES)),
                     "block_totals": list(cluster_plan(m, f, npar, limits,
                                                       MIN_BLOCKS_PER_SM, 1)),
                     "tree": list(launch_plan(m, f, npar, MAX_BINS, limits)),
                     **{f"histogram_cluster_{c}": list(cluster_plan(
                         m, f, npar, limits, MIN_BLOCKS_PER_SM, c))
                        for c in (2, 4, 8) if c <= npar}}
            measure({"kernel": "histogram_rows", "data": data, "n_parents": npar},
                    {k: rows_call(k, wd, gh_sel, pos, rid, npar) for k in kinds},
                    ref.histogram_rows_fixed_ref(wd, gh_sel, pos, rid, npar, MAX_BINS, bits),
                    plans)

    root = torch.empty((1, f, MAX_BINS, 2), dtype=torch.int64, device=dev)
    calls = {"fixed_exponent_and_zeros": lambda: (FX.exponent(gh), root.zero_()),
             "exponent_kernel": lambda: fixed_exponent(gh, zero=root)}
    print(json.dumps({"exponent": [n, 2],
                      "events_ms": {k: statistics.mean(events_ms(v)) for k, v in calls.items()},
                      "back_to_back_ms": {k: back_to_back_ms(v) for k, v in calls.items()}}),
          flush=True)
    print(json.dumps({"nvidia_smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
