"""Time the ensemble traversal and the cut selection beside an earlier
commit's kernels, in one process, and both under other designs.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 tools/traversal_parts.py --parent DIR [--rows N] [--seed S]

DIR is a checkout of an earlier commit whose `kernels/csrc/
ensemble_traversal.cu` exports `rt_ensemble_margins` over five arena arrays
(feature i32, threshold f32, default_left u8, leaf value f32, is_leaf u8)
and whose `quantile_cuts.cu` exports `rt_quantile_cuts` writing the
candidates before their sort. The earlier commit's own `kernels/build.py`
builds its library (into DIR/build), loaded beside this checkout's and
beside `tools/traversal_parts.cu` (design variants the port does not ship).
Prints one JSON line per measurement:

* `earlier`: the earlier kernel alone at every shape with random arenas
  below, timed before this checkout's kernels are built or launched.

* `traversal`: at the main shape (the 10-tree, depth-6 model fitted on N
  Higgs-shaped rows, over 100k held-out rows), the serving shapes (random
  arenas over the N training rows: 500 trees at depth 6 and 8, 700 trees x
  7 classes at depth 6, a fifth of the internal levels' nodes leaves, so a
  depth-6 walk stops after ~2.9 levels; and 500 trees at depth 6 with
  leaves only at the last level, so every walk takes 6 levels, as in a
  model fitted on 1M rows) and the deep and wide shapes (depth 14, depth 13
  x 4 classes, 300 classes), the mean ms of 20 launches with the L2 flushed
  before each, the earlier kernel (under its own plan) and this checkout's
  (under its wrapper's plan), both launched through their libraries, in
  turns (earlier, this, this, earlier), after a check that the two and the
  wrapper agree bit for bit; and this checkout's wrapper.
* `traversal_plans`: at the main shape, the serving shapes and depth 14,
  this checkout's kernel through the library under other plans, each
  checked equal to the wrapper's output: stages sized for shared-memory
  targets of 48 and 108 KB, the rows read from global memory, the arenas
  read through L2 with and without the row tile, every pair of rows a
  block (128, 256, 512) and arenas a stage (4 to 32) that fits a block,
  and, at one class, the sum in KREG registers by compare-select
  (`traversal_parts.cu`) in place of the one-register sum.
* `row_tile_crossover`: random depth-6 arenas of 10 to 160 trees over the
  100k held-out rows, the wrapper's plan at 128, 256 and 512 rows a block,
  with the row tile and with the rows read from global memory.
* `cuts`: on the N training rows (28 features, 256 bins), device us a
  launch of 200 launches queued back to back: the earlier kernel, the
  earlier kernel with the torch.sort of its candidates that its callers
  ran, this checkout's kernel, the variant of `traversal_parts.cu` at 1, 2,
  4 and 8 warps a feature and 8 / warps features a block (each first
  checked bit for bit against the earlier kernel's sorted candidates), and
  an empty launch; and `compute_cuts_op` as the earlier commit ran it (fill,
  column sort, kernel, candidate sort) and as this checkout runs it.
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

from repro_torch.core import Booster, DeviceDMatrix  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.kernels import build as KB, ops  # noqa: E402
from repro_torch.kernels import ensemble_traversal as ET  # noqa: E402
from repro_torch.kernels.quantile_cuts import quantile_cuts_from_sorted  # noqa: E402

from kernel_parts import shared_library  # noqa: E402

HELD_OUT = 100_000
MAX_BINS = 256
# (trees, depth, classes, share of the internal levels' nodes that are leaves)
SERVING = ((500, 6, 1, 0.2), (500, 8, 1, 0.2), (700, 6, 7, 0.2), (500, 6, 1, 0.0))
DEEP = ((4, 14, 1, HELD_OUT), (8, 13, 4, HELD_OUT), (600, 6, 300, 20_000))
CUT_WARPS = (1, 2, 4, 8)
P, I = ctypes.c_void_p, ctypes.c_int
PARTS_SIGNATURES = {"rt_parts_cuts": [P] * 3 + [I] * 4 + [P],
                    "rt_parts_traversal_kreg": [P] * 3 + [I] * 10 + [P]}
# Shapes whose launch plans are swept, and the sweep's rows a block and
# arenas a stage; tree counts at the main shape's rows for the row tile's
# crossover.
SWEPT = ("main", "serving_500x6x1", "serving_500x8x1", "serving_700x6x7",
         "serving_full_500x6x1", "deep_4x14x1")
SWEEP_ROWS = (128, 256, 512)
SWEEP_TREES = (4, 8, 12, 16, 20, 24, 32)
CROSSOVER_TREES = (10, 20, 40, 80, 160)


def earlier_module(parent: Path, name: str):
    """A module of the earlier checkout's `repro_torch.kernels`, loaded by
    path under its own name (`build` and the traversal wrapper's plan import
    nothing of the package at import time)."""
    path = parent / "src" / "repro_torch" / "kernels" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"earlier_{name}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # dataclasses look their module up there
    spec.loader.exec_module(module)
    return module


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("traversal_parts needs an NVIDIA card")
    earlier_build = earlier_module(args.parent, "build")
    earlier = earlier_build.lib()
    earlier_traversal = earlier_module(args.parent, "ensemble_traversal")
    earlier_plan, earlier_threads = earlier_traversal.traversal_plan, earlier_traversal.THREADS
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    smem_block = earlier_build.device_limits(0).smem_block
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    x, y, _ = make_dataset("higgs", args.rows + HELD_OUT, seed=args.seed)
    xt = torch.as_tensor(x[:args.rows], device=dev)
    xte = torch.as_tensor(x[args.rows:], device=dev)
    f = xt.shape[1]
    flush = torch.empty(128 << 18, device=dev)

    def mean_ms(fn, iters=20) -> list[float]:
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

    def back_to_back_us(fn, launches=200) -> float:
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(launches):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / launches * 1e3

    def random_ensemble(n_trees, depth, leaf_share=0.2):
        a = 2 ** (depth + 1) - 1
        is_leaf = torch.rand(n_trees, a, device=dev, generator=gen) < leaf_share
        is_leaf[:, 2 ** depth - 1:] = True
        thr = torch.randn(n_trees, a, device=dev, generator=gen)
        thr[is_leaf] = float("inf")
        return (torch.randint(0, f, (n_trees, a), device=dev, generator=gen, dtype=torch.int32),
                thr, torch.rand(n_trees, a, device=dev, generator=gen) < 0.5,
                torch.randn(n_trees, a, device=dev, generator=gen), is_leaf)

    def shipped_at(nodes, x_, k, depth, plan, threads=ET.THREADS, entry="rt_ensemble_margins"):
        out = torch.empty((x_.shape[0], k), device=dev)
        run = getattr(parts if entry.startswith("rt_parts") else lib, entry)
        KB.check(run(nodes.data_ptr(), x_.data_ptr(), out.data_ptr(), *nodes.shape[:2],
                     *x_.shape, k, depth, *plan, threads, stream), entry)
        return out

    def earlier_runner(arena, x_, k, depth):
        """The earlier kernel under its own plan, on its own arena types."""
        feat, thr, dl, leaf, is_leaf = arena
        old = (feat.to(torch.int32).contiguous(), thr.contiguous(),
               dl.to(torch.uint8).contiguous(), leaf.contiguous(),
               is_leaf.to(torch.uint8).contiguous())
        old_plan = earlier_plan(feat.shape[0], feat.shape[1], k, smem_block)
        out = torch.empty((x_.shape[0], k), device=dev)

        def run():
            KB.check(earlier.rt_ensemble_margins(
                *[t.data_ptr() for t in old], x_.data_ptr(), out.data_ptr(),
                *feat.shape, *x_.shape, k, depth, *old_plan, earlier_threads, stream),
                "earlier traversal")
            return out
        return run, old_plan

    print(json.dumps({"device": torch.cuda.get_device_name(0), "rows": args.rows}), flush=True)
    shapes = [(f"serving_{'full_' if share == 0 else ''}{t}x{d}x{k}",
               random_ensemble(t, d, share), xt, k, d) for t, d, k, share in SERVING]
    shapes += [(f"deep_{t}x{d}x{k}", random_ensemble(t, d), xte[:rows], k, d)
               for t, d, k, rows in DEEP]
    for name, arena, x_, k, depth in shapes:
        run, old_plan = earlier_runner(arena, x_, k, depth)
        print(json.dumps({"earlier": name, "plan": list(old_plan),
                          "ms": statistics.mean(mean_ms(run, 10))}), flush=True)

    # This checkout's kernels build from here on (the fit runs them).
    lib = KB.lib()
    parts = shared_library([ROOT / "tools" / "traversal_parts.cu"], "traversal_parts")
    for name, argtypes in PARTS_SIGNATURES.items():
        getattr(parts, name).argtypes = argtypes
    dtrain = DeviceDMatrix(x[:args.rows], label=y[:args.rows])
    ens = Booster(n_rounds=10, max_depth=6, max_bins=MAX_BINS,
                  objective="binary:logistic").fit(dtrain).ensemble
    del x, y, dtrain
    shapes.insert(0, ("main", (ens.feature, ens.threshold, ens.default_left, ens.leaf_value,
                               ens.is_leaf), xte, 1, 6))
    for name, arena, x_, k, depth in shapes:
        feat = arena[0]
        run_earlier, old_plan = earlier_runner(arena, x_, k, depth)
        nodes = ET.pack_nodes(*arena)
        plan = ET.traversal_plan(nodes.shape[0], nodes.shape[1], k, f, smem_block)
        out_s = torch.empty((x_.shape[0], k), device=dev)

        def run_shipped():  # the wrapper's launch, through the library like the earlier one
            KB.check(lib.rt_ensemble_margins(nodes.data_ptr(), x_.data_ptr(), out_s.data_ptr(),
                                             *nodes.shape[:2], *x_.shape, k, depth, *plan,
                                             ET.THREADS, stream), "shipped traversal")

        old_out = run_earlier()
        run_shipped()
        got = ET.ensemble_margins_kernel(nodes, x_, k, depth)
        torch.cuda.synchronize()
        if not (torch.equal(got, old_out) and torch.equal(out_s, got)):
            raise SystemExit(f"traversal {name}: this checkout and the earlier kernel differ")
        times = {"earlier": [], "shipped": []}
        for kind in ("earlier", "shipped", "shipped", "earlier"):
            times[kind] += mean_ms(run_earlier if kind == "earlier" else run_shipped, 10)
        print(json.dumps({"traversal": name, "trees": feat.shape[0], "depth": depth,
                          "classes": k, "rows": x_.shape[0], "plan": list(plan),
                          "earlier_plan": list(old_plan),
                          "ms": {kk: statistics.mean(v) for kk, v in times.items()},
                          "wrapper_ms": statistics.mean(mean_ms(
                              lambda: ET.ensemble_margins_kernel(nodes, x_, k, depth), 10)),
                          "earlier_over_shipped": statistics.mean(times["earlier"])
                          / statistics.mean(times["shipped"])}), flush=True)

        if name not in SWEPT:
            continue
        variants = {"wrapper": (plan, ET.THREADS)}
        for target in (48, 108):
            saved, ET.SMEM_TARGET = ET.SMEM_TARGET, target * 1024
            variants[f"target_{target}kb"] = (
                ET.traversal_plan(nodes.shape[0], nodes.shape[1], k, f, smem_block), ET.THREADS)
            ET.SMEM_TARGET = saved
        variants["rows_from_global"] = ((plan.class_tile, plan.trees_blk, 0), ET.THREADS)
        variants["through_l2"] = ((plan.class_tile, 0, 0), ET.THREADS)
        variants["through_l2_row_tile"] = ((plan.class_tile, 0, 1), ET.THREADS)
        if k == 1:
            variants["kreg_registers"] = (plan, ET.THREADS, "rt_parts_traversal_kreg")
        # Rows a block and arenas a stage, the row tile on: every pair whose
        # shared memory fits a block.
        tree_bytes = nodes.shape[1] * ET.NODE_BYTES
        for rows in SWEEP_ROWS:
            for tb in SWEEP_TREES:
                smem = ET.BARRIER_BYTES + 2 * tb * tree_bytes + rows * f * 4
                if tb <= nodes.shape[0] and smem <= smem_block:
                    variants[f"rows_{rows}_trees_{tb}"] = ((plan.class_tile, tb, 1), rows)
        out_v = {}
        for kind, (plan_v, threads, *entry) in variants.items():
            if not torch.equal(shipped_at(nodes, x_, k, depth, plan_v, threads, *entry), got):
                raise SystemExit(f"traversal {name} under {kind} {plan_v} differs")
            out_v[kind] = {"plan": list(plan_v), "rows_a_block": threads,
                           "ms": statistics.mean(mean_ms(
                               lambda: shipped_at(nodes, x_, k, depth, plan_v, threads,
                                                  *entry), 10))}
        print(json.dumps({"traversal_plans": name, "variants": out_v}), flush=True)
        del nodes, got, old_out, out_s, run_earlier

    # The row tile against rows read from global memory, by the trees a
    # block walks, at the main shape's rows and depth (random arenas).
    for n_trees in CROSSOVER_TREES:
        nodes = ET.pack_nodes(*random_ensemble(n_trees, 6))
        ms = {}
        for rows in SWEEP_ROWS:
            for row_tile in (1, 0):
                saved, ET.THREADS = ET.THREADS, rows  # the plan at `rows` rows a block
                plan = ET.traversal_plan(n_trees, nodes.shape[1], 1, f, smem_block)
                ET.THREADS = saved
                plan = (plan.class_tile, plan.trees_blk, row_tile)
                ms[f"rows_{rows}_row_tile_{row_tile}"] = {"plan": list(plan), "ms": statistics.mean(
                    mean_ms(lambda: shipped_at(nodes, xte, 1, 6, plan, rows), 10))}
        print(json.dumps({"row_tile_crossover": n_trees, "rows": xte.shape[0], "ms": ms}),
              flush=True)

    finite = torch.isfinite(xt)
    srt = torch.sort(torch.where(finite, xt, float("inf")), dim=0).values
    n_valid = finite.sum(dim=0, dtype=torch.int32)
    cand = torch.empty((f, MAX_BINS - 2), device=dev)

    def earlier_cuts():
        KB.check(earlier.rt_quantile_cuts(srt.data_ptr(), n_valid.data_ptr(), cand.data_ptr(),
                                          *srt.shape, MAX_BINS, stream), "earlier cuts")
        return cand

    def cuts_at(warps):
        out = torch.empty((f, MAX_BINS - 2), device=dev)
        KB.check(parts.rt_parts_cuts(srt.data_ptr(), n_valid.data_ptr(), out.data_ptr(),
                                     *srt.shape, MAX_BINS, warps, stream), "cuts")
        return out

    want = torch.sort(earlier_cuts(), dim=-1).values
    for warps in CUT_WARPS:
        if not torch.equal(cuts_at(warps), want):
            raise SystemExit(f"cut selection at {warps} warps a feature is not the earlier "
                             f"kernel's sorted candidates")
    if not torch.equal(quantile_cuts_from_sorted(srt, n_valid, MAX_BINS), want):
        raise SystemExit("the cut-selection wrapper is not the earlier sorted candidates")
    kinds = {"earlier": earlier_cuts,
             "earlier_and_sort": lambda: torch.sort(earlier_cuts(), dim=-1),
             "shipped": lambda: quantile_cuts_from_sorted(srt, n_valid, MAX_BINS),
             **{f"warps_{wp}": (lambda wp=wp: cuts_at(wp)) for wp in CUT_WARPS},
             "empty_launch": lambda: lib.rt_empty_launch(stream)}
    us = {kk: [] for kk in kinds}
    for kind in list(kinds) + list(kinds)[::-1]:
        us[kind].append(back_to_back_us(kinds[kind]))

    def earlier_compute_cuts():
        fin = torch.isfinite(xt)
        s_ = torch.sort(torch.where(fin, xt, float("inf")), dim=0).values
        nv = fin.sum(dim=0, dtype=torch.int32)
        c_ = torch.empty((f, MAX_BINS - 2), device=dev)
        KB.check(earlier.rt_quantile_cuts(s_.data_ptr(), nv.data_ptr(), c_.data_ptr(),
                                          *s_.shape, MAX_BINS, stream), "earlier cuts")
        return torch.sort(c_, dim=-1).values

    if not torch.equal(earlier_compute_cuts(), ops.compute_cuts_op(xt, MAX_BINS)):
        raise SystemExit("compute_cuts_op differs from the earlier commit's")
    op_us = {"earlier": [], "shipped": []}
    for kind in ("earlier", "shipped", "shipped", "earlier"):
        op_us[kind].append(back_to_back_us(
            earlier_compute_cuts if kind == "earlier"
            else (lambda: ops.compute_cuts_op(xt, MAX_BINS)), launches=20))
    print(json.dumps({"cuts": list(srt.shape), "max_bins": MAX_BINS,
                      "us_per_launch": {kk: statistics.mean(v) for kk, v in us.items()},
                      "compute_cuts_op_us": {kk: statistics.mean(v) for kk, v in op_us.items()}}),
          flush=True)
    print(json.dumps({"nvidia_smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
