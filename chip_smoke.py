#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) end to end on one card.

    python3 chip_smoke.py [--rows 1000000] [--seed 0] [--profile]

Phases, each printing one JSON line:
  1. device   — card name and count, `nvidia-smi` name and power limit.
  2. build    — nvcc build of the kernels from `src/repro_torch/kernels/csrc`
                for sm_90a, its time and the ptxas register/smem/spill report.
  3. main     — the main path through the user entry points: Higgs-shaped
                data (28 features, generated from --seed) -> DeviceDMatrix on
                cuda -> Booster(10 rounds, depth 6, 256 bins, binary:logistic).fit
                with the reference's default growth (subtraction trick) ->
                predict on 100k held-out rows. Held-out accuracy must beat
                0.7, the raw-row predictions must agree with the bin-space
                traversal of a ref= matrix, and each kernel of the path must
                launch as often as the path says (counts reset just before,
                read just after): privatised histogram 10, row-id histogram
                50, split scan 60, cut selection 1, traversal 1.
  4. fit      — two further fits on the same matrix, each with its own
                counts: `use_kernel_histograms=True` (privatised histogram
                60, row-id 0) and `growth="lossguide", max_leaves=32`. Each
                must beat 0.7; the share of trees whose structure matches
                between the main and the kernel-path fit is a reading, not a
                gate. Then FIT_PAIRS warm, untraced pairs of the default and
                the kernel-path fit, alternating which runs first: the two
                growths end to end, like for like.
  5. ops      — the path the reference gives `histogram_packed` and
                `decompress`: `ops.histogram_packed_op` and `ops.decompress_op`
                on the training matrix's words, counts reset just before.
  6. check    — each kernel against its plain PyTorch version on the same
                CUDA inputs, at the main path's shapes; the histograms also on
                a skewed copy of the words (SKEW of the symbols in the missing
                bin); traversal also at depth 14, depth 13 with 4 classes and
                300 classes (exact); and the subtraction trick's device path at
                level 5 against a full build.
  7. time     — CUDA-event ms of each kernel, its plain version and, where one
                PyTorch call computes the same function, that call; beside
                the bound (bytes over 3.35 TB/s or operations over peak), with
                each private histogram's launch plan (node tile, feature
                group, shared bytes, blocks per SM from the plan and from
                `cudaOccupancyMaxActiveBlocksPerMultiprocessor`), and the
                privatised kernel also under the earlier plan that fills a
                block's opt-in shared memory, on both word sets; the main
                path's traversal with its arenas staged and read through L2.
Then the kernels line, the `nvidia-smi` line and, last,
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; there is
no CPU path. Runs from the root of a checkout of the repository.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
HELD_OUT = 100_000
ROUNDS, DEPTH, MAX_BINS = 10, 6, 256
HIST_NODES = (1, 8, 32)  # full-level histograms checked: levels 0, 3 and 5
ROW_PARENTS = (1, 4, 16)  # row-id histograms checked: parents of levels 1, 3, 5
FIT_PAIRS = 5  # host times vary between fits: the median of five pairs
L2_FLUSH_BYTES = 128 << 20  # more than the 50 MB L2, written between timed launches
SKEW = 0.8  # share of the skewed words' symbols moved to the missing bin
# Traversal shapes past the staged route's shared memory: (trees, depth,
# classes, rows) — one arena of 459 KB, 4 classes beside a 229 KB arena,
# accumulators of 300 classes.
DEEP_TRAVERSALS = ((4, 14, 1, HELD_OUT), (8, 13, 4, HELD_OUT), (600, 6, 300, 20_000))

# Where each kernel's TPU original lives (file:line of its pallas_call). The
# row-id histogram extends the privatised kernel to the function the
# reference computes in XLA for the subtraction trick.
REPLACES = {
    "histogram_private": "src/repro/kernels/histogram.py:332",
    "histogram_rows": "src/repro/core/histogram.py:369",
    "histogram_packed": "src/repro/kernels/histogram.py:131",
    "split_scan": "src/repro/kernels/split_scan.py:81",
    "quantile_cuts": "src/repro/kernels/quantile_cuts.py:100",
    "ensemble_traversal": "src/repro/kernels/ensemble_traversal.py:175",
    "decompress": "src/repro/kernels/decompress.py:45",
}
SOURCES = {name: "src/repro_torch/kernels/csrc/"
           + ("histogram" if name.startswith("histogram") else name) + ".cu"
           for name in REPLACES}
# Further fits on the main matrix: Booster knobs beside the main path's.
FITS = {
    "kernel": {"use_kernel_histograms": True},
    "lossguide": {"growth": "lossguide", "max_leaves": 32},
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(report: str) -> list[dict]:
    """Registers, shared memory and spills per compiled kernel function."""
    rows, cur = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = re.search(r"\d([a-z][a-z_]*_kernel)", mangled)
            spw = re.search(r"_kernelILi(\d+)E", mangled)
            cur = {"function": (name.group(1) if name else mangled)
                   + (f"<{spw.group(1)}>" if spw else "")}
            rows.append(cur)
        elif cur is not None and "Used" in line and "registers" in line:
            cur["ptxas"] = line.split("ptxas info    :")[-1].strip()
        elif cur is not None and "spill" in line:
            cur["spill"] = line.split(":")[-1].strip()
    return rows


def path_launches(use_kernel_histograms: bool = False) -> dict[str, int]:
    """Launches of the growth kernels in one fit of ROUNDS trees, DEPTH levels
    each: every level scans its splits; the default growth histograms the
    root in full and every level below by the row-id kernel, the kernel path
    every level in full."""
    full = ROUNDS * (DEPTH if use_kernel_histograms else 1)
    return {"histogram_private": full, "histogram_rows": ROUNDS * DEPTH - full,
            "split_scan": ROUNDS * DEPTH}


def expect_launches(where: str, got: dict[str, int], want: dict[str, int]) -> None:
    wrong = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if wrong:
        raise SystemExit(f"{where}: launches (got, expected) {wrong}")


def profile_fit(dtrain) -> None:
    """A second fit, traced: device time by kernel, device busy time against
    the fit's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Booster

    def fit():
        Booster(n_rounds=ROUNDS, max_depth=DEPTH, max_bins=MAX_BINS,
                objective="binary:logistic").fit(dtrain)
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    fit()
    untraced = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit()
        traced = time.perf_counter() - t0
    events = prof.key_averages()

    def device_us(e) -> float:
        return float(getattr(e, "self_device_time_total", 0)
                     or getattr(e, "self_cuda_time_total", 0))

    # Only the kernels themselves: an aten op's self device time repeats
    # the time of the kernels it launched.
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise SystemExit("the profiler recorded no device kernels")
    busy = sum(device_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=device_us, reverse=True)[:12]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_fit.txt").write_text(
        events.table(sort_by="self_cuda_time_total", row_limit=60))
    emit({"phase": "profile", "fit_s_untraced": untraced, "fit_s_traced": traced,
          "device_busy_s": busy, "idle_share_untraced": 1 - busy / untraced,
          "device_kernel_launches": sum(e.count for e in kernels),
          "top": [{"name": e.key[:90], "device_ms": device_us(e) / 1e3,
                   "calls": e.count} for e in top]})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000,
                    help="training rows (the paper's Higgs run has 11,000,000)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace a second fit with torch.profiler: device time "
                         "by kernel and the device's idle share "
                         "(table in chiprun_out/profile_fit.txt)")
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import Booster, DeviceDMatrix
    from repro_torch.core.compress import pack, unpack
    from repro_torch.core.tree import _histograms_by_subtraction
    from repro_torch.core.histogram import node_sums
    from repro_torch.data import make_dataset
    from repro_torch.kernels import build as KB
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.decompress import decompress
    from repro_torch.kernels.ensemble_traversal import (
        THREADS as TRAVERSAL_THREADS,
        ensemble_margins_kernel,
        traversal_plan,
    )
    from repro_torch.kernels.histogram import (
        THREADS as HIST_THREADS,
        build_histograms_packed_kernel,
        build_histograms_rows_kernel,
        histogram_packed,
        launch_plan,
        occupancy,
    )
    from repro_torch.kernels.quantile_cuts import quantile_cuts_from_sorted
    from repro_torch.kernels.split_scan import split_scan

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- 1. device ---------------------------------------------------------
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    # --- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _, info = KB.library()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_seconds": round(info.seconds, 3), "library": info.path.name,
          "ptxas": ptxas_summary(info.ptxas)})

    # --- 3. main path --------------------------------------------------------
    x, y, _ = make_dataset("higgs", args.rows + HELD_OUT, seed=args.seed)
    x_tr, y_tr, x_te, y_te = x[:args.rows], y[:args.rows], x[args.rows:], y[args.rows:]
    booster_kw = dict(n_rounds=ROUNDS, max_depth=DEPTH, max_bins=MAX_BINS,
                      objective="binary:logistic")

    def accuracy(prob) -> float:
        if prob.shape != (HELD_OUT,) or not bool(torch.isfinite(prob).all()):
            raise SystemExit(f"predictions are not {HELD_OUT} finite values")
        return float(((prob.cpu().numpy() > 0.5) == y_te).mean())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    dtrain = DeviceDMatrix(x_tr, label=y_tr)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    bst = Booster(**booster_kw).fit(dtrain)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    prob = bst.predict(x_te)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = ops.launches()
    peak = torch.cuda.max_memory_allocated()
    acc = accuracy(prob)
    # The same model in bin space on a ref= matrix: x <= threshold exactly
    # when bin <= split_bin, so both traversals reach the same leaves.
    binned = bst.predict_margins(DeviceDMatrix(x_te, ref=dtrain))
    raw = bst.predict_margins(x_te)
    bin_err = float((binned - raw).abs().max())
    emit({"phase": "main", "rows": args.rows, "features": int(x.shape[1]),
          "bits": dtrain.bits, "rounds": ROUNDS, "max_depth": DEPTH,
          "max_bins": MAX_BINS, "build_s": t1 - t0, "fit_s": t2 - t1,
          "predict_s": t3 - t2, "held_out_accuracy": acc,
          "binned_vs_raw_max_err": bin_err, "max_memory_allocated": peak,
          "launches": launches})
    if acc <= 0.7:
        raise SystemExit(f"held-out accuracy {acc} does not beat 0.7")
    if bin_err > 1e-5:  # leaves summed in another order: float32 rounding
        raise SystemExit(f"raw and bin-space margins differ by {bin_err}")
    expect_launches("main path", launches, {**path_launches(), "quantile_cuts": 1,
                                            "ensemble_traversal": 1})

    # --- 4. further fits on the same matrix -----------------------------------
    ens = bst.ensemble
    for name, knobs in FITS.items():
        ops.reset_launches()
        t0 = time.perf_counter()
        other = Booster(**booster_kw, **knobs).fit(dtrain)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = ops.launches()
        line = {"phase": "fit", "fit": name, **knobs, "fit_s": fit_s,
                "held_out_accuracy": accuracy(other.predict(x_te)),
                "launches": fit_launches}
        if name == "kernel":
            # Subtraction rounds differently from a full build, so a near-tied
            # split may flip and the trees after it follow other gradients.
            same = torch.ones(ens.n_trees, dtype=torch.bool, device=dev)
            for f in ("feature", "split_bin", "default_left", "is_leaf"):
                same &= (getattr(ens, f) == getattr(other.ensemble, f)).all(dim=1)
            line["trees_same_structure_as_main"] = float(same.float().mean())
        elif name == "lossguide":
            leaves = other.ensemble.is_leaf.sum(dim=1)
            line["leaves_per_tree_max"] = int(leaves.max())
            if int(leaves.max()) > knobs["max_leaves"]:
                raise SystemExit(f"lossguide grew {int(leaves.max())} leaves")
        emit(line)
        if line["held_out_accuracy"] <= 0.7:
            raise SystemExit(f"{name} fit: held-out accuracy does not beat 0.7")
        expect_launches(f"{name} fit", fit_launches,
                        path_launches(knobs.get("use_kernel_histograms", False)))

    pair_s: dict[str, list[float]] = {"default": [], "kernel": []}
    for i in range(FIT_PAIRS):
        for name in ("default", "kernel") if i % 2 == 0 else ("kernel", "default"):
            t0 = time.perf_counter()
            Booster(**booster_kw, **FITS.get(name, {})).fit(dtrain)
            torch.cuda.synchronize()
            pair_s[name].append(time.perf_counter() - t0)
    med = {k: sorted(v)[FIT_PAIRS // 2] for k, v in pair_s.items()}
    emit({"phase": "fit_pairs", "fit_s": pair_s, "median_default_s": med["default"],
          "median_kernel_s": med["kernel"],
          "default_over_kernel": med["default"] / med["kernel"],
          "default_slower_in_pairs": sum(d > k for d, k in zip(pair_s["default"],
                                                               pair_s["kernel"]))})

    if args.profile:
        profile_fit(dtrain)

    # Inputs of the kernel phases, at the main path's shapes.
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n, f = dtrain.n_rows, dtrain.n_features
    packed, bits = dtrain.matrix.packed, dtrain.bits
    p = torch.sigmoid(torch.randn(n, device=dev, generator=gen))
    yy = torch.as_tensor(y_tr, device=dev)
    gh = torch.stack([p - yy, p * (1 - p)], dim=1).contiguous()
    # Integer (g, h), g in {-1, 0, 1} and h = 1: every partial sum is an
    # integer below 2^24 in magnitude (there are fewer rows per bin), so it is
    # exact in float32 in any order, and kernel and plain version must agree
    # exactly: h counts the rows of each (node, feature, bin), so every row
    # must land in its own. The skewed words put most rows in one bin.
    gh_exact = torch.stack([
        torch.randint(-1, 2, (n,), device=dev, generator=gen).to(torch.float32),
        torch.ones(n, device=dev),
    ], dim=1).contiguous()
    ones = torch.ones_like(gh)

    def level_positions(n_nodes: int) -> torch.Tensor:
        """Rows spread over the level's nodes; inactive rows carry n_nodes
        or, as the reference pads them for histogram_packed, -1."""
        pos = torch.randint(0, n_nodes + 1, (n,), device=dev, generator=gen,
                            dtype=torch.int32)
        gone = torch.rand(n, device=dev, generator=gen) < 0.05
        return torch.where(gone, -1, pos).to(torch.int32)

    def row_buffer(n_par: int):
        """A compacted buffer as the subtraction trick makes it: n // 2 slots,
        the selected rows (45% of all) in row order, 5% of them at the dump
        position, then padding slots with id n at the dump position."""
        m = n // 2
        rid = torch.nonzero(torch.rand(n, device=dev, generator=gen) < 0.45)[:m, 0]
        k = rid.shape[0]
        rid = torch.cat([rid, torch.full((m - k,), n, device=dev, dtype=rid.dtype)])
        pos = torch.randint(0, n_par, (m,), device=dev, generator=gen, dtype=torch.int32)
        dump = torch.rand(m, device=dev, generator=gen) < 0.05
        pos = torch.where(dump | (torch.arange(m, device=dev) >= k), n_par, pos)
        return rid.to(torch.int32), pos.to(torch.int32)

    levels = {nn: level_positions(nn) for nn in HIST_NODES}
    buffers = {npar: row_buffer(npar) for npar in ROW_PARENTS}
    # The training matrix with SKEW of its symbols moved to the missing bin,
    # as in sparse data: many lanes of a warp add to one (node, bin).
    dense = unpack(packed, bits, n)
    skewed = pack(torch.where(torch.rand(dense.shape, device=dev, generator=gen) < SKEW,
                              MAX_BINS - 1, dense), bits)

    def counts_and_tolerance(plain, *args):
        """Rows per bin, and the tolerance for real-valued (g, h): atomics add
        in no fixed order, and summing k terms in two arbitrary orders
        differs by about sqrt(k) * 2^-24 * sum|x|; four times that, per bin."""
        count = plain(*args[:1], ones[:args[1].shape[0]], *args[2:])[..., :1]
        if float(count.max()) >= 2**24:
            raise SystemExit("rows per bin too many for the exact histogram check")
        mag = plain(*args[:1], args[1].abs(), *args[2:])
        return 2e-5 + 4 * count.sqrt() * 2**-24 * mag

    # --- 5. the ops path of histogram_packed and decompress -----------------
    ops.reset_launches()
    hp = ops.histogram_packed_op(packed, gh, levels[32], 32, MAX_BINS, bits)
    bins = ops.decompress_op(packed, bits, n)
    torch.cuda.synchronize()
    ops_launches = ops.launches()
    want_hp = ref.histogram_packed_ref(packed, gh, levels[32], 32, MAX_BINS, bits)
    hp_ok = bool(((hp - want_hp).abs() <= counts_and_tolerance(
        ref.histogram_packed_ref, packed, gh, levels[32], 32, MAX_BINS, bits)).all())
    bins_exact = bool(torch.equal(bins, ref.decompress_ref(packed, bits, n)))
    emit({"phase": "ops", "launches": ops_launches, "histogram_packed_op_ok": hp_ok,
          "decompress_op_exact": bins_exact, "bins_shape": list(bins.shape)})
    expect_launches("ops path", ops_launches, {"histogram_packed": 1, "decompress": 1})
    if not hp_ok or not bins_exact or bins.shape != (n, f):
        raise SystemExit("the ops path's histogram or bins disagree with the plain versions")
    del bins

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    def time_ms(fn, iters=20, warmup=3) -> float:
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            flush.zero_()  # each launch finds the L2 cold, as in a fit
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            total += s.elapsed_time(e)
        return total / iters

    def random_ensemble(n_trees: int, depth: int, n_features: int, g):
        """Random complete arenas: a fifth of the nodes leaves, the last level
        all leaves, thresholds around the features' scale."""
        a = 2 ** (depth + 1) - 1
        is_leaf = torch.rand(n_trees, a, device=dev, generator=g) < 0.2
        is_leaf[:, 2 ** depth - 1:] = True
        thr = torch.randn(n_trees, a, device=dev, generator=g)
        thr[is_leaf] = float("inf")
        return (torch.randint(0, n_features, (n_trees, a), device=dev, generator=g,
                              dtype=torch.int32),
                thr, torch.rand(n_trees, a, device=dev, generator=g) < 0.5,
                torch.randn(n_trees, a, device=dev, generator=g), is_leaf)

    # --- 6. kernels against their plain versions ---------------------------
    results: dict[str, dict] = {}
    checked: dict[str, list] = {"histogram_private": [], "histogram_packed": [],
                                "histogram_rows": []}

    def check(got, want, tol):
        err = float((got - want).abs().max())
        ok = bool(((got - want).abs() <= tol).all())
        return err, ok

    def check_histogram(name, kernel, plain, size, *rest, words=packed, data="higgs"):
        """Exact on integer (g, h); within the sqrt(rows) tolerance on real.
        On the skewed words the real-valued plain version runs in float64:
        in float32 its index_add_ adds a hot bin's hundreds of thousands of
        positive h one at a time, and that running sum drifts past the
        tolerance by itself (the kernels add blocked or aggregated sums)."""
        inputs = {"exact": (words, gh_exact, *rest), "real": (words, gh, *rest)}
        if name == "histogram_rows":  # (g, h) gathered for each slot's row
            rid = rest[1].to(torch.int64).clamp(max=n - 1)
            inputs = {k: (words, v[1][rid], *rest) for k, v in inputs.items()}
        exact_err = float((kernel(*inputs["exact"]) - plain(*inputs["exact"])).abs().max())
        got = kernel(*inputs["real"])
        real = inputs["real"]
        want = plain(*real) if data == "higgs" else plain(real[0], real[1].double(), *real[2:])
        err, ok = check(got, want, counts_and_tolerance(plain, *real))
        checked[name].append({"nodes": size, "data": data, "exact_max_abs_err": exact_err,
                              "max_abs_err": err, "ok": ok})
        if exact_err != 0.0 or not ok:
            raise SystemExit(f"{name} disagrees at {size} nodes on {data}: exact "
                             f"{exact_err}, real {err}")
        return got

    for words, data in ((packed, "higgs"), (skewed, "skewed")):
        for nn in HIST_NODES:
            hist = check_histogram("histogram_private", build_histograms_packed_kernel,
                                   ref.histogram_ref, nn, levels[nn], nn, MAX_BINS, bits,
                                   words=words, data=data)
            check_histogram("histogram_packed", histogram_packed, ref.histogram_packed_ref,
                            nn, levels[nn], nn, MAX_BINS, bits, words=words, data=data)
            if data == "higgs" and nn == HIST_NODES[-1]:
                hist32 = hist
        for npar in ROW_PARENTS:
            rid, pos = buffers[npar]
            check_histogram("histogram_rows", build_histograms_rows_kernel,
                            ref.histogram_rows_ref, npar, pos, rid, npar, MAX_BINS, bits,
                            words=words, data=data)
    # The subtraction trick's device path (lane-spread counts, scatter
    # compaction, sibling = parent - child) at level 5 of the main matrix,
    # against a full build of the level: exact on integer (g, h); on real
    # (g, h) a sibling carries its parent's rounding, so each child is held
    # to its parent's tolerance.
    local = torch.where(levels[32] < 0, 32, levels[32])
    par = torch.where(local < 32, local // 2, 16).to(torch.int32)
    sub_err = {}
    for name_gh, g in (("exact", gh_exact), ("real", gh)):
        prev = build_histograms_packed_kernel(packed, g, par, 16, MAX_BINS, bits)
        got = _histograms_by_subtraction(dtrain.matrix.as_packed_bins(), g, local,
                                         prev, 32, MAX_BINS)
        want = build_histograms_packed_kernel(packed, g, local, 32, MAX_BINS, bits)
        sub_err[name_gh] = got - want
    tol = counts_and_tolerance(ref.histogram_ref, packed, gh, par, 16, MAX_BINS,
                               bits).repeat_interleave(2, dim=0)
    results["subtraction_level5"] = {
        "exact_max_abs_err": float(sub_err["exact"].abs().max()),
        "max_abs_err": float(sub_err["real"].abs().max()),
        "tolerance": "integer gh exact; real gh the parent's sqrt(rows) tolerance",
    }
    if float(sub_err["exact"].abs().max()) != 0.0 or not bool((sub_err["real"].abs() <= tol).all()):
        raise SystemExit(f"subtraction at level 5 disagrees with a full build: "
                         f"{results['subtraction_level5']}")
    del sub_err, tol, prev
    for name, rows in checked.items():
        results[name] = {
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "tolerance": "integer gh exact; real gh 2e-5 + 4*sqrt(rows)*2^-24*hist(|g|,|h|) "
                         "(skewed words: against the plain version in float64)",
        }

    parent = node_sums(hist32)  # (32, 2) node sums over feature 0's bins
    got = split_scan(hist32, parent, 1.0, 1.0)
    want = ref.split_scan_ref(hist32, parent, 1.0, 1.0)
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)) or not torch.equal(got[..., 1:3], want[..., 1:3]):
        raise SystemExit("split_scan kernel: bins, directions or -inf pattern differ")
    err, ok = check(got[fin], want[fin], 1e-6 * want[fin].abs().clamp(min=1))
    results["split_scan"] = {"max_abs_err": err, "tolerance": "bins/dirs exact, floats 1e-6 rel"}
    if not ok:
        raise SystemExit(f"split_scan kernel disagrees: {err}")

    xt = torch.as_tensor(x_tr, device=dev)
    finite = torch.isfinite(xt)
    srt = torch.sort(torch.where(finite, xt, float("inf")), dim=0).values
    n_valid = finite.sum(dim=0, dtype=torch.int32)
    got = quantile_cuts_from_sorted(srt, n_valid, MAX_BINS)
    want = ref.quantile_cuts_ref(srt, n_valid, MAX_BINS)
    if not torch.equal(torch.isfinite(got), torch.isfinite(want)):
        raise SystemExit("quantile_cuts kernel: +inf pattern differs")
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max())
    results["quantile_cuts"] = {"max_abs_err": err, "tolerance": "exact"}
    if err != 0.0:
        raise SystemExit(f"quantile_cuts kernel disagrees: {err}")

    xte = torch.as_tensor(x_te, device=dev)
    targs = (ens.feature, ens.threshold, ens.default_left, ens.leaf_value,
             ens.is_leaf, xte, ens.n_classes, DEPTH)
    got = ensemble_margins_kernel(*targs)
    want = ref.ensemble_margins_ref(*targs)
    err, ok = check(got, want, 1e-5)

    def kernel_types(args):
        """The traversal's arguments with the arena already in the kernel's
        types, so that a timed call launches the kernel and converts nothing."""
        feat, thr, dl, leaf, is_leaf = args[:5]
        return (feat.to(torch.int32).contiguous(), thr.contiguous(),
                dl.to(torch.uint8).contiguous(), leaf.contiguous(),
                is_leaf.to(torch.uint8).contiguous(), *args[5:])

    # Models past the staged route's shared memory: the arenas read through
    # L2, or the classes tiled over the grid. Each class sums in tree order
    # on both sides, so these must agree bit for bit.
    deep = []
    for n_trees, depth, k, rows in DEEP_TRAVERSALS:
        dargs = (*random_ensemble(n_trees, depth, f, gen), xte[:rows], k, depth)
        kdargs = kernel_types(dargs)
        d_err = float((ensemble_margins_kernel(*dargs) - ref.ensemble_margins_ref(*dargs))
                      .abs().max())
        deep.append({"trees": n_trees, "depth": depth, "classes": k, "rows": rows,
                     "plan": list(traversal_plan(n_trees, 2 ** (depth + 1) - 1, k,
                                                 KB.device_limits(0).smem_block)),
                     "max_abs_err": d_err,
                     "ms": time_ms(lambda: ensemble_margins_kernel(*kdargs))})
        if d_err != 0.0:
            raise SystemExit(f"ensemble_traversal disagrees at depth {depth}, {k} "
                             f"classes: {d_err}")
    results["ensemble_traversal"] = {"max_abs_err": err, "tolerance": "1e-5; deep and "
                                     "wide models exact", "deep_and_wide": deep}
    if not ok:
        raise SystemExit(f"ensemble_traversal kernel disagrees: {err}")

    # decompress: the training matrix (8-bit symbols) and 4-bit symbols at an
    # odd row count, against the plain unpack and against the bins packed.
    n_odd = n - 1 if n % 2 == 0 else n
    bins4 = torch.randint(0, 16, (n_odd, f), device=dev, generator=gen, dtype=torch.int32)
    packed4 = pack(bins4, 4)
    dec_err = 0
    for words, b, rows, truth in ((packed, bits, n, None), (packed4, 4, n_odd, bins4)):
        got = decompress(words, b, rows)
        want = ref.decompress_ref(words, b, rows)
        dec_err = max(dec_err, int((got - want).abs().max()))
        if truth is not None:
            dec_err = max(dec_err, int((got - truth).abs().max()))
    results["decompress"] = {"max_abs_err": float(dec_err), "tolerance": "exact"}
    if dec_err != 0:
        raise SystemExit(f"decompress kernel disagrees: {dec_err}")
    del bins4, packed4, got, want
    emit({"phase": "check", **results, **{f"{k}_levels": v for k, v in checked.items()}})

    # --- 7. times -------------------------------------------------------------
    def bound(nbytes: float, nops: float) -> tuple[float, str]:
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    def library_scatter(bins_rows, pos, src, n_nodes):
        """One `scatter_add_` on the flat index ((pos * F) + f) * B + bin, as
        a function of (output, index, source), and its inputs."""
        pos = pos.to(torch.int64)
        pos = torch.where((pos >= 0) & (pos < n_nodes), pos, n_nodes)
        idx = (pos[:, None] * f + torch.arange(f, device=dev)[None, :]) * MAX_BINS \
            + bins_rows.to(torch.int64)
        idx = idx.reshape(-1, 1).expand(-1, 2)
        src = src[:, None, :].expand(-1, f, 2).reshape(-1, 2)
        out = torch.zeros(((n_nodes + 1) * f * MAX_BINS, 2), device=dev)
        return lambda: out.scatter_add_(0, idx, src)

    w = packed.shape[1]
    limits = KB.device_limits(0)

    def plan_reading(kind: str, n_items: int, nodes: int) -> dict:
        """A private kernel's launch plan, and the resident blocks per SM that
        the CUDA runtime allows it (registers and threads included)."""
        plan = launch_plan(n_items, f, nodes, MAX_BINS, limits)
        return {"node_tile": plan.node_tile, "feat_group": plan.feat_group,
                "items_per_block": plan.words_per_block, "smem_bytes": plan.smem_bytes,
                "blocks_per_sm_by_smem": plan.blocks_per_sm,
                "blocks_per_sm_occupancy": occupancy(kind, plan, bits)}

    def fill_plan(n_items: int, nodes: int) -> tuple[int, int, int]:
        """The private kernels' earlier plan, for comparison: one block fills
        the opt-in shared memory (nodes first, then features beside them),
        and the stripes make about two blocks per SM."""
        per_node = MAX_BINS * 8
        node_tile = min(nodes, limits.smem_block // per_node)
        feat_group = min(f, limits.smem_block // (node_tile * per_node))
        tiles = -(-f // feat_group) * -(-nodes // node_tile)
        row_blocks = max(1, min(-(-n_items // 1024), -(-2 * limits.n_sm // tiles)))
        return node_tile, feat_group, -(-n_items // row_blocks)

    def private_at(plan, words_, gh_, pos, nn):
        """#1 under `plan` (node tile, feature group, words per block),
        through the library itself: the launch is not counted."""
        out = torch.zeros((nn, f, MAX_BINS, 2), device=dev)
        KB.check(KB.lib().rt_histogram_private(
            words_.data_ptr(), gh_.data_ptr(), pos.data_ptr(), out.data_ptr(), n, f, w,
            nn, MAX_BINS, bits, *plan, HIST_THREADS, KB.stream(dev)), "histogram_private")
        return out

    # With (g, h) all zero the privatised kernel does every shared-memory
    # atomic but its private histograms stay zero, and the flush skips zero
    # entries: the difference of the two times is what the flush costs.
    zero_gh = torch.zeros_like(gh)
    hist_rows, rows_rows = [], []
    spw = 32 // bits
    for words_, data in ((packed, "higgs"), (skewed, "skewed")):
        dense_ = dense if data == "higgs" else unpack(words_, bits, n)
        for nn in HIST_NODES:
            pos = levels[nn]
            active = int(((pos >= 0) & (pos < nn)).sum())
            b_ms, b_by = bound(f * w * 4 + n * 8 + n * 4 + nn * f * MAX_BINS * 8,
                               2 * active * f)
            hargs = (words_, gh, pos, nn, MAX_BINS, bits)
            fill = fill_plan(w, nn)
            if not torch.equal(private_at(fill, words_, gh_exact, pos, nn),
                               build_histograms_packed_kernel(words_, gh_exact, *hargs[2:])):
                raise SystemExit(f"histogram_private under the fill plan disagrees at {nn} nodes")
            row = {
                "n_nodes": nn, "data": data,
                "private_ms": time_ms(lambda: build_histograms_packed_kernel(*hargs)),
                "private_fill_plan_ms": time_ms(lambda: private_at(fill, words_, gh, pos, nn)),
                "fill_plan": list(fill),
                "packed_ms": time_ms(lambda: histogram_packed(*hargs)),
                "library_ms": time_ms(library_scatter(dense_, pos, gh, nn), iters=5),
                "bound_ms": b_ms, "bound_by": b_by,
            }
            if data == "higgs":
                row.update(
                    private_zero_gh_ms=time_ms(lambda: build_histograms_packed_kernel(
                        packed, zero_gh, pos, nn, MAX_BINS, bits)),
                    plain_ms=time_ms(lambda: ref.histogram_ref(*hargs), iters=5),
                    plan=plan_reading("private", w, nn),
                    packed_blocks_per_sm_occupancy=occupancy("packed", None, bits))
            hist_rows.append(row)

        for npar in ROW_PARENTS:
            rid, pos = buffers[npar]
            valid = pos < npar
            gh_sel = gh[rid.to(torch.int64).clamp(max=n - 1)]
            rargs = (words_, gh_sel, pos, rid, npar, MAX_BINS, bits)
            # Bytes this run's data needs: the words of the valid slots' rows,
            # each (g, h), position and row id once, the histogram once.
            n_words_touched = int(torch.unique(rid[valid].to(torch.int64) // spw).numel())
            m = rid.shape[0]
            b_ms, b_by = bound(f * n_words_touched * 4 + m * (8 + 4 + 4)
                               + npar * f * MAX_BINS * 8, 2 * int(valid.sum()) * f)
            row = {
                "n_parents": npar, "data": data, "slots": m, "valid_slots": int(valid.sum()),
                "words_touched": n_words_touched,
                "ms": time_ms(lambda: build_histograms_rows_kernel(*rargs)),
                "library_ms": time_ms(library_scatter(
                    dense_[rid.to(torch.int64).clamp(max=n - 1)], pos, gh_sel, npar), iters=5),
                "bound_ms": b_ms, "bound_by": b_by,
            }
            if data == "higgs":
                row["plain_ms"] = time_ms(lambda: ref.histogram_rows_ref(*rargs), iters=5)
                row["plan"] = plan_reading("rows", m, npar)
            if data == "higgs" and npar == ROW_PARENTS[-1]:
                # The same slots in a random order: what the buffer's row order
                # (neighbouring slots sharing a word) is worth.
                perm = torch.randperm(m, device=dev, generator=gen)
                shuffled = (packed, gh_sel[perm].contiguous(), pos[perm].contiguous(),
                            rid[perm].contiguous(), npar, MAX_BINS, bits)
                row["shuffled_slots_ms"] = time_ms(
                    lambda: build_histograms_rows_kernel(*shuffled))
            rows_rows.append(row)
        del dense_
    emit({"phase": "time", "histogram_levels": hist_rows})
    emit({"phase": "time", "histogram_rows_levels": rows_rows})
    del dense, skewed

    n_nodes, nf, nb = hist32.shape[:3]
    nvb_cuts = MAX_BINS - 2
    t_trees, arena = ens.feature.shape
    top = next(r for r in hist_rows
               if r["data"] == "higgs" and r["n_nodes"] == HIST_NODES[-1])
    top_rows = next(r for r in rows_rows
                    if r["data"] == "higgs" and r["n_parents"] == ROW_PARENTS[-1])
    # The main path's traversal also with every arena read through L2
    # (trees_blk 0), as deeper models read them, through the library itself
    # (not counted): what staging the arenas in shared memory is worth.
    ktargs = kernel_types(targs)
    t_out = torch.empty((xte.shape[0], ens.n_classes), device=dev)

    def arenas_through_l2():
        KB.check(KB.lib().rt_ensemble_margins(
            *[t.data_ptr() for t in ktargs[:6]], t_out.data_ptr(), *ktargs[0].shape,
            *xte.shape, ens.n_classes, DEPTH, ens.n_classes, 0, TRAVERSAL_THREADS,
            KB.stream(dev)), "ensemble_margins")

    arenas_through_l2()
    if not torch.equal(t_out, ensemble_margins_kernel(*ktargs)):
        raise SystemExit("the traversal through L2 differs from the staged route")
    times = {
        "histogram_private": {"ms": top["private_ms"],
                              **{k: top[k] for k in ("plain_ms", "library_ms",
                                                     "bound_ms", "bound_by")}},
        "histogram_packed": {"ms": top["packed_ms"],
                             **{k: top[k] for k in ("plain_ms", "library_ms",
                                                    "bound_ms", "bound_by")}},
        "histogram_rows": {k: top_rows[k] for k in ("ms", "plain_ms", "library_ms",
                                                    "bound_ms", "bound_by")},
        "split_scan": {
            "ms": time_ms(lambda: split_scan(hist32, parent, 1.0, 1.0)),
            "plain_ms": time_ms(lambda: ref.split_scan_ref(hist32, parent, 1.0, 1.0), iters=5),
            "library_ms": None,
        },
        "quantile_cuts": {
            "ms": time_ms(lambda: quantile_cuts_from_sorted(srt, n_valid, MAX_BINS)),
            "plain_ms": time_ms(lambda: ref.quantile_cuts_ref(srt, n_valid, MAX_BINS), iters=5),
            "library_ms": None,
        },
        "ensemble_traversal": {
            "ms": time_ms(lambda: ensemble_margins_kernel(*ktargs), iters=50),
            "plain_ms": time_ms(lambda: ref.ensemble_margins_ref(*targs), iters=5),
            "library_ms": None,
        },
        "decompress": {
            "ms": time_ms(lambda: decompress(packed, bits, n)),
            "plain_ms": time_ms(lambda: ref.decompress_ref(packed, bits, n), iters=5),
            "library_ms": None,
        },
    }
    # Prefix sums (2 adds per candidate) and two gain evaluations of 11 flops.
    b_ms, b_by = bound(n_nodes * nf * nb * 8 + n_nodes * 8 + n_nodes * nf * 5 * 4,
                       n_nodes * nf * (nb - 2) * (2 + 2 * 11))
    times["split_scan"].update(bound_ms=b_ms, bound_by=b_by)
    # Two sorted values gathered per candidate, the counts, the candidates out.
    b_ms, b_by = bound(nf * nvb_cuts * 2 * 4 + nf * 4 + nf * nvb_cuts * 4,
                       nf * nvb_cuts * 6)
    times["quantile_cuts"].update(bound_ms=b_ms, bound_by=b_by)
    # Rows read once, the arena once, margins written once; a compare per level.
    b_ms, b_by = bound(HELD_OUT * nf * 4 + t_trees * arena * 14 + HELD_OUT * 4,
                       HELD_OUT * t_trees * 6 + HELD_OUT * t_trees)
    times["ensemble_traversal"].update(bound_ms=b_ms, bound_by=b_by)
    # The words read once, one int32 written per (row, feature); a shift and
    # a mask per element.
    b_ms, b_by = bound(f * w * 4 + n * f * 4, 2 * n * f)
    times["decompress"].update(bound_ms=b_ms, bound_by=b_by)

    emit({"phase": "time", "ensemble_traversal_routes": {
        "rows": HELD_OUT, "trees": t_trees, "max_depth": DEPTH,
        "plan": list(traversal_plan(t_trees, arena, ens.n_classes,
                                    KB.device_limits(0).smem_block)),
        "staged_ms": times["ensemble_traversal"]["ms"],
        "through_l2_ms": time_ms(arenas_through_l2, iters=50)}})
    counted = {**launches, **{k: ops_launches[k] for k in ("histogram_packed", "decompress")}}
    kernels = []
    for name in REPLACES:
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": counted[name],
            "max_abs_err": results[name]["max_abs_err"], **times[name],
        })
    if "jax" in sys.modules or any(m == "repro" or m.startswith("repro.") for m in sys.modules):
        raise SystemExit("the port imported JAX or the JAX package")
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
