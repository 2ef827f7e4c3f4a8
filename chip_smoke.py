#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) end to end on one card.

    python3 chip_smoke.py [--rows 1000000] [--seed 0]

Phases, each printing one JSON line:
  1. device   — card name and count, `nvidia-smi` name and power limit.
  2. build    — nvcc build of the four kernels from `src/repro_torch/kernels/csrc`
                for sm_90a, its time and the ptxas register/smem/spill report.
  3. main     — the main path through the user entry points: Higgs-shaped
                data (28 features, generated from --seed) -> DeviceDMatrix on
                cuda -> Booster(10 rounds, depth 6, 256 bins, binary:logistic).fit
                -> predict on 100k held-out rows. Held-out accuracy must beat
                0.7, the raw-row predictions must agree with the bin-space
                traversal of a ref= matrix, and every kernel's launch count
                (reset just before, read just after) must be > 0.
  4. check    — each kernel against its plain PyTorch version on the same
                CUDA inputs, at the main path's shapes.
  5. time     — CUDA-event ms of each kernel, its plain version and, where one
                PyTorch call computes the same function, that call; beside
                the bound (bytes over 3.35 TB/s or operations over peak).
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
HIST_NODES = (1, 8, 32)  # histogram shapes checked: levels 0, 3 and 5 at depth 6
L2_FLUSH_BYTES = 128 << 20  # more than the 50 MB L2, written between timed launches

# Where each kernel's TPU original lives (file:line of its pallas_call).
REPLACES = {
    "histogram": "src/repro/kernels/histogram.py:332",
    "split_scan": "src/repro/kernels/split_scan.py:81",
    "quantile_cuts": "src/repro/kernels/quantile_cuts.py:100",
    "ensemble_traversal": "src/repro/kernels/ensemble_traversal.py:175",
}
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name}.cu" for name in REPLACES}


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


def profile_fit(dtrain) -> None:
    """A second fit, traced: device time by kernel, device busy time against
    the fit's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Booster

    def fit():
        Booster(n_rounds=10, max_depth=6, max_bins=256,
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
    from repro_torch.core.compress import unpack
    from repro_torch.data import make_dataset
    from repro_torch.kernels import build as KB
    from repro_torch.kernels import ops, ref

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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    dtrain = DeviceDMatrix(x_tr, label=y_tr)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    bst = Booster(n_rounds=10, max_depth=6, max_bins=256,
                  objective="binary:logistic").fit(dtrain)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    prob = bst.predict(x_te)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = ops.launches()
    peak = torch.cuda.max_memory_allocated()
    if prob.shape != (HELD_OUT,) or not bool(torch.isfinite(prob).all()):
        raise SystemExit(f"predictions are not {HELD_OUT} finite values")
    acc = float(((prob.cpu().numpy() > 0.5) == y_te).mean())
    # The same model in bin space on a ref= matrix: x <= threshold exactly
    # when bin <= split_bin, so both traversals reach the same leaves.
    binned = bst.predict_margins(DeviceDMatrix(x_te, ref=dtrain))
    raw = bst.predict_margins(x_te)
    bin_err = float((binned - raw).abs().max())
    emit({"phase": "main", "rows": args.rows, "features": int(x.shape[1]),
          "bits": dtrain.bits, "rounds": 10, "max_depth": 6, "max_bins": 256,
          "build_s": t1 - t0, "fit_s": t2 - t1, "predict_s": t3 - t2,
          "held_out_accuracy": acc, "binned_vs_raw_max_err": bin_err,
          "max_memory_allocated": peak, "launches": launches})
    if acc <= 0.7:
        raise SystemExit(f"held-out accuracy {acc} does not beat 0.7")
    if bin_err > 1e-5:  # leaves summed in another order: float32 rounding
        raise SystemExit(f"raw and bin-space margins differ by {bin_err}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise SystemExit(f"the main path never launched {missing}")

    if args.profile:
        profile_fit(dtrain)

    # --- 4. kernels against their plain versions ---------------------------
    from repro_torch.kernels.ensemble_traversal import ensemble_margins_kernel
    from repro_torch.kernels.histogram import build_histograms_packed_kernel
    from repro_torch.kernels.quantile_cuts import quantile_cuts_from_sorted
    from repro_torch.kernels.split_scan import split_scan

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n, f = dtrain.n_rows, dtrain.n_features
    packed, bits = dtrain.matrix.packed, dtrain.bits
    p = torch.sigmoid(torch.randn(n, device=dev, generator=gen))
    yy = torch.as_tensor(y_tr, device=dev)
    gh = torch.stack([p - yy, p * (1 - p)], dim=1).contiguous()
    results: dict[str, dict] = {}
    levels = []

    def check(got, want, tol):
        err = float((got - want).abs().max())
        ok = bool(((got - want).abs() <= tol).all())
        return err, ok

    hist32 = None
    ones = torch.ones_like(gh)
    # Dyadic (g, h) with few significant bits: every partial sum is exact in
    # float32, in any order, so there kernel and plain version must agree
    # exactly — every row must land in its (node, feature, bin).
    gh_exact = torch.stack([
        torch.randint(-8, 9, (n,), device=dev, generator=gen) / 4,
        torch.randint(0, 5, (n,), device=dev, generator=gen) / 4,
    ], dim=1).contiguous()
    for n_nodes in HIST_NODES:
        pos = torch.randint(0, n_nodes + 1, (n,), device=dev, generator=gen,
                            dtype=torch.int32)
        args = (packed, gh_exact, pos, n_nodes, 256, bits)
        count = ref.histogram_ref(packed, ones, pos, n_nodes, 256, bits)[..., :1]
        if float(count.max()) * 2 * 4 >= 2**24:
            raise SystemExit("rows per bin too many for the exact histogram check")
        exact_err = float((build_histograms_packed_kernel(*args)
                           - ref.histogram_ref(*args)).abs().max())
        if exact_err != 0.0:
            raise SystemExit(f"histogram kernel misplaces rows at n_nodes={n_nodes}: "
                             f"{exact_err}")
        # Real-valued (g, h): atomics add in no fixed order. Summing k terms
        # in two arbitrary orders differs by about sqrt(k) * 2^-24 * sum|x|;
        # the tolerance is four times that, per bin.
        got = build_histograms_packed_kernel(packed, gh, pos, n_nodes, 256, bits)
        want = ref.histogram_ref(packed, gh, pos, n_nodes, 256, bits)
        mag = ref.histogram_ref(packed, gh.abs(), pos, n_nodes, 256, bits)
        err, ok = check(got, want, 2e-5 + 4 * count.sqrt() * 2**-24 * mag)
        levels.append({"n_nodes": n_nodes, "exact_max_abs_err": exact_err,
                       "max_abs_err": err, "ok": ok, "pos": pos})
        if not ok:
            raise SystemExit(f"histogram kernel disagrees at n_nodes={n_nodes}: {err}")
        hist32 = got

    parent = hist32[:, 0].sum(dim=1)  # (32, 2) node sums over feature 0's bins
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
    got = quantile_cuts_from_sorted(srt, n_valid, 256)
    want = ref.quantile_cuts_ref(srt, n_valid, 256)
    if not torch.equal(torch.isfinite(got), torch.isfinite(want)):
        raise SystemExit("quantile_cuts kernel: +inf pattern differs")
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max())
    results["quantile_cuts"] = {"max_abs_err": err, "tolerance": "exact"}
    if err != 0.0:
        raise SystemExit(f"quantile_cuts kernel disagrees: {err}")

    ens = bst.ensemble
    xte = torch.as_tensor(x_te, device=dev)
    targs = (ens.feature, ens.threshold, ens.default_left, ens.leaf_value,
             ens.is_leaf, xte, ens.n_classes, 6)
    got = ensemble_margins_kernel(*targs)
    want = ref.ensemble_margins_ref(*targs)
    err, ok = check(got, want, 1e-5)
    results["ensemble_traversal"] = {"max_abs_err": err, "tolerance": "1e-5"}
    if not ok:
        raise SystemExit(f"ensemble_traversal kernel disagrees: {err}")
    results["histogram"] = {
        "max_abs_err": max(lv["max_abs_err"] for lv in levels),
        "tolerance": "dyadic gh exact; real gh 2e-5 + 4*sqrt(rows)*2^-24*hist(|g|,|h|)",
    }
    emit({"phase": "check", **{k: v for k, v in results.items()},
          "histogram_levels": [{k: v for k, v in lv.items() if k != "pos"}
                               for lv in levels]})

    # --- 5. times -------------------------------------------------------------
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

    def bound(nbytes: float, nops: float) -> tuple[float, str]:
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    w = packed.shape[1]
    hist_rows = []
    for lv in levels:
        nn, pos = lv["n_nodes"], lv["pos"]
        active = int((pos < nn).sum())
        flat_idx = (pos.to(torch.int64).clamp(max=nn)[:, None] * f
                    + torch.arange(f, device=dev)[None, :]) * 256 \
            + unpack(packed, bits, n).to(torch.int64)
        flat_idx = flat_idx.reshape(-1, 1).expand(-1, 2)
        src = gh[:, None, :].expand(n, f, 2).reshape(-1, 2)
        lib_out = torch.zeros(((nn + 1) * f * 256, 2), device=dev)
        b_ms, b_by = bound(f * w * 4 + n * 8 + n * 4 + nn * f * 256 * 8,
                           2 * active * f)
        hist_rows.append({
            "n_nodes": nn,
            "ms": time_ms(lambda: build_histograms_packed_kernel(packed, gh, pos, nn, 256, bits)),
            "plain_ms": time_ms(lambda: ref.histogram_ref(packed, gh, pos, nn, 256, bits), iters=5),
            "library_ms": time_ms(lambda: lib_out.scatter_add_(0, flat_idx, src), iters=5),
            "bound_ms": b_ms, "bound_by": b_by,
        })
        del flat_idx, src, lib_out
    emit({"phase": "time", "histogram_levels": hist_rows})

    n_nodes, nf, nb = hist32.shape[:3]
    nvb_cuts = 254
    t_trees, arena = ens.feature.shape
    times = {
        "histogram": {k: hist_rows[-1][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "split_scan": {
            "ms": time_ms(lambda: split_scan(hist32, parent, 1.0, 1.0)),
            "plain_ms": time_ms(lambda: ref.split_scan_ref(hist32, parent, 1.0, 1.0), iters=5),
            "library_ms": None,
        },
        "quantile_cuts": {
            "ms": time_ms(lambda: quantile_cuts_from_sorted(srt, n_valid, 256)),
            "plain_ms": time_ms(lambda: ref.quantile_cuts_ref(srt, n_valid, 256), iters=5),
            "library_ms": None,
        },
        "ensemble_traversal": {
            "ms": time_ms(lambda: ensemble_margins_kernel(*targs)),
            "plain_ms": time_ms(lambda: ref.ensemble_margins_ref(*targs), iters=5),
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

    kernels = []
    for name in REPLACES:
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
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
