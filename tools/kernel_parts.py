"""Time the parts of the privatised histogram's and the split scan's designs.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 tools/kernel_parts.py --parent DIR [--rows N]

DIR is a checkout of an earlier commit to compare with, whose
`kernels/csrc/histogram.cu` exports `rt_histogram_private` without the
blocks-per-SM argument and whose `split_scan.cu` exports `rt_split_scan`.
Prints one JSON line per measurement:

* `histogram`: on the training words of the Higgs-shaped data and on a copy
  with 80% of the symbols in the missing bin, at 1, 8 and 32 nodes, the mean
  ms (L2 flushed before each of 20 launches, the variants interleaved) of
  the earlier kernel under its plan (3 blocks per SM), the shipped kernel
  through the library (its int64 accumulator zeroed, the kernel, the
  conversion pass: what its wrapper launches), and `tools/kernel_parts.cu`'s
  copies of its float-atomic loop (the design before the fixed point) with
  one part of the design at a time, under the shipped plan:
  `float` (two float atomicAdds a symbol), `float_lockstep`,
  `float_lockstep_match`, `pair_cas`, `pair_cas_lockstep`, and
  `pair_cas_lockstep_match` (the shipped body). Each is first checked exact
  against the plain version on integer (g, h).
* `split_scan`: at 1, 8 and 32 nodes x 28 features x 256 bins, device us a
  launch of 200 launches queued back to back behind a sleeping kernel, for
  the earlier kernel, the shipped one, the shipped one without lane 0's
  prefix sums and without the scoring of thresholds, and an empty launch.
"""
from __future__ import annotations

import argparse
import ctypes
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
    BIN_BYTES,
    PRIVATE_BLOCKS_PER_SM,
    THREADS,
    dequantise_kernel,
    launch_plan,
)

MAX_BINS = 256
NODES = (1, 8, 32)
SKEW = 0.8
EARLIER_BLOCKS_PER_SM = 3  # the earlier kernel's plan
PARTS = {"float": 0, "pair_cas": 1, "float_lockstep": 4, "pair_cas_lockstep": 5,
         "float_lockstep_match": 6, "pair_cas_lockstep_match": 7}
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def shared_library(sources: list[Path], name: str) -> ctypes.CDLL:
    out = ROOT / "build" / "kernel_parts"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"{name}.so"
    done = subprocess.run([KB._nvcc(), *KB.NVCC_FLAGS, "-shared", "-o", str(lib),
                           *map(str, sources)], capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(lib))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_parts needs an NVIDIA card")

    csrc = args.parent / "src" / "repro_torch" / "kernels" / "csrc"
    earlier = shared_library([csrc / "histogram.cu", csrc / "split_scan.cu"], "earlier")
    parts = shared_library([ROOT / "tools" / "kernel_parts.cu"], "parts")
    earlier.rt_histogram_private.argtypes = [P] * 4 + [I] * 10 + [P]
    earlier.rt_split_scan.argtypes = [P, P, P, I, I, I, F, F, P]
    parts.parts_histogram.argtypes = [I, I] + [P] * 4 + [I] * 8 + [P]
    parts.parts_split_scan.argtypes = [I, P, P, P, I, I, I, F, F, P]
    lib = KB.lib()

    dev = torch.device("cuda", 0)
    stream = KB.stream(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x, y, _ = make_dataset("higgs", args.rows, seed=args.seed)
    dm = DeviceDMatrix(x, label=y, max_bins=MAX_BINS)
    del x, y
    packed, bits, n = dm.matrix.packed, dm.bits, dm.n_rows
    if bits != 8:
        raise SystemExit(f"kernel_parts times 8-bit symbols, got {bits}")
    f, w = packed.shape
    dense = unpack(packed, bits, n)
    words = {"higgs": packed,
             "skewed": pack(torch.where(torch.rand(dense.shape, device=dev, generator=gen) < SKEW,
                                        MAX_BINS - 1, dense), bits)}
    del dense
    gh = torch.stack([torch.randn(n, device=dev, generator=gen),
                      torch.rand(n, device=dev, generator=gen)], 1).contiguous()
    gh_exact = torch.stack([torch.randint(-1, 2, (n,), device=dev, generator=gen).float(),
                            torch.ones(n, device=dev)], 1).contiguous()
    flush = torch.empty(128 << 18, device=dev)
    limits = KB.device_limits(0)
    exps = {gh.data_ptr(): FX.exponent(gh), gh_exact.data_ptr(): FX.exponent(gh_exact)}
    acc = torch.zeros((max(NODES), f, MAX_BINS, 2), dtype=torch.int64, device=dev)

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

    print(json.dumps({"device": torch.cuda.get_device_name(0), "rows": n,
                      "shipped_blocks_per_sm": PRIVATE_BLOCKS_PER_SM}), flush=True)
    for data, wd in words.items():
        for nn in NODES:
            pos = torch.randint(0, nn, (n,), device=dev, generator=gen, dtype=torch.int32)
            pos = torch.where(torch.rand(n, device=dev, generator=gen) < 0.05, nn, pos)
            pos = pos.to(torch.int32).contiguous()
            plan = launch_plan(w, f, nn, MAX_BINS, limits, PRIVATE_BLOCKS_PER_SM, BIN_BYTES)
            # the float-atomic copies' plan: 8 bytes a bin
            float_plan = launch_plan(w, f, nn, MAX_BINS, limits, PRIVATE_BLOCKS_PER_SM)
            old = launch_plan(w, f, nn, MAX_BINS, limits, EARLIER_BLOCKS_PER_SM)
            ptrs = (wd.data_ptr(),)

            def run(kind, g, o):
                if kind == "earlier":
                    return earlier.rt_histogram_private(
                        *ptrs, g.data_ptr(), pos.data_ptr(), o.data_ptr(), n, f, w, nn,
                        MAX_BINS, bits, old.node_tile, old.feat_group, old.words_per_block,
                        THREADS, stream)
                if kind == "shipped":
                    a = acc[:nn].zero_()
                    err = lib.rt_histogram_private(
                        *ptrs, g.data_ptr(), pos.data_ptr(), a.data_ptr(),
                        exps[g.data_ptr()].data_ptr(), n, f, w, nn, MAX_BINS, bits,
                        plan.node_tile, plan.feat_group, plan.words_per_block,
                        plan.blocks_per_sm, THREADS, 0, 0, stream)
                    o.copy_(dequantise_kernel(a, exps[g.data_ptr()]))
                    return err
                return parts.parts_histogram(
                    PARTS[kind], float_plan.blocks_per_sm, *ptrs, g.data_ptr(),
                    pos.data_ptr(), o.data_ptr(), n, f, w, nn, MAX_BINS,
                    float_plan.node_tile, float_plan.feat_group,
                    float_plan.words_per_block, stream)

            kinds = ["earlier", "shipped", *PARTS]
            want = ref.histogram_ref(wd, gh_exact, pos, nn, MAX_BINS, bits)
            out = torch.zeros((nn, f, MAX_BINS, 2), device=dev)
            for kind in kinds:
                out.zero_()
                KB.check(run(kind, gh_exact, out), kind)
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise SystemExit(f"{kind} disagrees with the plain version at {nn} nodes "
                                     f"on the {data} words")
            times = {k: [] for k in kinds}
            for kind in kinds + kinds[::-1]:
                times[kind] += mean_ms(lambda: run(kind, gh, out))
            print(json.dumps({"histogram": data, "n_nodes": nn,
                              "plan": [plan.node_tile, plan.feat_group, plan.smem_bytes,
                                       plan.blocks_per_sm],
                              "ms": {k: statistics.mean(v) for k, v in times.items()}}),
                  flush=True)

    for nn in NODES:
        pos = torch.randint(0, nn, (n,), device=dev, generator=gen, dtype=torch.int32)
        hist = ref.histogram_ref(words["higgs"], gh, pos, nn, MAX_BINS, bits).contiguous()
        parent = hist[:, 0].sum(dim=1).contiguous()
        want = ref.split_scan_ref(hist, parent, 1.0, 1.0)
        out = torch.empty((nn, f, 5), device=dev)
        args_ = (hist.data_ptr(), parent.data_ptr(), out.data_ptr(), nn, f, MAX_BINS, 1.0, 1.0,
                 stream)
        kinds = {"earlier": lambda: earlier.rt_split_scan(*args_),
                 "shipped": lambda: lib.rt_split_scan(*args_),
                 "without_prefix_sums": lambda: parts.parts_split_scan(1, *args_),
                 "without_scoring": lambda: parts.parts_split_scan(2, *args_),
                 "empty_launch": lambda: lib.rt_empty_launch(stream)}
        for kind in ("earlier", "shipped"):
            out.zero_()
            KB.check(kinds[kind](), kind)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise SystemExit(f"split scan {kind} is not bit-identical at {nn} nodes")
        us = {k: [] for k in kinds}
        for kind in list(kinds) + list(kinds)[::-1]:
            us[kind].append(back_to_back_us(kinds[kind]))
        print(json.dumps({"split_scan": [nn, f, MAX_BINS],
                          "us_per_launch": {k: statistics.mean(v) for k, v in us.items()}}),
              flush=True)
    print(json.dumps({"nvidia_smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
