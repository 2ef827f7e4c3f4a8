"""Time `histogram_packed`'s cluster kernel against a parent tree's
kernel, its own other plans and a variant, in one process on one card.

Run from the root of a checkout on a machine with an NVIDIA card:

    git archive <parent> | tar -x -C build/parent
    python3 tools/packed_parts.py --parent build/parent [--rows N]

On the Higgs-shaped training words (1M rows x 28 features, 8 bits, 256
bins, from --seed) and on a copy with 80% of the symbols in the missing
bin, at 1, 8 and 32 nodes (positions as `chip_smoke.py` makes them, 5%
at -1 and a share at n_nodes), each of these calls is first checked
`torch.equal` to `ref.histogram_packed_fixed_ref` and then timed by
events (the L2 flushed before each of 20 launches) and back to back (100
launches queued behind a sleeping kernel), with `chip_smoke.py`'s timers,
in turns: every call, then every call in reverse.

* `parent`: the parent's `histogram_packed` as its wrapper makes it: the
  exponent kernel zeroing the int64 accumulator, the parent's kernel (its
  `kernels/csrc/histogram.cu` built into its own library), the conversion
  pass;
* `tree`: this tree's wrapper (the exponent, the cluster kernel under
  `packed_plan`);
* `plan_<feat_group>x<cluster>`: this tree's kernel under another
  feature group and cluster size (every portable cluster size, and the
  feature groups 1, 2 and 4 where they fit);
* the designs of `tools/packed_parts.cu` under the shipped plan:
  `any_bin` (16-byte (g, h) pairs of int64, the missing bin added as any
  bin), `subtract` (the same pairs, the missing bin by the block's node
  totals, summed in one row by warp-aggregated runs, less its other bins),
  `subtract_warp` (the same with each warp's totals in its own row) and
  `planar` (the shipped planes of 32-bit words, the missing bin added as
  any bin);
* `private`: #1 through its wrapper, the yardstick of a tuned design of
  the same contract; `scatter_add`: one `scatter_add_` of the same
  function (as `chip_smoke.py` times it).

Also prints ptxas' registers and spills of every cluster kernel instance
beside the parent's `histogram_global_kernel`, the card's clusters for
each plan (`cudaOccupancyMaxActiveClusters`), one JSON line per
measurement, and the card's name and power limit.
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
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import back_to_back_ms, nvidia_smi, ptxas_summary, time_ms  # noqa: E402
from repro_torch.core import DeviceDMatrix  # noqa: E402
from repro_torch.core.compress import pack, unpack  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.kernels import build as KB, ref  # noqa: E402
from repro_torch.kernels.histogram import (  # noqa: E402
    CLUSTER_SIZES,
    PackedPlan,
    build_histograms_packed_kernel,
    fixed_exponent,
    histogram_packed,
    occupancy,
    packed_bytes,
    packed_plan,
)

MAX_BINS = 256
NODES = (1, 8, 32)
SKEW = 0.8
VARIANTS = ("any_bin", "subtract", "subtract_warp", "planar")  # packed_parts.cu's
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def shared_library(source: Path, name: str) -> tuple[ctypes.CDLL, str]:
    """`source` built with the port's nvcc flags into its own library, and
    ptxas' report of it."""
    out = ROOT / "build" / "packed_parts"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"{name}.so"
    done = subprocess.run([KB._nvcc(), *KB.NVCC_FLAGS, "-shared", "-o", str(lib), str(source)],
                          capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(lib)), done.stdout + done.stderr


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("packed_parts needs an NVIDIA card")

    parent, parent_report = shared_library(
        args.parent / "src" / "repro_torch" / "kernels" / "csrc" / "histogram.cu", "parent")
    parent.rt_histogram_packed.argtypes = [P] * 5 + [I] * 7 + [P]
    parent.rt_fixed_exponent.argtypes = [P, I, P, P, L, P]
    parent.rt_histogram_dequantise.argtypes = [P] * 3 + [L, I, P]
    variant, _ = shared_library(ROOT / "tools" / "packed_parts.cu", "packed_parts")
    for name in VARIANTS:
        getattr(variant, f"parts_histogram_packed_{name}").argtypes = [P] * 5 + [I] * 11 + [P]
    lib, info = KB.library()
    print(json.dumps({"ptxas": [r for r in ptxas_summary(info.ptxas)
                                if r["function"].startswith("histogram_cluster_kernel")],
                      "parent_ptxas": [r for r in ptxas_summary(parent_report)
                                       if r["function"].startswith("histogram_global_kernel")]}),
          flush=True)

    dev = torch.device("cuda", 0)
    stream = KB.stream(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x, y, _ = make_dataset("higgs", args.rows, seed=args.seed)
    dm = DeviceDMatrix(x, label=y, max_bins=MAX_BINS)
    del x, y
    packed, bits, n = dm.matrix.packed, dm.bits, dm.n_rows
    f, w = packed.shape
    dense = unpack(packed, bits, n)
    words = {"higgs": (packed, dense)}
    skewed = torch.where(torch.rand(dense.shape, device=dev, generator=gen) < SKEW,
                         MAX_BINS - 1, dense)
    words["skewed"] = (pack(skewed, bits), skewed)
    gh = torch.stack([torch.randn(n, device=dev, generator=gen),
                      torch.rand(n, device=dev, generator=gen)], 1).contiguous()
    flush = torch.empty(128 << 18, device=dev)
    limits = KB.device_limits(0)

    def parent_call(words_, pos, nn):
        def run():
            acc = torch.empty((nn, f, MAX_BINS, 2), dtype=torch.int64, device=dev)
            k = torch.empty((), dtype=torch.int32, device=dev)
            KB.check(parent.rt_fixed_exponent(gh.data_ptr(), n, k.data_ptr(), acc.data_ptr(),
                                              acc.numel(), stream), "parent exponent")
            KB.check(parent.rt_histogram_packed(
                words_.data_ptr(), gh.data_ptr(), pos.data_ptr(), acc.data_ptr(),
                k.data_ptr(), n, f, w, nn, MAX_BINS, bits, 512, stream), "parent")
            out = torch.empty(acc.shape, dtype=torch.float32, device=dev)
            KB.check(parent.rt_histogram_dequantise(acc.data_ptr(), k.data_ptr(),
                                                    out.data_ptr(), acc.numel(), 256, stream),
                     "parent dequantise")
            return out
        return run

    def plan_call(entry, words_, pos, nn, plan: PackedPlan):
        """This tree's exponent, then `entry` under `plan` (not counted)."""
        def run():
            out = torch.empty((nn, f, MAX_BINS, 2), dtype=torch.float32, device=dev)
            k = fixed_exponent(gh)
            KB.check(entry(words_.data_ptr(), gh.data_ptr(), pos.data_ptr(), out.data_ptr(),
                           k.data_ptr(), n, f, w, nn, MAX_BINS, bits, plan.node_tile,
                           plan.feat_group, plan.cluster, plan.words_per_block,
                           plan.threads, stream), "cluster kernel")
            return out
        return run

    def library_scatter(bins_rows, pos, nn):
        pos = pos.to(torch.int64)
        pos = torch.where((pos >= 0) & (pos < nn), pos, nn)
        idx = (pos[:, None] * f + torch.arange(f, device=dev)[None, :]) * MAX_BINS \
            + bins_rows.to(torch.int64)
        idx = idx.reshape(-1, 1).expand(-1, 2)
        src = gh[:, None, :].expand(-1, f, 2).reshape(-1, 2)
        out = torch.zeros(((nn + 1) * f * MAX_BINS, 2), device=dev)
        return lambda: out.scatter_add_(0, idx, src)

    print(json.dumps({"device": torch.cuda.get_device_name(0), "rows": n, "features": f,
                      "bits": bits}), flush=True)
    for data, (wd, bins_rows) in words.items():
        for nn in NODES:
            pos = torch.randint(0, nn + 1, (n,), device=dev, generator=gen, dtype=torch.int32)
            pos = torch.where(torch.rand(n, device=dev, generator=gen) < 0.05, -1, pos)
            pos = pos.to(torch.int32).contiguous()
            shipped = packed_plan(w, f, nn, MAX_BINS, bits, limits)
            plans = {"tree": shipped}
            for fg in (1, 2, 4):
                smem = packed_bytes(fg, shipped.node_tile, MAX_BINS, shipped.threads)
                if smem > limits.smem_block:
                    continue
                for c in CLUSTER_SIZES:
                    plans[f"plan_{fg}x{c}"] = shipped._replace(
                        feat_group=fg, cluster=c, words_per_block=-(-w // c), smem_bytes=smem)
            calls = {"parent": parent_call(wd, pos, nn),
                     "tree": lambda wd=wd, pos=pos, nn=nn: histogram_packed(
                         wd, gh, pos, nn, MAX_BINS, bits)}
            calls.update({k: plan_call(lib.rt_histogram_packed, wd, pos, nn, p)
                          for k, p in plans.items() if k != "tree"})
            for name in VARIANTS:
                calls[name] = plan_call(getattr(variant, f"parts_histogram_packed_{name}"), wd,
                                        pos, nn, shipped)
            calls["private"] = lambda wd=wd, pos=pos, nn=nn: build_histograms_packed_kernel(
                wd, gh, pos, nn, MAX_BINS, bits)
            want = ref.histogram_packed_fixed_ref(wd, gh, pos, nn, MAX_BINS, bits)
            for kind, call in calls.items():
                got = call()
                torch.cuda.synchronize()  # a fault shows at its own variant
                if not torch.equal(got, want):
                    raise SystemExit(f"{kind} is not the fixed-point plain version's bits: "
                                     f"{data}, {nn} nodes")
            del want
            calls["scatter_add"] = library_scatter(bins_rows, pos, nn)
            ev = {k: [] for k in calls}
            b2b = {k: [] for k in calls}
            for kind in list(calls) + list(calls)[::-1]:
                ev[kind].append(time_ms(calls[kind], dev, flush))
                b2b[kind].append(back_to_back_ms(calls[kind], dev))
            print(json.dumps({
                "data": data, "n_nodes": nn,
                "plans": {k: list(p) for k, p in plans.items()},
                "clusters_occupancy": {k: occupancy("packed", p, bits, clusters=True)
                                       for k, p in plans.items()},
                "events_ms": {k: statistics.mean(v) for k, v in ev.items()},
                "events_turns_ms": ev,
                "back_to_back_ms": {k: statistics.mean(v) for k, v in b2b.items()}}),
                flush=True)
    print(json.dumps({"nvidia_smi": nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
