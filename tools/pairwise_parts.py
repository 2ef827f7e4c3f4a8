"""Time the parts of the pairwise-gradient kernel's design beside an earlier one.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 tools/pairwise_parts.py --parent DIR [--seed S]

DIR is a checkout of an earlier commit whose `kernels/csrc/pairwise.cu`
exports `rt_pairwise_grad(scores, labels, order, start, end, gh, n, stream)`
(one thread a sorted position). The earlier source, and
`tools/pairwise_parts.cu` (this tree's `pairwise.cu` with other tile bodies
and splits, `parts_pairwise`), are each built by `nvcc` into a library of
their own and loaded with ctypes beside the shipped kernel.

Prints one JSON line per input: an MSLR-WEB10K-shaped grouping (chip_smoke's
rank data from the seed, scores standard normal) and each of chip_smoke's
PAIR_GROUPS. For each kernel: `b2b_ms`, the device ms a call of 20 calls
queued behind a sleeping kernel (inputs in L2), the median of three rounds in
which the kernels take turns (earlier, shipped, parts..., and back), and
`event_ms`, one call between CUDA events with L2 flushed (mean of 10).
Kernels: `earlier`; `shipped` (through `pairwise_grad`); the parts of
`pairwise_parts.cu`: `warp_two_tiles` (a query of up to 2 tiles on its
window's warp alone), `warp_each` (every query of up to 256 rows one
warp's), `butterfly` (xor columns summed by shuffle stages), `float64_sums`
(every term added in double), `staging_alone` (both kernels with tiles
that compute nothing), `ieee_division` (the sigmoid's reciprocal by an IEEE
division with its slow-path branch), `one_chain` (one shuffle chain a
warp), `spread_chunks_128` (spread tasks of 128-row chunks), `fast_sigmoid`
(`__expf` and `__fdividef`), and the query
kernel alone (`query_kernel_*`: shipped, `warp_two_tiles`, staging alone,
`one_chain`; its spread queries' rows left unwritten). Each is first
held to the plain version within 2e-6 * (1 + the row's summed term
magnitudes) (`staging_alone`, `fast_sigmoid` and the query kernel alone
excepted: their errors are only reported, over 2e-6 where they miss), and
the shipped kernel also to itself across two calls, bit for bit. Beside them the inputs' pairs and pairs whose
labels differ, and the bound of the latter's exp and reciprocal at the
special-function units' rate.
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
import repro_torch.core  # noqa: E402,F401
from repro_torch.kernels import build as KB, ops, ref  # noqa: E402
from repro_torch.kernels.pairwise import pairwise_grad, scratch  # noqa: E402

PARTS = {"warp_two_tiles": 1, "warp_each": 2, "butterfly": 3, "float64_sums": 4,
         "staging_alone": 5, "ieee_division": 6, "one_chain": 7, "spread_chunks_128": 12,
         "fast_sigmoid": 13}
# The query kernel alone: its rows of spread queries are left unwritten.
QUERY_ONLY = {"query_kernel_alone": 8, "query_kernel_alone_warp_two_tiles": 9,
              "query_kernel_staging_alone": 10, "query_kernel_alone_one_chain": 11}
P, I = ctypes.c_void_p, ctypes.c_int


def shared_library(source: Path, name: str) -> ctypes.CDLL:
    out = ROOT / "build" / "pairwise_parts"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"{name}.so"
    done = subprocess.run([KB._nvcc(), *KB.NVCC_FLAGS, "-shared", "-o", str(lib), str(source)],
                          capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{done.stdout}{done.stderr}")
    print(json.dumps({"build": name, "ptxas": CS.ptxas_summary(done.stdout + done.stderr)}),
          flush=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("pairwise_parts needs an NVIDIA card")
    earlier = shared_library(
        args.parent / "src" / "repro_torch" / "kernels" / "csrc" / "pairwise.cu", "earlier")
    parts = shared_library(ROOT / "tools" / "pairwise_parts.cu", "parts")
    earlier.rt_pairwise_grad.argtypes = [P] * 6 + [I, P]
    parts.parts_pairwise.argtypes = [I] + [P] * 7 + [I, P]
    dev = torch.device("cuda", 0)
    stream = KB.stream(dev)
    flush = torch.empty(128 << 18, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": CS.nvidia_smi()}),
          flush=True)

    rng = np.random.default_rng(args.seed + 1)
    signal = (rng.normal(size=CS.RANK_FEATURES) * (np.arange(CS.RANK_FEATURES) < 24)
              / np.sqrt(24)).astype(np.float32)
    _, rel, qid, _, _ = CS.mslr_shaped(rng, CS.RANK_QUERIES, CS.RANK_ROWS, 0, signal, None)
    inputs = {"rank": (torch.randn(len(rel), device=dev, generator=gen),
                       torch.from_numpy(rel).to(dev), torch.from_numpy(qid).to(dev))}
    for name, size, rows in CS.PAIR_GROUPS:
        ids = torch.arange(rows, device=dev, dtype=torch.int32) // size
        inputs[name] = (torch.randn(rows, device=dev, generator=gen) * 2,
                        torch.randint(0, 5, (rows,), device=dev, generator=gen).float(),
                        ids[torch.randperm(rows, device=dev, generator=gen)] * 3 + 1)

    for name, (sc, lab, ids) in inputs.items():
        grouping = ops.query_groups(ids)
        n = sc.shape[0]
        out = torch.empty((n, 2), device=dev)
        work = scratch(n, dev)
        ptrs = (sc.data_ptr(), lab.data_ptr(), *(t.data_ptr() for t in grouping))

        def run(kind):
            if kind == "earlier":
                KB.check(earlier.rt_pairwise_grad(*ptrs, out.data_ptr(), n, stream), kind)
            elif kind == "shipped":
                pairwise_grad(sc, lab, *grouping)
            else:
                KB.check(parts.parts_pairwise({**PARTS, **QUERY_ONLY}[kind], *ptrs, out.data_ptr(),
                                              work.data_ptr(), n, stream), kind)

        terms = ref.pairwise_terms_ref(sc, lab, *grouping)
        want = ref.pairwise_grad_ref(sc, lab, *grouping)
        bound = 2e-6 * (1 + torch.stack([terms[:, 0] + terms[:, 1], terms[:, 2]], dim=1))
        kinds = ["earlier", "shipped", *PARTS, *QUERY_ONLY]
        errs = {}
        for kind in kinds:
            if kind == "shipped":
                got = pairwise_grad(sc, lab, *grouping)
                if not torch.equal(got, pairwise_grad(sc, lab, *grouping)):
                    raise SystemExit(f"shipped kernel differs between two calls on {name}")
            else:
                run(kind)
                torch.cuda.synchronize()
                got = out
            errs[kind] = float(((got - want).abs() / bound).max()) * 2e-6
            if kind not in ("staging_alone", "fast_sigmoid", *QUERY_ONLY) and not bool(
                    ((got - want).abs() <= bound).all()):
                raise SystemExit(f"{kind} disagrees with the plain version on {name}")
        del terms, want, bound

        def back_to_back(kind, launches=20) -> float:
            run(kind)
            torch.cuda.synchronize()
            torch.cuda._sleep(50_000_000)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(launches):
                run(kind)
            e.record()
            torch.cuda.synchronize()
            return s.elapsed_time(e) / launches

        def event_ms(kind, iters=10) -> float:
            total = 0.0
            for _ in range(iters):
                flush.zero_()
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                run(kind)
                e.record()
                torch.cuda.synchronize()
                total += s.elapsed_time(e)
            return total / iters

        b2b = {k: [] for k in kinds}
        for _ in range(3):
            for kind in kinds + kinds[::-1]:
                b2b[kind].append(back_to_back(kind))
        sizes = torch.bincount(grouping[2] - grouping[1]).cpu().numpy()  # rows: size a row
        lab_np, ids_np = lab.cpu().numpy().astype(np.int64), ids.cpu().numpy()
        pairs, differ = CS.pair_counts(lab_np, ids_np)
        print(json.dumps({
            "input": name, "rows": n, "pairs": pairs, "pairs_labels_differ": differ,
            "largest_query": int(np.nonzero(sizes)[0].max()),
            "sfu_bound_ms": 2 * differ / CS.SFU_OPS_PER_S * 1e3,
            "b2b_ms": {k: statistics.median(v) for k, v in b2b.items()},
            "event_ms": {k: event_ms(k) for k in kinds},
            "max_err_over_1_plus_terms": errs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
