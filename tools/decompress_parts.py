"""Time the decompress kernel beside an earlier commit's, in one process, and
under the designs the port does not ship.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 tools/decompress_parts.py --parent DIR [--seed S]

DIR is a checkout of an earlier commit whose `kernels/csrc/decompress.cu`
exports `rt_decompress(packed, out, n_rows, F, W, bits, threads, stream)`.
The earlier commit's own `kernels/build.py` builds its library (into
DIR/build), loaded beside this checkout's, beside `tools/decompress_parts.cu`
and beside copies of this checkout's `csrc/decompress.cu` with one tile
constant changed (SWEEP). Random int32 words are made on the card for each
shape (any words are valid input: each field is masked).

For each shape, one JSON line `decompress` with, in ms:

* `ms`: the mean of 20 launches, the L2 flushed before each, of the earlier
  kernel (`earlier`), the earlier body with 32-bit index math (`i32`), the
  shipped design through the library (`shipped`), the shipped tile on a
  persistent, double-buffered grid (`persistent`), the shipped design with
  plain stores (`plain_stores`) and with the output written by bulk copies
  from shared memory (`bulk_store`), each SWEEP copy, and `copy_` of a
  tensor whose read and write bytes together equal the kernel's (`copy`):
  what the card reaches on the same traffic. The kinds run in turns, then
  again in the reverse order; each mean is over both.
* `back_to_back_ms`: device time a launch of 50 launches queued behind a
  sleeping kernel (inputs partly in L2), for the same kinds.
* `bound_ms`: bytes (words read once, 4 bytes written a (row, feature)) over
  3.35 TB/s.

Every kind is first checked bit for bit against the shipped wrapper, and
the wrapper against the plain version on word-aligned slices of the rows.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build as KB, ref  # noqa: E402
from repro_torch.kernels.decompress import decompress  # noqa: E402

from kernel_parts import shared_library  # noqa: E402
from traversal_parts import earlier_module  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
# (name, rows, features, bits): the main shape (Higgs-shaped, 1M rows), its
# other widths, the Bosch-shaped matrix, the paper's 11M-row Higgs run, and
# 33 features (one past a 32-feature tile).
SHAPES = (("main", 1_000_000, 28, 8), ("bits_4", 1_000_000, 28, 4),
          ("bits_9", 1_000_000, 28, 9), ("bits_32", 1_000_000, 28, 32),
          ("bosch", 1_183_747, 968, 8), ("higgs_11m", 11_000_000, 28, 8),
          ("features_33", 1_000_000, 33, 8))
PARTS = {"i32": "rt_parts_decompress_i32", "persistent": "rt_parts_decompress_persistent",
         "plain_stores": "rt_parts_decompress_plain", "bulk_store": "rt_parts_decompress_bulk"}
# Copies of the shipped source with one constant changed: 64-word tiles,
# 32-feature tiles (so F = 33 takes a feature tile of 1), 512 threads.
SWEEP = {"tile_words_64": ("TILE_WORDS", 64), "feat_tile_32": ("FEAT_TILE", 32),
         "threads_512": ("THREADS", 512)}
CHECK_ELEMENTS = 1 << 26  # output elements a slice of the plain version's check
P, I = ctypes.c_void_p, ctypes.c_int


def random_words(f: int, w: int, gen: torch.Generator) -> torch.Tensor:
    return torch.randint(-2**31, 2**31, (f, w), dtype=torch.int32, device="cuda",
                         generator=gen)


def check_plain(words: torch.Tensor, bits: int, n: int, got: torch.Tensor) -> None:
    """`got` against the plain version, on word-aligned slices of the rows."""
    spw = 32 // bits
    step = max(1, CHECK_ELEMENTS // words.shape[0] // spw) * spw
    r0 = 0
    while r0 < n:
        r1 = min(n, r0 + step)
        want = ref.decompress_ref(words[:, r0 // spw:-(-r1 // spw)], bits, r1 - r0)
        if not torch.equal(got[r0:r1], want):
            raise SystemExit(f"decompress differs from the plain version in rows {r0}-{r1}")
        r0 = r1


def sweep_libraries() -> dict[str, ctypes.CDLL]:
    """The SWEEP copies of `csrc/decompress.cu`, each built into its own
    library (all nvcc processes started together)."""
    src = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "decompress.cu").read_text()
    out = ROOT / "build" / "kernel_parts"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (const, value) in SWEEP.items():
        pattern = rf"constexpr int {const} = \d+;"
        if not re.search(pattern, src):
            raise SystemExit(f"csrc/decompress.cu has no {const}")
        cu = out / f"decompress_{name}.cu"
        cu.write_text(re.sub(pattern, f"constexpr int {const} = {value};", src))
        procs[name] = subprocess.Popen(
            [KB._nvcc(), *KB.NVCC_FLAGS, "-shared", "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {name} copy:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"decompress_{name}.so"))
        libs[name].rt_decompress.argtypes = [P, P, I, I, I, I, P]
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decompress_parts needs an NVIDIA card")
    earlier = earlier_module(args.parent, "build").lib()
    lib = KB.lib()
    parts = shared_library([ROOT / "tools" / "decompress_parts.cu"], "decompress_parts")
    for entry in PARTS.values():
        getattr(parts, entry).argtypes = [P, P, I, I, I, I, P]
    calls = {"earlier": lambda *a: earlier.rt_decompress(*a[:-1], 256, a[-1]),
             "shipped": lib.rt_decompress,
             **{kind: getattr(parts, entry) for kind, entry in PARTS.items()},
             **{kind: swept.rt_decompress for kind, swept in sweep_libraries().items()}}
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    flush = torch.empty(128 << 18, device=dev)

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

    def back_to_back_ms(fn, launches=50) -> float:
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

    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    for name, n, f, bits in SHAPES:
        spw = 32 // bits
        w = -(-n // spw)
        words = random_words(f, w, gen)
        out = torch.empty((n, f), dtype=torch.int32, device=dev)  # every kind's

        def runner(kind):
            return lambda: KB.check(calls[kind](words.data_ptr(), out.data_ptr(), n, f, w,
                                                bits, stream), f"decompress {kind}")

        kinds = {k: runner(k) for k in calls}
        got = decompress(words, bits, n)
        check_plain(words, bits, n, got)
        for kind, fn in kinds.items():
            out.fill_(-1)
            fn()
            if not torch.equal(out, got):
                raise SystemExit(f"decompress {kind} differs from the wrapper at {name}")
        del got
        nbytes = f * w * 4 + n * f * 4
        half = torch.empty(nbytes // 2 // 4, dtype=torch.int32, device=dev)
        half_dst = torch.empty_like(half)
        kinds["copy"] = lambda: half_dst.copy_(half)
        ms = {k: [] for k in kinds}
        b2b = {k: [] for k in kinds}
        for kind in list(kinds) + list(kinds)[::-1]:
            ms[kind] += events_ms(kinds[kind], 10)
            b2b[kind].append(back_to_back_ms(kinds[kind]))
        print(json.dumps({
            "decompress": name, "rows": n, "features": f, "bits": bits,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
            "ms": {k: statistics.mean(v) for k, v in ms.items()},
            "back_to_back_ms": {k: statistics.mean(v) for k, v in b2b.items()},
        }), flush=True)
        del words, out, kinds, half, half_dst
        torch.cuda.empty_cache()
    print(json.dumps({"nvidia_smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
