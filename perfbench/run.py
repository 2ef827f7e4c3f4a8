#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card, and print its
result as the last line of standard output.

    python3 perfbench/run.py --workload higgs-train --seed 7 --seconds 10 --trace 0

From the root of a checkout. The cells, their configurations, traffic
mixes and metrics are in BENCHMARK.json. `--trace 0` prints the cell's
end-to-end metrics, `--trace 1` its per-layer metrics from a traced
stretch after the window. Every run checks what its window produced
against the plain reference (`perfbench/reference`) and prints each number
compared beside its limit on standard error. Without a CUDA device, or
with fewer than the cell asks for, it exits with a non-zero code and
prints no result.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Every cache of the program and of its libraries at a fixed path in the
    # checkout, so that only a checkout's first run builds and compiles.
    # The port's own kernel library is built in build/repro_torch_kernels.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    # Run as a script, the interpreter puts perfbench/ itself first on the
    # path, where its modules would shadow others of the same name.
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    from perfbench import harness

    return harness.main(args, STARTED)


if __name__ == "__main__":
    sys.exit(main())
