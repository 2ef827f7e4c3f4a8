#!/usr/bin/env python3
"""Where a sharded fit's host time goes on one card: the parts of
`repro_torch.dist` timed alone.

    python3 tools/dist_parts.py [--rows 1000000]

For 1, 2 and 4 shards on cuda:0 (`make_mesh(..., device="cuda")`), each
under the interpreter's default thread switch interval and under 0.1 ms
(`sys.setswitchinterval`): a bare rendezvous (`exchange(None)`, µs a
call), a psum and a ring allreduce of a level-5 histogram (32 nodes, 28
features, 256 bins: ms a call), and a 10-round depth-6 psum fit of the
Higgs-shaped matrix (s; at 1 shard the mesh runs inline, no thread,
beside the one-device kernel path, which also builds every level in
full). Every number is host wall time around
`torch.cuda.synchronize()`. Prints one JSON line a reading, then the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("dist_parts.py needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch import dist as D
    from repro_torch.core import Booster, DeviceDMatrix
    from repro_torch.data import make_dataset

    dev = torch.device("cuda", 0)
    x, y, _ = make_dataset("higgs", args.rows, seed=0)
    dtrain = DeviceDMatrix(x, label=y)
    kw = dict(n_rounds=10, max_depth=6, max_bins=256, objective="binary:logistic")

    def timed(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps

    default_interval = sys.getswitchinterval()
    for interval in (default_interval, 1e-4):
        sys.setswitchinterval(interval)
        for s in (1, 2, 4):
            mesh = D.make_mesh((s,), ("data",), device=dev)
            hists = [torch.randn((32, 28, 256, 2), device=dev) for _ in range(s)]
            line = {"switch_interval_s": interval, "shards": s}

            def rendezvous(_):
                shard = D.group.current()
                for _ in range(200):
                    shard.exchange(None)

            line["rendezvous_us"] = timed(
                lambda: D.spmd(mesh, rendezvous, list(range(s))), 3) / 200 * 1e6
            for name in ("psum", "ring"):
                coll = D.get_collective(name, mesh)
                line[f"{name}_level5_ms"] = timed(
                    lambda: D.spmd(mesh, lambda h: [coll.allreduce_hist(h) for _ in range(10)],
                                   hists), 3) / 10 * 1e3
            line["fit_s"] = timed(lambda: Booster(**kw).fit(dtrain, mesh=mesh), 2)
            if s == 1:  # the same growth (every level in full) with no mesh
                line["kernel_path_fit_s"] = timed(lambda: Booster(
                    **kw, use_kernel_histograms=True).fit(dtrain), 2)
            print(json.dumps(line), flush=True)
    sys.setswitchinterval(default_interval)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
