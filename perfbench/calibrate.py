#!/usr/bin/env python3
"""Readings that the limits of a cell's check are set from, on the card.

    python3 perfbench/calibrate.py --workload higgs-train --seeds 1,2,3 \
        --control-seeds 4,5,6 [--faults] [--seconds 2]

For each of `--seeds`: the program at the cell's own size, through the
cell's own driver (a training cell: set-up and one fit of the traffic's
rounds, which is what every fit of the window is; a predict cell: set-up
and a window of `--seconds`), judged by the plain reference: the lower
readings. For each of `--control-seeds`: the control, the reference itself
in the program's place computed in bfloat16, the nearest precision below
the configuration's float32, judged the same way: the upper readings. With
`--faults` (training cells), on the control seeds also the reference in
float32 in the program's place, alone and with each planted fault of
`reference.growth.Fault`: a round whose trees leave the margins unchanged,
half of the rows left out of (g, h) with the rest doubled, the leaf that
holds the most rows in the middle round altered by 10%. One JSON line a
reading, with the widest gaps and where they were (read, not compared),
on standard output; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch

    if not torch.cuda.is_available():
        print("calibrate.py runs only on the card", file=sys.stderr)
        return 2
    for line in readings(args.workload, _ints(args.seeds), _ints(args.control_seeds),
                         args.faults, args.seconds, "cuda"):
        print(json.dumps(line), flush=True)
    return 0


def _extra(drv) -> dict:
    return drv.extra() if hasattr(drv, "extra") else {}


def _ints(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s.strip()]


def readings(workload: str, seeds, control_seeds, faults: bool, seconds: float, device,
             cell_of=None):
    """Yield one dict a reading: {"kind", "seed", numbers..., "seconds"}.
    `cell_of(seed)` may supply a resized cell (tests)."""
    import torch

    from perfbench import harness as H
    from perfbench.reference import growth as RG

    cell_of = cell_of or (lambda s: H.load_cell(workload, s, device))
    for seed in seeds:
        t0 = time.perf_counter()
        drv = H.driver_for(cell_of(seed))
        drv.setup()
        if drv.cell.traffic["driver"] == "train":
            bst = drv.fit(drv.cell.traffic["rounds"])
            out = ({f: getattr(bst.ensemble, f) for f in RG.Trees.__dataclass_fields__},
                   bst.margins)
            del bst
            drv.fits = [out]
            drv.release()
            got = drv.check()
        else:
            drv.window(seconds)
            drv.release()
            got = drv.check()
        yield {"kind": "program", "seed": seed, **got, **_extra(drv),
               "seconds": time.perf_counter() - t0}
        del drv
    for seed in control_seeds:
        drv = H.driver_for(cell_of(seed))
        train = drv.cell.traffic["driver"] == "train"
        if train:
            from perfbench.data import generators as G

            drv.data = G.make(drv.cell.config, seed, drv.dev)
            variants = [("control_bf16", torch.bfloat16, None)]
            if faults:
                variants += [("reference_f32", torch.float32, None),
                             ("fault_stale_round", torch.float32, RG.Fault(stale_round=1)),
                             ("fault_half_batch", torch.float32, RG.Fault(half_batch=True)),
                             ("fault_altered_leaf", torch.float32,
                              RG.Fault(alter_round=drv.cell.traffic["rounds"] // 2))]
            for kind, dtype, fault in variants:
                t0 = time.perf_counter()
                trees, margins = drv.stand_in(dtype, fault)
                got = drv.judge(trees, margins)
                yield {"kind": kind, "seed": seed, **got, **_extra(drv),
                       "seconds": time.perf_counter() - t0}
        else:
            t0 = time.perf_counter()
            drv.setup()
            drv.window(seconds)
            drv.release()
            got = drv.judge(drv.stand_in(torch.bfloat16))
            yield {"kind": "control_bf16", "seed": seed, **got,
                   "seconds": time.perf_counter() - t0}
        del drv


if __name__ == "__main__":
    sys.exit(main())
