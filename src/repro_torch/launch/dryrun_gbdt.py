"""GBDT dry run on the production mesh; counterpart of
`repro.launch.dryrun_gbdt`.

Runs ONE boosting round (binary:logistic gradients -> a depth-6
depthwise tree at 256 bins, Algorithm 1) of an airline-shaped matrix made
from seed 0, on a mesh whose positions all sit on `--device` (default the
card; the reference's (data=16, model=16) mesh unless `--mesh` says
otherwise), in two distribution modes:

  baseline   — paper-faithful: rows over BOTH axes (the paper's per-GPU
               instance partitioning); full histograms psum'd over every
               position.
  feature    — beyond-paper: rows over `data`, features over `model`
               (padded to a multiple of it with constant columns, which
               never win a split); histograms psum'd over `data` only,
               winners chosen by an all-gather of per-node best-split
               records, rows routed by an int8 psum over `model`.

The round runs for real: the port has no compiled program whose shapes it
could lower. For each mode it reports the bytes a position posted to the
rendezvous in the round, by kind of collective (`Shard.posted()`, the
largest over positions), whether every position grew the same tree, and
the round's seconds; on the card also `nvidia-smi`'s name and power limit.
These bytes are the port's wire model (the tensors each position posts)
and cannot be compared with the reference's counts from XLA's HLO; no
time is estimated for a link (positions that share a card have none).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun_gbdt [--rows 1048576] \\
      [--features 13] [--mesh 16x16] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

MODES = ("baseline", "feature")
SEED = 0


def airline(rows: int, features: int, max_bins: int, device):
    """Dense (rows, features) bins, cuts and labels of an airline-shaped
    matrix made from SEED on `device`; features past the generator's 13
    repeat its columns."""
    import numpy as np

    from repro_torch.core import DeviceDMatrix
    from repro_torch.data import make_dataset

    x, y, _ = make_dataset("airline", rows, seed=SEED)
    x = np.ascontiguousarray(x[:, np.arange(features) % x.shape[1]])
    d = DeviceDMatrix(x, label=y, max_bins=max_bins, device=device)
    return d.matrix.unpack(), d.cuts, d.label


def run(mode: str, mesh, bins, cuts, y, max_bins: int = 256, max_depth: int = 6) -> dict:
    """One boosting round of `mode` on `mesh`: its record."""
    import torch

    from repro_torch import dist as D
    from repro_torch.core import objectives as O
    from repro_torch.core import tree as T

    obj = O.get_objective("binary:logistic")
    if mode == "baseline":
        row_axes, feature_axis = ("data", "model"), None
    elif mode == "feature":
        row_axes, feature_axis = ("data",), "model"
        pad = -bins.shape[1] % mesh.shape["model"]
        bins = torch.nn.functional.pad(bins, (0, pad))
        cuts = torch.cat([cuts, cuts.new_zeros((pad, cuts.shape[1]))])
    else:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    coll = D.PsumCollective(mesh, row_axes)
    parts = D.shard_features(bins, cuts, mesh, row_axes, feature_axis)
    n_rows, shard_of, _ = mesh.shards(row_axes)
    n_per = bins.shape[0] // n_rows
    ys = [y[s * n_per:(s + 1) * n_per].to(mesh.device(p)) for p, s in enumerate(shard_of)]

    def round_body(part, y_):
        b, c = part
        gh = obj.grad(torch.zeros((n_per, 1), device=y_.device), y_)[:, 0, :].contiguous()
        tree = T.grow_tree(b, gh, c, max_depth, max_bins, growth="depthwise",
                           collective=coll, feature_axis=feature_axis)
        return tree, D.group.current_shard().posted()

    devices = {d for d in mesh.devices.flat if d.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    out = D.spmd(mesh, round_body, parts, ys)
    for d in devices:
        torch.cuda.synchronize(d)
    seconds = time.perf_counter() - t0
    kinds = sorted({k for _, posted in out for k in posted})
    first = out[0][0]
    return {
        "mode": mode, "rows": int(bins.shape[0]), "features": int(bins.shape[1]),
        "mesh": dict(mesh.shape), "device": str(mesh.device(0)),
        "posted_bytes_per_position": {k: max(posted.get(k, 0) for _, posted in out)
                                      for k in kinds},
        "replicated": all(torch.equal(a.cpu(), b.cpu()) for t, _ in out[1:]
                          for a, b in zip(first, t)),
        "splits": int((~first.is_leaf & torch.isfinite(first.gain)).sum()),
        "round_s": seconds,
    }


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--features", type=int, default=13)
    ap.add_argument("--max-bins", type=int, default=256)
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--mesh", default="16x16", help="DATAxMODEL positions")
    ap.add_argument("--device", default="cuda",
                    help="where every position runs ('cuda', 'cuda:1', 'cpu')")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    from repro_torch.dist import make_mesh
    from repro_torch.launch.mesh import make_production_mesh

    shape = tuple(int(s) for s in args.mesh.lower().split("x"))
    if len(shape) != 2:
        raise SystemExit(f"--mesh takes DATAxMODEL, got {args.mesh!r}")
    dev = resolve_device(args.device)
    mesh = (make_production_mesh(device=dev) if shape == (16, 16)
            else make_mesh(shape, ("data", "model"), device=dev))
    bins, cuts, y = airline(args.rows, args.features, args.max_bins, dev)
    smi = nvidia_smi() if dev.type == "cuda" else None
    recs = []
    for mode in MODES:
        r = run(mode, mesh, bins, cuts, y, args.max_bins)
        if smi is not None:
            r["nvidia_smi"] = smi
        recs.append(r)
        print(f"{mode:9s} posted/position={sum(r['posted_bytes_per_position'].values()):.3e} "
              f"({ {k: f'{v:.2e}' for k, v in r['posted_bytes_per_position'].items()} }) "
              f"round_s={r['round_s']:.3f} replicated={r['replicated']}", flush=True)
    if smi is not None:
        print(smi, flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "gbdt_round.json"), "w") as f:
            json.dump(recs, f, indent=1)
    return recs


if __name__ == "__main__":
    main()
