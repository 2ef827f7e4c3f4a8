"""GBDT command-line trainer: the paper's end-to-end pipeline (Figure 1) behind
the two nouns, DeviceDMatrix (quantise once) + Booster.fit, on the card by
default; counterpart of `repro.launch.train_gbdt`, with its flags and its
final line, plus `--device` ("cuda" or "cpu").

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train_gbdt --dataset higgs \\
      --rows 20000 --rounds 50
  PYTHONPATH=src python -m repro_torch.launch.train_gbdt --device cpu --rows 4000

`--devices N` shards the training rows over a mesh of N positions
(`dist.make_mesh((N,), ("data",))`; the rows are cut to a multiple of N,
as the reference cuts them): one position a card when the machine has N
cards, else all N on the one card (or on the CPU with `--device cpu`).
"""
from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="higgs")
    ap.add_argument("--rows", type=int, default=20_000)
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--max-depth", type=int, default=6)
    ap.add_argument("--max-bins", type=int, default=256)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--growth", default="depthwise", choices=["depthwise", "lossguide"])
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--use-kernel", action="store_true",
                    help="build every level's histogram in full through the "
                         "privatised histogram kernel (use_kernel_histograms=True)")
    ap.add_argument("--early-stopping", type=int, default=0,
                    help="stop when the valid metric stalls for N rounds")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the matrices and the booster live")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core import Booster, BoosterConfig, DeviceDMatrix
    from repro_torch.data import make_dataset

    def synced():
        if args.device == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()

    x, y, spec = make_dataset(args.dataset, n_rows=args.rows)
    n_tr = int(0.8 * len(x))
    n_tr = (n_tr // args.devices) * args.devices  # shard-divisible (no-op at 1)
    cfg = BoosterConfig(
        n_rounds=args.rounds,
        max_depth=args.max_depth,
        max_bins=args.max_bins,
        learning_rate=args.lr,
        objective=spec.objective,
        n_classes=spec.n_classes,
        growth=args.growth,
        use_kernel_histograms=args.use_kernel,
    )

    t0 = synced()
    dtrain = DeviceDMatrix(x[:n_tr], label=y[:n_tr], max_bins=args.max_bins,
                           device=args.device)
    dval = DeviceDMatrix(x[n_tr:], label=y[n_tr:], ref=dtrain)
    t_build = synced() - t0

    mesh = None
    if args.devices > 1:
        from repro_torch.dist import make_mesh

        enough = args.device == "cuda" and torch.cuda.device_count() >= args.devices
        mesh = make_mesh((args.devices,), ("data",), device=None if enough else args.device)

    t0 = synced()
    bst = Booster(cfg).fit(
        dtrain,
        evals=[(dval, "valid")],
        early_stopping_rounds=args.early_stopping or None,
        verbose_every=max(args.rounds // 5, 1),
        callback=lambda r, rec: print(rec, flush=True),
        mesh=mesh,
    )
    t_fit = synced() - t0

    metric_name, metric = next(iter(bst.eval(dval, "valid").items()))
    print(f"dataset={args.dataset} rows={args.rows} "
          f"rounds={bst.n_rounds_trained} devices={args.devices} "
          f"dmatrix={t_build:.1f}s fit={t_fit:.1f}s "
          f"{metric_name}={metric:.4f}")
    if args.checkpoint:
        bst.save(args.checkpoint)
        print("saved booster to", args.checkpoint)


if __name__ == "__main__":
    main()
