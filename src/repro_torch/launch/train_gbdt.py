"""GBDT command-line trainer: the paper's end-to-end pipeline (Figure 1) behind
the two nouns, DeviceDMatrix (quantise once) + Booster.fit, on the card by
default; counterpart of `repro.launch.train_gbdt`, with its flags and its
final line, plus `--device` ("cuda" or "cpu").

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train_gbdt --dataset higgs \\
      --rows 20000 --rounds 50
  PYTHONPATH=src python -m repro_torch.launch.train_gbdt --device cpu --rows 4000

Multi-device fits (`--devices N > 1`, the reference's shard_map path) are
not ported (ROADMAP queue 1 item 5): they raise NotImplementedError.
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

    if args.devices > 1:
        raise NotImplementedError(
            f"--devices {args.devices}: multi-device fits are not ported yet "
            "(ROADMAP queue 1 item 5); run with --devices 1")

    import torch

    from repro_torch.core import Booster, BoosterConfig, DeviceDMatrix
    from repro_torch.data import make_dataset

    def synced():
        if args.device == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()

    x, y, spec = make_dataset(args.dataset, n_rows=args.rows)
    n_tr = int(0.8 * len(x))
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

    t0 = synced()
    bst = Booster(cfg).fit(
        dtrain,
        evals=[(dval, "valid")],
        early_stopping_rounds=args.early_stopping or None,
        verbose_every=max(args.rounds // 5, 1),
        callback=lambda r, rec: print(rec, flush=True),
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
