#!/usr/bin/env python3
"""Where a full-width LM train step's time goes on the card: the parts of
`launch/train.py::make_train_step` one by one, then one step under
`torch.profiler`.

    python3 tools/lm_parts.py [--arch yi-6b] [--layers 2] [--seq 4096] [--steps 5]
        [--remat dots_saveable|full|off]

Weights from the seed on the card, the arch cut in depth only, batch 1.
Prints JSON lines: each part's seconds (synchronised, the median over
--steps steps after one warm step): the token batch on the host
(`TokenStream.next_batch`) and its copy to the card, the forward
(`loss_fn`), the backward (`torch.autograd.grad` over every leaf), the
AdamW update; the flash attention of one layer alone (forward, and forward
plus backward) beside `torch.nn.functional.scaled_dot_product_attention` on
the same q, k, v (a library reading only: the port does not call it); then
the profiled step's device time by operator and by kernel (the largest),
its kernel launches, its device busy time against its wall time, and the
card's name and power limit.
Needs a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat", default="dots_saveable", choices=["dots_saveable", "full", "off"],
                    help="the config's remat policy, or no remat")
    args = ap.parse_args()

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStream
    from repro_torch.launch.train import lm_batch
    from repro_torch.models import NO_SHARDING, build_model
    from repro_torch.models import layers as L
    from repro_torch.optimizer import AdamWConfig, adamw_init, adamw_update
    from repro_torch.optimizer.util import cosine_schedule
    from repro_torch.pytree import leaves, unflatten_like

    if not torch.cuda.is_available():
        print("lm_parts.py needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    cfg = dataclasses.replace(get_arch(args.arch), n_layers=args.layers,
                              remat=args.remat != "off",
                              remat_policy="full" if args.remat == "off" else args.remat)
    model = build_model(cfg)
    params = model.init_params(args.seed, dev)
    state = adamw_init(params)
    acfg = AdamWConfig()
    stream = TokenStream(cfg.vocab_size, 1, args.seq, seed=args.seed)

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    def step(i, parts):
        nonlocal params, state
        t0 = clock()
        toks, tgts = stream.next_batch()
        t1 = clock()
        batch = lm_batch(cfg, toks, tgts, args.seed, i, dev)
        t2 = clock()
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss = model.loss_fn(unflatten_like(params, flat), batch, NO_SHARDING)
        t3 = clock()
        grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
        t4 = clock()
        lr = cosine_schedule(state.step, acfg.lr, warmup=20, total=100)
        params, state = adamw_update(params, unflatten_like(params, list(grads)), state, acfg,
                                     lr=lr)
        t5 = clock()
        for k, v in zip(("batch_host", "batch_copy", "forward", "backward", "adamw"),
                        (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
            parts.setdefault(k, []).append(v)
        return loss.item()

    step(0, {})  # warm: cuBLAS handles, allocator
    parts = {}
    losses = [step(i + 1, parts) for i in range(args.steps)]
    med = {k: float(np.median(v)) for k, v in parts.items()}
    print(json.dumps({"arch": args.arch, "n_layers": args.layers, "seq": args.seq,
                      "remat": args.remat, "steps": args.steps, "losses": losses,
                      "part_s_median": med, "step_s": sum(med.values()),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "nvidia_smi": smi}), flush=True)

    # One layer's attention alone, at its full-width shapes.
    h, kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = torch.Generator(device=dev).manual_seed(args.seed)
    q, k, v = (torch.randn((1, args.seq, n, d), device=dev, generator=g).to(torch.bfloat16)
               for n in (h, kh, kh))

    def timed(fn, reps=5):
        fn()
        out = []
        for _ in range(reps):
            t0 = clock()
            fn()
            out.append(clock() - t0)
        return float(np.median(out))

    def flash_fwd_bwd():
        qq = q.detach().requires_grad_(True)
        out = L.flash_attention_gqa(qq, k, v, causal=True)
        out.float().sum().backward()

    def sdpa():
        qq, kk, vv = (x.transpose(1, 2) for x in (q, k, v))
        kk = kk.repeat_interleave(h // kh, dim=1)
        vv = vv.repeat_interleave(h // kh, dim=1)
        torch.nn.functional.scaled_dot_product_attention(qq, kk, vv, is_causal=True)

    with torch.no_grad():
        flash_s = timed(lambda: L.flash_attention_gqa(q, k, v, causal=True))
        sdpa_s = timed(sdpa)
    print(json.dumps({"attention": {"heads": h, "kv_heads": kh, "head_dim": d, "seq": args.seq,
                                    "flash_forward_s": flash_s,
                                    "flash_forward_backward_s": timed(flash_fwd_bwd),
                                    "library_sdpa_forward_s": sdpa_s}}), flush=True)

    # One step under the profiler: device time by operator, busy vs wall.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = clock()
        step(args.steps + 1, {})
        wall = clock() - t0
    # Device time is counted on the kernels' own events (an aten op's event
    # carries the time of the kernels it launched too: summing both would
    # count it twice); operators are ranked by their launched kernels' time.
    from torch.autograd import DeviceType

    kernels, ops_ = [], []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            (kernels if e.device_type == DeviceType.CUDA else ops_).append((us, e.key, e.count))
    kernels.sort(reverse=True)
    ops_.sort(reverse=True)
    busy_s = sum(r[0] for r in kernels) / 1e6
    print(json.dumps({"profiled_step_wall_s": wall, "device_busy_s": busy_s,
                      "device_idle_share": 1 - busy_s / wall if wall else None,
                      "kernel_launches": sum(r[2] for r in kernels),
                      "top_ops": [{"op": key, "device_ms": us / 1e3, "calls": n}
                                  for us, key, n in ops_[:12]],
                      "top_kernels": [{"kernel": key[:90], "device_ms": us / 1e3, "calls": n}
                                      for us, key, n in kernels[:8]]}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
