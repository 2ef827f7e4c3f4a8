"""LM training driver; counterpart of `repro.launch.train`, with its flags
and its final line, plus `--device` ("cuda" or "cpu").

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b --reduced \\
      --steps 50 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch yi-6b \\
      --reduced --steps 5 --batch 2 --seq 32

A step is eager autograd over the parameter leaves
(`torch.autograd.grad`), then the functional AdamW at the cosine
schedule's rate. The driver runs on one device (`NO_SHARDING`), as the
reference's does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_pytree
from repro_torch.configs import ARCHS, get_arch
from repro_torch.data import TokenStream
from repro_torch.device import resolve_device
from repro_torch.models import NO_SHARDING, build_model
from repro_torch.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.optimizer.util import cosine_schedule
from repro_torch.pytree import leaves, unflatten_like


def make_train_step(model, rules, acfg: AdamWConfig, total_steps: int):
    """step(params, opt_state, batch) -> (params, opt_state, loss): the
    loss and its gradient over every parameter leaf, then one AdamW update
    at cosine_schedule(opt_state.step, acfg.lr, warmup=20, total_steps)."""
    def step(params, opt_state, batch):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        live = unflatten_like(params, flat)
        loss = model.loss_fn(live, batch, rules)
        # an unused leaf (hybrid "rest" norms of a (0, d) shape) gets zeros, as JAX gives
        grads = unflatten_like(params, list(torch.autograd.grad(
            loss, flat, allow_unused=True, materialize_grads=True)))
        lr = cosine_schedule(opt_state.step, acfg.lr, warmup=20, total=total_steps)
        params, opt_state = adamw_update(params, grads, opt_state, acfg, lr=lr)
        return params, opt_state, loss.detach()

    return step


def lm_batch(cfg, toks, tgts, seed: int, i: int, device) -> dict:
    """A training batch of the family: tokens/targets, zero prefix
    embeddings for a VLM, seeded frame embeddings (at most 64 frames) for an
    audio / enc-dec model, as the reference's driver makes them."""
    batch, seq = toks.shape
    b = {"tokens": torch.as_tensor(toks, device=device),
         "targets": torch.as_tensor(tgts, device=device)}
    if cfg.arch_type == "vlm":
        b["prefix_embeds"] = torch.zeros((batch, cfg.n_prefix_tokens, cfg.d_model),
                                         device=device)
    if cfg.arch_type in ("audio", "encdec"):
        b["src_embeds"] = torch.as_tensor(
            np.random.default_rng(seed + i).normal(
                size=(batch, min(seq, 64), cfg.d_model)
            ).astype(np.float32) * 0.02, device=device)
    return b


def train_loop(cfg, steps: int, batch: int, seq: int, lr: float = 3e-4,
               seed: int = 0, log_every: int = 10, checkpoint_path: str = "",
               device=None, params=None):
    """`steps` AdamW steps on the token stream of `seed`; returns (params,
    history), a record {"step", "loss", "elapsed_s"} every `log_every` steps
    and at the last (elapsed_s unrounded, on the clock after the loss was
    read). `params` (the port's tree, e.g. carried with params_from_numpy)
    replaces the seeded initialisation."""
    dev = resolve_device(device)
    model = build_model(cfg)
    rules = NO_SHARDING
    if params is None:
        params = model.init_params(seed, dev)
    acfg = AdamWConfig(lr=lr)
    opt_state = adamw_init(params)
    stream = TokenStream(cfg.vocab_size, batch, seq, seed=seed)
    step_fn = make_train_step(model, rules, acfg, steps)

    history = []
    t0 = time.perf_counter()
    for i in range(steps):
        toks, tgts = stream.next_batch()
        b = lm_batch(cfg, toks, tgts, seed, i, dev)
        params, opt_state, loss = step_fn(params, opt_state, b)
        if i % log_every == 0 or i == steps - 1:
            rec = {"step": i, "loss": float(loss), "elapsed_s": time.perf_counter() - t0}
            history.append(rec)
            print(rec, flush=True)
    if checkpoint_path:
        save_pytree(checkpoint_path, {"params": params, "step": steps})
    return params, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the parameters and the batches live")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    _, history = train_loop(cfg, args.steps, args.batch, args.seq, lr=args.lr,
                            checkpoint_path=args.checkpoint, device=args.device)
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} ({'improved' if last < first else 'NOT improved'})")
    return history


if __name__ == "__main__":
    main()
