"""Shared cases of the LM substrate's parity tests (tests/test_torch_lm_*.py,
the `cuda` LM tests of tests/test_torch_cuda.py) and of
`torch_parity_readings.py lm`. It holds no test and imports no JAX (the
card's machine has none); its reference script runs JAX in a subprocess.

The reference's model outputs come from a subprocess (`reference_outputs`)
that runs `repro` jitted under `XLA_FLAGS=--xla_allow_excess_precision=false`:
with excess precision allowed (XLA's default), a jitted program keeps
float32 between fused bf16 operations, and its logits differ from the same
program run op by op by ~1% of their largest value; with it off, the
jitted program rounds after every bf16 operation, as the op-by-op program
and the port do. The flag must be set before JAX starts, so it cannot be
set in a test worker that may have started JAX already.

Inputs are made with numpy from a seed; the parameters are the port's
seeded initialisation, taken to numpy (`params_to_numpy`), handed to the
reference in an .npz, and carried back into the port with
`params_from_numpy`.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

ARCHS = ["phi-3-vision-4.2b", "zamba2-7b", "mamba2-2.7b", "minicpm3-4b", "glm4-9b", "yi-6b",
         "seamless-m4t-medium", "llama4-maverick-400b-a17b", "stablelm-12b",
         "llama4-scout-17b-a16e"]
# Gradients leaf by leaf: one architecture of each family (dense GQA, MoE,
# MLA, VLM prefix, SSM, hybrid, enc-dec).
GRAD_ARCHS = ["yi-6b", "llama4-scout-17b-a16e", "minicpm3-4b", "phi-3-vision-4.2b",
              "mamba2-2.7b", "zamba2-7b", "seamless-m4t-medium"]
# Decode step by step: the reference's test_decode_matches_forward five,
# and glm4 with the int8 KV cache ("glm4-9b:int8").
DECODE_ARCHS = ["yi-6b", "minicpm3-4b", "mamba2-2.7b", "zamba2-7b", "seamless-m4t-medium",
                "glm4-9b:int8"]
BATCH, SEQ, SRC, DECODE_STEPS = 2, 16, 8, 12
WIDTH = 64


def small(cfg):
    """The tests' cut: d_model 64, two layers (zamba2 three: one group of two
    mamba layers and one rest layer, so both of its loops run)."""
    layers = 3 if cfg.arch_type == "hybrid" else 2
    return cfg.reduced(n_layers=layers, d_model=WIDTH)


def config(get_arch, name: str):
    """The small config of an entry of ARCHS or DECODE_ARCHS."""
    arch, _, kv = name.partition(":")
    cfg = small(get_arch(arch))
    return dataclasses.replace(cfg, kv_cache_dtype="int8") if kv == "int8" else cfg


def batch(cfg, seed: int, b: int = BATCH, s: int = SEQ) -> dict:
    """numpy inputs of the family: tokens, targets, prefix / source
    embeddings."""
    rng = np.random.default_rng(1000 + seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.arch_type == "vlm":
        out["prefix_embeds"] = (rng.normal(size=(b, cfg.n_prefix_tokens, cfg.d_model))
                                * 0.02).astype(np.float32)
    if cfg.arch_type in ("audio", "encdec"):
        out["src_embeds"] = (rng.normal(size=(b, SRC, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def flatten(tree, prefix: str) -> dict:
    """{"prefix/a/b": leaf} of a tree of nested dicts."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def unflatten(arrays: dict, prefix: str) -> dict:
    """The nested dict under `prefix` of a flattened .npz."""
    out = {}
    for key, v in arrays.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        *path, last = key[len(prefix) + 1:].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return out


REFERENCE = r"""
import sys, time
import numpy as np
import jax, jax.numpy as jnp
# Fewer XLA passes: compiles in about half the time, and with excess
# precision off the result is the op-by-op program's all the same.
jax.config.update("jax_disable_most_optimizations", True)
sys.path.insert(0, {tests!r})
import test_torch_lm_common as C
from repro.configs import get_arch
from repro.models import NO_SHARDING, build_model

in_path, out_path, names = sys.argv[1], sys.argv[2], sys.argv[3].split(",")
inputs, arrays, t0 = dict(np.load(in_path)), {{}}, time.time()
for name in names:
    what, _, arch = name.partition("=")
    cfg = C.config(get_arch, arch)
    model = build_model(cfg)
    params = jax.tree.map(jnp.asarray, C.unflatten(inputs, f"{{arch}}/params"))
    b = {{k: jnp.asarray(v) for k, v in C.unflatten(inputs, f"{{arch}}/batch").items()}}
    if what == "fwd":
        def f(p, bb):
            return model.loss_fn(p, bb, NO_SHARDING), model.forward_logits(p, bb, NO_SHARDING)
        if arch in C.GRAD_ARCHS:
            (loss, logits), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params, b)
            arrays.update(C.flatten(grads, f"{{arch}}/grads"))
        else:
            loss, logits = jax.jit(f)(params, b)
        arrays[f"{{arch}}/loss"] = np.asarray(loss)
        arrays[f"{{arch}}/logits"] = np.asarray(logits)
    else:  # decode step by step from an empty float32 (or int8) cache
        cache = model.init_cache(C.BATCH, C.DECODE_STEPS, dtype=jnp.float32)
        dec = jax.jit(lambda p, bb, c, i: model.decode_fn(p, bb, c, i, NO_SHARDING))
        outs = []
        for t in range(C.DECODE_STEPS):
            db = {{"tokens": b["tokens"][:, t:t + 1]}}
            if "src_embeds" in b:
                db["src_embeds"] = b["src_embeds"]
            logits, cache = dec(params, db, cache, t)
            outs.append(np.asarray(logits[:, 0]))
        arrays[f"{{arch}}/decode"] = np.stack(outs, axis=1)
        arrays.update(C.flatten(cache, f"{{arch}}/cache"))
np.savez(out_path, **arrays)
print("REFERENCE-OK", round(time.time() - t0, 1))
"""

# Seconds of one reference job on one core (compile included), to deal the
# jobs out evenly: the SSM families' gradients compile longest.
COST = {"fwd=zamba2-7b": 11, "fwd=mamba2-2.7b": 6, "fwd=seamless-m4t-medium": 5.5,
        "fwd=llama4-scout-17b-a16e": 3.5, "fwd=yi-6b": 3, "fwd=phi-3-vision-4.2b": 3,
        "fwd=minicpm3-4b": 3, "dec=zamba2-7b": 2}


def jobs() -> list[str]:
    """The reference's work: "fwd=<arch>" (loss, logits, grads where the
    arch is in GRAD_ARCHS) and "dec=<name>" (a decoded sequence)."""
    return [f"fwd={a}" for a in ARCHS] + [f"dec={a}" for a in DECODE_ARCHS]


def inputs(seed: int) -> dict:
    """Every job's parameters (the port's seeded initialisation, on the CPU)
    and batch, flattened: what the reference and the port both start from."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, params_to_numpy

    out = {}
    for name in dict.fromkeys(j.partition("=")[2] for j in jobs()):
        cfg = config(get_arch, name)
        out.update(flatten(params_to_numpy(build_model(cfg).init_params(seed, "cpu")),
                           f"{name}/params"))
        out.update(flatten(batch(cfg, seed), f"{name}/batch"))
    return out


def reference_outputs(tmp: Path, seed: int = 0, parts: int = 4):
    """(inputs, outputs) for `seed`: the inputs as `inputs` makes them, and
    every reference output, from `parts` subprocesses at once (the jobs
    dealt by COST, longest first, to the least loaded)."""
    ins = inputs(seed)
    in_path = tmp / f"lm_in_{seed}.npz"
    np.savez(in_path, **ins)
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    code = textwrap.dedent(REFERENCE.format(tests=str(ROOT / "tests")))
    deal, load = [[] for _ in range(parts)], [0.0] * parts
    for job in sorted(jobs(), key=lambda j: -COST.get(j, 1)):
        k = load.index(min(load))
        deal[k].append(job)
        load[k] += COST.get(job, 1)
    procs = []
    for k, names in enumerate(deal):
        out = tmp / f"lm_ref_{seed}_{k}.npz"
        procs.append((out, subprocess.Popen(
            [sys.executable, "-c", code, str(in_path), str(out), ",".join(names)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)))
    arrays = {}
    for out, proc in procs:
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "REFERENCE-OK" in stdout, stdout + stderr[-4000:]
        arrays.update(np.load(out))
    return ins, arrays


def rel_max(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def rel_norm(got, want) -> float:
    """||got - want||_2 / ||want||_2 (0 for an empty leaf)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if want.size == 0:
        return 0.0
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
