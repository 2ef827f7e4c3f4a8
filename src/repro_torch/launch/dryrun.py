"""The LM's multi-pod dry run; counterpart of `repro.launch.dryrun`.

For every (architecture x input shape) pair, build the step function (the
train step with AdamW, the prefill step or the decode step) on meta
stand-ins with the production partition specs, and run it under the
port's partition model (`launch.partition.trace`) for the 16x16
single-pod mesh or the 2x16x16 multi-pod mesh. Nothing is allocated: the
trace is host work on meta tensors, as the reference's compile is host
work. It records:

  * memory_analysis: `argument_bytes` (exact: the local bytes of every
    argument leaf, the ceiling of an uneven dimension, as XLA pads),
    `output_bytes`, `temp_bytes` (the trace's peak of live local bytes
    the step makes, its outputs apart), `alias_bytes` (0: the reference
    donates nothing) and `peak_hbm_bytes_est`;
  * partition: the trace's per-device dot FLOPs, dot bytes and collective
    bytes by type, under `hlo_analysis.analyze`'s keys (in place of the
    reference's `hlo`), the ops that fell back to a gather;
  * roofline: compute, memory and collective terms on one NVIDIA H100 SXM
    (PEAK_FLOPS, HBM_BW; a collective's link term by the group it spans,
    NVLINK_BW within a host of `partition.HOST_CARDS` cards, NETWORK_BW
    across hosts).

XLA's `cost_analysis()` (its counters that visit a loop body once) has no
counterpart: there is no compiled program. The five families loop over
their stacked layers in Python, so the step is traced at two depths and
the counts extrapolated linearly to the config's depth (`depth_points`):
groups of `attn_every` layers for the hybrid, encoder and decoder layers
for the enc-dec family. A full-depth trace equals the extrapolation in
every count; the temp peak, a maximum and not a sum, is extrapolated
linearly (never below a traced depth's peak): an estimate.

Usage:
  python -m repro_torch.launch.dryrun --device cpu --arch yi-6b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes [--out DIR] [--jobs 8]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch import partition as PT
from repro_torch.launch import specs as SP
from repro_torch.launch.dryrun_gbdt import nvidia_smi
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig
from repro_torch.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.pytree import leaves, unflatten_like

# One NVIDIA H100 SXM, dense, at 700 W (NVIDIA's data sheet).
PEAK_FLOPS = 989e12  # bf16 FLOP/s
HBM_BW = 3.35e12  # HBM3 bytes/s
HBM_BYTES = 80e9  # the card's memory, as the data sheet counts it
NVLINK_BW = 450e9  # bytes/s each way, within a host (NVLink 4)
NETWORK_BW = 50e9  # bytes/s across hosts: an assumption, see NETWORK_ASSUMPTION
NETWORK_ASSUMPTION = ("a DGX H100 host of 8 cards with one 400 Gb/s NIC a card: "
                      "50 GB/s a card across hosts")


def count_params(struct) -> int:
    return sum(t.numel() for t in leaves(struct))


def active_params(cfg: ArchConfig, total: int) -> int:
    if not cfg.n_experts:
        return total
    moe_part = cfg.n_layers * 3 * cfg.n_experts * cfg.d_model * cfg.d_ff
    return total - moe_part + moe_part * cfg.top_k // cfg.n_experts


def model_flops(cfg: ArchConfig, shape: ShapeConfig, n_active: int) -> float:
    """6*N*D (train) / 2*N*D (inference) global useful FLOPs."""
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    factor = 6.0 if shape.kind == "train" else 2.0
    return factor * n_active * tokens


def build_step(model, cfg: ArchConfig, shape: ShapeConfig, mesh):
    """(fn, arg_structs, arg_specs): the step, its arguments as meta
    tensors, and their partition specs (trees like the arguments)."""
    rules = SP.rules_for(mesh, shape)
    batch_structs = SP.input_specs(cfg, shape)
    batch_specs = SP.batch_partition_specs(cfg, shape, rules)
    params_struct = model.init_params(0, "meta")
    pspecs = model.param_specs()

    if shape.kind == "train":
        acfg = AdamWConfig()
        opt_struct = adamw_init(params_struct)
        ospecs = type(opt_struct)(step=(), m=pspecs, v=pspecs)

        def train_step(params, opt_state, batch):
            flat = [p.detach().requires_grad_(True) for p in leaves(params)]
            live = unflatten_like(params, flat)
            loss = model.loss_fn(live, batch, rules)
            grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                        materialize_grads=True)
            new_params, new_opt = adamw_update(params, unflatten_like(params, list(grads)),
                                               opt_state, acfg)
            return new_params, new_opt, loss.detach()

        return (train_step, (params_struct, opt_struct, batch_structs),
                (pspecs, ospecs, batch_specs))

    if shape.kind == "prefill":

        def prefill_step(params, batch):
            with torch.no_grad():
                return model.forward_logits(params, batch, rules)

        return prefill_step, (params_struct, batch_structs), (pspecs, batch_specs)

    # decode
    cap = SP.cache_capacity(cfg, shape)
    cache_struct = model.init_cache(shape.global_batch, cap, torch.bfloat16, device="meta")
    cspecs = model.cache_specs(rules)
    idx_struct = torch.empty((), dtype=torch.int32, device="meta")

    def decode_step(params, batch, cache, index):
        # A meta scalar has no value: the token is written at the cache's
        # last position (every position does the same work), and the
        # index counts as read when the model takes that position.
        pos = _Position(cap - 1, lambda: PT.current() and PT.current().mark_read(index))
        with torch.no_grad():
            return model.decode_fn(params, batch, cache, pos, rules)

    return (decode_step, (params_struct, batch_structs, cache_struct, idx_struct),
            (pspecs, batch_specs, cspecs, ()))


class _Position(int):
    """The decode step's write position, the Python int the models take;
    `int()` of it (the models' read) calls `on_read`."""

    def __new__(cls, value: int, on_read):
        self = super().__new__(cls, value)
        self.on_read = on_read
        return self

    def __int__(self):
        self.on_read()
        return int.__int__(self)


def argument_bytes(structs, specs, mesh, read=None) -> int:
    """A position's bytes of the argument leaves (the ceiling of an uneven
    dimension); with `read` (a bool a leaf, in `partition.paired` order),
    of those the step reads only, as XLA counts them (jit drops an unused
    argument)."""
    pairs = list(PT.paired(structs, specs))
    read = [True] * len(pairs) if read is None else read
    return sum(math.prod(PT.shard_shape(tuple(t.shape), s, mesh)) * t.element_size()
               for (t, s), r in zip(pairs, read) if r)


def local_arguments(structs, specs, mesh, device, read=None) -> list[torch.Tensor]:
    """A position's shard of every argument leaf (of those the step reads,
    with `read`), allocated uninitialised on `device`: the tensors
    `argument_bytes` counts."""
    pairs = list(PT.paired(structs, specs))
    read = [True] * len(pairs) if read is None else read
    return [torch.empty(PT.shard_shape(tuple(t.shape), s, mesh), dtype=t.dtype, device=device)
            for (t, s), r in zip(pairs, read) if r]


def trace_step(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """One trace of the step of `cfg` (at its own depth): the partition
    summary, and under "arguments_read" which argument leaves it read."""
    model = build_model(cfg)
    fn, structs, specs = build_step(model, cfg, shape, mesh)
    with PT.trace(mesh) as tr:
        tr.place(structs, specs)
        out = fn(*structs)
    return {**PT.summary(tr, out), "arguments_read": tr.read(structs)}


def depth_points(cfg: ArchConfig) -> list[tuple[float, ArchConfig]]:
    """[(weight, cfg at a small depth)]: the config's counts are the
    weighted sum of the small configs' (each count linear in the layers):
    one and two layers (hybrid groups of `attn_every`; encoder and decoder
    layers apart)."""
    rep = dataclasses.replace

    def line(n: int, at):
        """Weights of depths 1 and 2 for depth n."""
        return [(1.0, at(n))] if n <= 2 else [(2.0 - n, at(1)), (n - 1.0, at(2))]

    if cfg.arch_type == "hybrid":
        a = cfg.attn_every
        rest = cfg.n_layers % a
        return line(cfg.n_layers // a, lambda g: rep(cfg, n_layers=g * a + rest))
    if cfg.arch_type in ("encdec", "audio"):
        e, d = cfg.n_enc_layers, cfg.n_layers
        if e == d:
            return line(e, lambda n: rep(cfg, n_layers=n, n_enc_layers=n))
        if e <= 2 and d <= 2:
            return [(1.0, cfg)]
        return [(3.0 - e - d, rep(cfg, n_layers=1, n_enc_layers=1)),
                (e - 1.0, rep(cfg, n_layers=1, n_enc_layers=2)),
                (d - 1.0, rep(cfg, n_layers=2, n_enc_layers=1))]
    return line(cfg.n_layers, lambda n: rep(cfg, n_layers=n))


def _combine(parts: list[tuple[float, dict]]) -> dict:
    """The weighted sum of partition summaries, key by key."""
    def add(acc, w, v):
        if isinstance(v, dict):
            acc = dict(acc or {})
            for k, x in v.items():
                acc[k] = add(acc.get(k), w, x)
            return acc
        return (acc or 0.0) + w * v

    out = None
    for w, summ in parts:
        out = add(out, w, summ)
    out["n_ops"] = int(round(out["n_ops"]))
    out["fallback_ops"] = {k: int(round(v)) for k, v in out["fallback_ops"].items()
                           if round(v)}
    return out


def partition_of(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """The step's partition summary at the config's depth, extrapolated
    from `depth_points`; "arguments_read" is read at any depth (the
    arguments' tree is the same at every depth)."""
    parts = [(w, trace_step(c, shape, mesh)) for w, c in depth_points(cfg)]
    read = [any(r) for r in zip(*(p.pop("arguments_read") for _, p in parts))]
    out = _combine(parts)
    # The peak is a maximum, not a sum: never below a traced depth's.
    out["temp_bytes_peak"] = max(out["temp_bytes_peak"],
                                 *(p["temp_bytes_peak"] for _, p in parts))
    return {**out, "arguments_read": read}


def roofline(part: dict, mf: float, chips: int) -> dict:
    flops_dev = part["dot_flops_per_device"]
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = part["dot_bytes_per_device"] / HBM_BW
    link = part["collective_bytes_by_link"]
    collective_s = link["nvlink"] / NVLINK_BW + link["network"] / NETWORK_BW
    dominant = max([("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)], key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "model_flops_global": mf,
        "model_flops_per_device": mf / chips,
        "useful_flops_ratio": (mf / chips) / flops_dev if flops_dev else 0.0,
    }


def _path(out_dir: str, rec: dict) -> str:
    return os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str, device=None,
            smi: str | None = None) -> dict:
    """One (architecture, shape, mesh) record, written to `out_dir` when
    given. The mesh's positions sit on `device` (the card by default):
    the trace itself allocates nothing. `smi`: `nvidia_smi()`'s line, read
    once a sweep (read here on the card when not given)."""
    from repro_torch.device import resolve_device

    base_cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    ok, reason = SP.supports_shape(base_cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if not ok:
        rec.update(status="skipped", reason=reason)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(_path(out_dir, rec), "w") as f:
                json.dump(rec, f, indent=1)
        return rec

    cfg = SP.cfg_for_shape(base_cfg, shape)
    model = build_model(cfg)
    dev = resolve_device(device)
    mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
    chips = mesh.size

    t0 = time.perf_counter()
    try:
        _, structs, specs = build_step(model, cfg, shape, mesh)
        part = partition_of(cfg, shape, mesh)
        read = part.pop("arguments_read")
        arg_bytes = argument_bytes(structs, specs, mesh, read)
        trace_s = time.perf_counter() - t0

        n_total = count_params(structs[0])
        n_active = active_params(cfg, n_total)
        mf = model_flops(cfg, shape, n_active)
        temp, out_b = part.pop("temp_bytes_peak"), part.pop("output_bytes")
        peak = arg_bytes + temp + out_b
        rec.update(
            status="ok",
            chips=int(chips),
            trace_s=round(trace_s, 2),
            params_total=int(n_total),
            params_active=int(n_active),
            argument_leaves={"read": sum(read), "total": len(read)},
            memory_analysis={
                "argument_bytes": int(arg_bytes),
                "output_bytes": int(out_b),
                "temp_bytes": int(temp),
                "alias_bytes": 0,
                "peak_hbm_bytes_est": int(peak),
                "fits_card": bool(peak <= HBM_BYTES),
            },
            partition=part,
            roofline=roofline(part, mf, chips),
            rates={"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "hbm_bytes": HBM_BYTES,
                   "nvlink_bw": NVLINK_BW, "network_bw": NETWORK_BW,
                   "host_cards": PT.HOST_CARDS, "network_assumption": NETWORK_ASSUMPTION},
        )
        if dev.type == "cuda":
            rec["nvidia_smi"] = smi if smi is not None else nvidia_smi()
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(_path(out_dir, rec), "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def line(rec: dict) -> str:
    """A record's line: its status, and for an ok record the per-device
    argument and peak bytes, the roofline terms and the fallback ops."""
    head = f"{rec['arch']:26s} {rec['shape']:12s} {rec['mesh']:10s} {rec['status']:8s} "
    if rec["status"] != "ok":
        return head + rec.get("reason", rec.get("error", ""))[:120]
    r, m = rec["roofline"], rec["memory_analysis"]
    return head + (
        f"trace={rec['trace_s']:6.1f}s arg={m['argument_bytes'] / 2**30:7.2f}GiB "
        f"peak={m['peak_hbm_bytes_est'] / 2**30:8.2f}GiB dom={r['dominant']:10s} "
        f"c/m/coll={r['compute_s']:.2e}/{r['memory_s']:.2e}/{r['collective_s']:.2e} "
        f"useful={r['useful_flops_ratio']:.2f} "
        f"fallback={','.join(rec['partition']['fallback_ops']) or '-'}")


def _one(job):
    return run_one(*job)


# Trace cost by shape kind, longest first: the flash loop of a 32k prefill
# is the most ops.
_COST = {"prefill": 0, "train": 1, "decode": 2}


def sweep(pairs, meshes, out_dir: str, device, jobs: int = 1, smi=None):
    """run_one over every (arch, shape) x mesh, in `jobs` processes (the
    longest traces first); yields the records as they finish."""
    work = [(a, s, mp, out_dir, device, smi) for a, s in pairs for mp in meshes]
    if jobs <= 1:
        yield from map(_one, work)
        return
    import multiprocessing as mp_

    work.sort(key=lambda j: _COST[SHAPES[j[1]].kind])
    with mp_.get_context("spawn").Pool(jobs) as pool:
        yield from pool.imap_unordered(_one, work)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--device", default="cuda",
                    help="where the mesh's positions sit ('cuda', 'cpu'); the trace "
                         "itself allocates nothing")
    ap.add_argument("--jobs", type=int, default=1, help="records traced at once (processes)")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    smi = nvidia_smi() if dev.type == "cuda" else None
    pairs = ([(a, s) for a in ARCHS for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    recs = []
    for rec in sweep(pairs, meshes, args.out, str(dev), args.jobs, smi):
        recs.append(rec)
        print(line(rec), flush=True)
    if smi is not None:
        print(smi, flush=True)
    return recs


if __name__ == "__main__":
    main()
