"""Decoder-only LM (dense / MoE / VLM backbone); counterpart of
`repro.models.transformer`.

Parameters are the reference's tree: nested dicts of float32 tensors with
its keys, the layers stacked along a leading L axis. The reference's scan
over that axis is a Python loop over its slices here (`_layer`), each
layer body wrapped in activation checkpointing when `cfg.remat` is set
(`remat`). Caches are stacked (L, ...) the same way.

Forward modes:
  forward(...)      full sequence (train / prefill)
  decode_step(...)  one token against a KV cache

Sharding is data, as in the reference: `param_specs` / `cache_specs` give
each leaf a partition spec, a tuple of mesh axis names (or None), leaf for
leaf the reference's `PartitionSpec`. The port runs the LM on one device
under `NO_SHARDING`; under `ShardingRules(enabled=True)` it runs inside
the dry run's partition model (`launch.partition.trace`, on meta
tensors), where `_constrain` sets a tensor's spec as the reference's
`with_sharding_constraint` does. Outside a trace there is no mesh, and a
constraint raises ValueError.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    BF16,
    attention_gqa,
    attention_mla,
    dot,
    dot_f32,
    rmsnorm,
    swiglu,
)
from repro_torch.models.moe import moe_ffn


def P(*axes) -> tuple:
    """A partition spec: one mesh axis name (or tuple of names, or None) a
    dimension, as `jax.sharding.PartitionSpec` holds them."""
    return tuple(axes)


@dataclass(frozen=True)
class ShardingRules:
    """Logical activation shardings. enabled=False (one device) turns every
    constraint into a no-op."""

    batch: tuple | str | None = ("pod", "data")
    model: str | None = "model"
    seq: str | None = None  # set to shard decode caches along sequence
    enabled: bool = True

    def act(self):  # (B, S, D)
        return P(self.batch, None, None)

    def cache_kv(self):  # (B, T, K, D)
        return P(self.batch, self.seq, None, None)


NO_SHARDING = ShardingRules(batch=None, model=None, enabled=False)


def _constrain(x, spec, rules: ShardingRules):
    """x under partition spec `spec`: inside a `launch.partition.trace` the
    trace records it and x comes back; under disabled rules x comes back
    as it is."""
    if not rules.enabled:
        return x
    from repro_torch.launch import partition

    tr = partition.current()
    if tr is None:
        raise ValueError(
            f"a sharding constraint {spec} needs a mesh: the port shards the LM "
            "only inside launch.partition.trace (the dry run); pass NO_SHARDING "
            "to run on one device")
    return tr.constrain(x, spec)


# Matmul outputs a "dots_saveable" checkpoint keeps (jax.checkpoint_policies
# .dots_saveable saves every dot_general's result).
_DOT_OPS = frozenset({
    torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
    torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default,
})


def _dots_saveable(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(body, cfg: ArchConfig):
    """`body` under the reference's `jax.checkpoint(body, policy=...)`:
    "full" keeps only the body's inputs and recomputes the rest in the
    backward; "dots_saveable" keeps the matmul outputs and recomputes the
    elementwise work. Values are unchanged; only memory and time move."""
    if not cfg.remat:
        return body
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    if cfg.remat_policy == "full":
        context_fn = None
    elif cfg.remat_policy == "dots_saveable":
        context_fn = functools.partial(create_selective_checkpoint_contexts, _dots_saveable)
    else:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")

    @functools.wraps(body)
    def wrapped(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        kw = {"context_fn": context_fn} if context_fn is not None else {}
        return checkpoint(body, *args, use_reentrant=False, **kw)

    return wrapped


def _layer(tree, i: int):
    """Slice i of every leaf of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: list):
    """The per-layer trees stacked along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def n_stacked(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


# --------------------------------------------------------------------------
# Parameter init + specs
# --------------------------------------------------------------------------


class Init:
    """The port's initialiser: a seeded `torch.Generator` on the target
    device, so weights are drawn where they live and never cross the bus.
    Shapes, scales and dtypes are the reference's; the draws are the
    port's own (carry the reference's weights with `params_from_numpy`).
    On `device="meta"` (the dry run's stand-ins) nothing is drawn: every
    leaf has its shape and dtype and no values."""

    def __init__(self, seed: int, device=None):
        self.device = resolve_device(device, meta=True)
        self.gen = None
        if self.device.type != "meta":
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(int(seed))

    def normal(self, shape, lead=()) -> torch.Tensor:
        if self.gen is None:
            return torch.empty((*lead, *shape), device=self.device, dtype=torch.float32)
        return torch.randn((*lead, *shape), generator=self.gen, device=self.device,
                           dtype=torch.float32)

    def glorot(self, shape, lead=()) -> torch.Tensor:
        """Normal / sqrt(fan_in), fan_in = shape[-2] (shape[-1] for a vector),
        of each slice's own shape; `lead` stacks slices in front."""
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        return self.normal(shape, lead) / math.sqrt(fan_in)

    def const(self, shape, value: float, lead=()) -> torch.Tensor:
        return torch.full((*lead, *shape), float(value), device=self.device,
                          dtype=torch.float32)


def init_attn_params(init: Init, cfg: ArchConfig, lead=()):
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = functools.partial(init.glorot, lead=lead)
    if cfg.attention == "mla":
        dq = cfg.nope_head_dim + cfg.rope_head_dim
        return {
            "w_dq": g((d, cfg.q_lora_rank)),
            "w_uq": g((cfg.q_lora_rank, h * dq)),
            "w_dkv": g((d, cfg.kv_lora_rank)),
            "w_krope": g((d, cfg.rope_head_dim)),
            "w_uk": g((cfg.kv_lora_rank, h * cfg.nope_head_dim)),
            "w_uv": g((cfg.kv_lora_rank, h * cfg.resolved_v_head_dim)),
            "wo": g((h * cfg.resolved_v_head_dim, d)),
        }
    return {
        "wq": g((d, h * hd)),
        "wk": g((d, k * hd)),
        "wv": g((d, k * hd)),
        "wo": g((h * hd, d)),
    }


def attn_param_specs(cfg: ArchConfig, m: str = "model"):
    if cfg.attention == "mla":
        return {
            "w_dq": P(None, None),
            "w_uq": P(None, m),
            "w_dkv": P(None, None),
            "w_krope": P(None, None),
            "w_uk": P(None, m),
            "w_uv": P(None, m),
            "wo": P(m, None),
        }
    return {"wq": P(None, m), "wk": P(None, m), "wv": P(None, m), "wo": P(m, None)}


def init_ffn_params(init: Init, cfg: ArchConfig, lead=()):
    d, f = cfg.d_model, cfg.d_ff
    g = functools.partial(init.glorot, lead=lead)
    if cfg.n_experts:
        e = cfg.n_experts
        return {
            "router": g((d, e)),
            "w_gate": g((e, d, f)),
            "w_up": g((e, d, f)),
            "w_down": g((e, f, d)),
        }
    return {
        "w_gate": g((d, f)),
        "w_up": g((d, f)),
        "w_down": g((f, d)),
    }


def ffn_param_specs(cfg: ArchConfig, m: str = "model"):
    if cfg.n_experts:
        return {
            "router": P(None, None),
            "w_gate": P(m, None, None),
            "w_up": P(m, None, None),
            "w_down": P(m, None, None),
        }
    return {"w_gate": P(None, m), "w_up": P(None, m), "w_down": P(m, None)}


def init_layer_params(init: Init, cfg: ArchConfig, lead=()):
    return {
        "ln1": init.const((cfg.d_model,), 1.0, lead),
        "attn": init_attn_params(init, cfg, lead),
        "ln2": init.const((cfg.d_model,), 1.0, lead),
        "ffn": init_ffn_params(init, cfg, lead),
    }


def _prepend(specs, add: tuple):
    if isinstance(specs, dict):
        return {k: _prepend(v, add) for k, v in specs.items()}
    return P(*add, *specs)


def layer_param_specs(cfg: ArchConfig, m: str = "model", stacked: bool = True):
    add = (None,) if stacked else ()
    return {
        "ln1": P(*add, None),
        "attn": _prepend(attn_param_specs(cfg, m), add),
        "ln2": P(*add, None),
        "ffn": _prepend(ffn_param_specs(cfg, m), add),
    }


def init_params(cfg: ArchConfig, seed: int = 0, device=None):
    init = Init(seed, device)
    params = {
        "embed": init.glorot((cfg.padded_vocab, cfg.d_model)),
        "layers": init_layer_params(init, cfg, lead=(cfg.n_layers,)),
        "final_norm": init.const((cfg.d_model,), 1.0),
        "lm_head": init.glorot((cfg.d_model, cfg.padded_vocab)),
    }
    if cfg.n_prefix_tokens:
        params["prefix_proj"] = init.glorot((cfg.d_model, cfg.d_model))
    return params


def param_specs(cfg: ArchConfig, m: str = "model"):
    specs = {
        "embed": P(m, None),
        "layers": layer_param_specs(cfg, m, stacked=True),
        "final_norm": P(None),
        "lm_head": P(None, m),
    }
    if cfg.n_prefix_tokens:
        specs["prefix_proj"] = P(None, None)
    return specs


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


def embed(params, tokens):
    """The bf16 residual stream of `tokens` (ids in [0, padded_vocab))."""
    return F.embedding(tokens.long(), params["embed"]).to(BF16)


def ffn_dense(h, p):
    """The dense FFN of a layer's params: SwiGLU."""
    return swiglu(h, p["w_gate"], p["w_up"], p["w_down"])


def _layer_fwd(x, lp, cfg: ArchConfig, positions, rules: ShardingRules,
               window: int, cache=None, cache_index=None):
    """One transformer layer. Returns (x, (new_cache, aux))."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    if cfg.attention == "mla":
        attn_out, new_cache = attention_mla(
            h, lp["attn"],
            n_heads=cfg.n_heads,
            kv_lora_rank=cfg.kv_lora_rank,
            q_lora_rank=cfg.q_lora_rank,
            rope_head_dim=cfg.rope_head_dim,
            nope_head_dim=cfg.nope_head_dim,
            v_head_dim=cfg.resolved_v_head_dim,
            rope_theta=cfg.rope_theta,
            positions=positions,
            cache=cache, cache_index=cache_index, window=window,
        )
    else:
        attn_out, new_cache = attention_gqa(
            h, lp["attn"],
            n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta,
            positions=positions,
            cache=cache, cache_index=cache_index, window=window,
        )
    x = x + attn_out
    x = _constrain(x, rules.act(), rules)

    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    aux = {}
    if cfg.n_experts:
        ffn_out, aux = moe_ffn(
            h, lp["ffn"], n_experts=cfg.n_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, rules=rules,
        )
    else:
        ffn_out = ffn_dense(h, lp["ffn"])
    x = x + ffn_out
    x = _constrain(x, rules.act(), rules)
    return x, (new_cache, aux)


def forward(params, tokens, cfg: ArchConfig, rules: ShardingRules,
            prefix_embeds=None, window: int | None = None):
    """Full-sequence forward -> (logits, aux). tokens (B, S) int;
    prefix_embeds (B, Pfx, D) for VLM / audio backbones."""
    w = cfg.sliding_window if window is None else window
    x = embed(params, tokens)
    if prefix_embeds is not None:
        pfx = dot(prefix_embeds, params["prefix_proj"])
        x = torch.cat([pfx, x], dim=1)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    x = _constrain(x, rules.act(), rules)

    def body(carry, lp):
        y, (_, aux) = _layer_fwd(carry, lp, cfg, positions, rules, w)
        return y, aux

    body = remat(body, cfg)
    auxes = []
    for i in range(n_stacked(params["layers"])):
        x, aux = body(x, _layer(params["layers"], i))
        auxes.append(aux)

    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = dot_f32(x, params["lm_head"])
    logits = _constrain(logits, P(rules.batch, None, rules.model), rules)
    aux = ({k: torch.stack([a[k] for a in auxes]).mean() for k in auxes[0]}
           if auxes and auxes[0] else {})
    return logits, aux


def init_cache(cfg: ArchConfig, batch: int, capacity: int, dtype=torch.bfloat16,
               device=None):
    """Stacked (L, ...) KV cache on `device` (the card unless "cpu"). For
    sliding-window archs pass capacity=window. cfg.kv_cache_dtype == "int8"
    stores quantised values and per-(token, head) float32 scales."""
    dev = resolve_device(device, meta=True)
    z = functools.partial(torch.zeros, device=dev)
    l = cfg.n_layers
    if cfg.attention == "mla":
        return {
            "ckv": z((l, batch, capacity, cfg.kv_lora_rank), dtype=dtype),
            "krope": z((l, batch, capacity, cfg.rope_head_dim), dtype=dtype),
        }
    k, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    if cfg.kv_cache_dtype == "int8":
        return {
            "k": z((l, batch, capacity, k, hd), dtype=torch.int8),
            "v": z((l, batch, capacity, k, hd), dtype=torch.int8),
            "k_scale": z((l, batch, capacity, k), dtype=torch.float32),
            "v_scale": z((l, batch, capacity, k), dtype=torch.float32),
        }
    return {
        "k": z((l, batch, capacity, k, hd), dtype=dtype),
        "v": z((l, batch, capacity, k, hd), dtype=dtype),
    }


def cache_specs(cfg: ArchConfig, rules: ShardingRules):
    if cfg.attention == "mla":
        return {
            "ckv": P(None, rules.batch, rules.seq, None),
            "krope": P(None, rules.batch, rules.seq, None),
        }
    specs = {
        "k": P(None, rules.batch, rules.seq, None, None),
        "v": P(None, rules.batch, rules.seq, None, None),
    }
    if cfg.kv_cache_dtype == "int8":
        specs["k_scale"] = P(None, rules.batch, rules.seq, None)
        specs["v_scale"] = P(None, rules.batch, rules.seq, None)
    return specs


def decode_positions(cache_index, device) -> torch.Tensor:
    return torch.full((1, 1), int(cache_index), dtype=torch.int32, device=device)


def decode_step(params, token, cache, cache_index, cfg: ArchConfig,
                rules: ShardingRules, window: int | None = None):
    """One decode step. token (B, 1) int; cache stacked (L, ...);
    cache_index: the write position. Returns (logits, new_cache)."""
    w = cfg.sliding_window if window is None else window
    x = embed(params, token)
    positions = decode_positions(cache_index, x.device)
    new = []
    for i in range(n_stacked(params["layers"])):
        x, (nc, _) = _layer_fwd(x, _layer(params["layers"], i), cfg, positions, rules, w,
                                cache=_layer(cache, i), cache_index=cache_index)
        new.append(nc)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return dot_f32(x, params["lm_head"]), _stack(new)


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------


def xent_loss(logits, targets, n_prefix: int = 0):
    """Mean next-token cross entropy; VLM / audio prefix positions excluded."""
    if n_prefix:
        logits = logits[:, n_prefix:]
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - tgt)


def loss_fn(params, batch, cfg: ArchConfig, rules: ShardingRules):
    logits, aux = forward(
        params, batch["tokens"], cfg, rules,
        prefix_embeds=batch.get("prefix_embeds"),
    )
    loss = xent_loss(logits, batch["targets"], cfg.n_prefix_tokens)
    if aux:
        loss = loss + 0.01 * aux.get("lb_loss", 0.0) + 1e-3 * aux.get("z_loss", 0.0)
    return loss
