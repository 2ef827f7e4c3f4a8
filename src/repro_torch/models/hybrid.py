"""Zamba2-style hybrid: a Mamba2 backbone and ONE shared attention block
applied every `attn_every` layers (arXiv:2411.15242); counterpart of
`repro.models.hybrid`.

The shared block's weights are a single copy; each application keeps its
own KV cache. Layer parameters are stacked (G, A, ...), G groups of A mamba
layers, and the rest (R, ...): the forward loops over groups (A mamba
layers, then the shared block) and then over the rest. The shared block is
the same tensors in every group, so its gradient sums over the groups.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as TF
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dot_f32, rmsnorm
from repro_torch.models.transformer import P


def _group_shape(cfg: ArchConfig) -> tuple[int, int, int]:
    a = cfg.attn_every
    g = cfg.n_layers // a
    rest = cfg.n_layers - g * a
    return g, a, rest


def init_params(cfg: ArchConfig, seed: int = 0, device=None):
    g, a, rest = _group_shape(cfg)
    init = TF.Init(seed, device)
    params = {
        "embed": init.glorot((cfg.padded_vocab, cfg.d_model)),
        "mamba_groups": SSM.init_mamba2_params(init, cfg, lead=(g, a)),
        # "rest" is a (0, d_model) leaf when n_layers is a multiple of
        # attn_every, as in the reference.
        "mamba_norms": {
            "groups": init.const((g, a, cfg.d_model), 1.0),
            "rest": init.const((rest, cfg.d_model), 1.0),
        },
        "shared_attn": TF.init_layer_params(init, cfg),
        "final_norm": init.const((cfg.d_model,), 1.0),
        "lm_head": init.glorot((cfg.d_model, cfg.padded_vocab)),
    }
    if rest:
        params["mamba_rest"] = SSM.init_mamba2_params(init, cfg, lead=(rest,))
    return params


def param_specs(cfg: ArchConfig, m: str = "model"):
    g, a, rest = _group_shape(cfg)
    mspec = SSM.mamba2_param_specs(m)
    specs = {
        "embed": P(m, None),
        "mamba_groups": TF._prepend(mspec, (None, None)),
        "mamba_norms": {"groups": P(None, None, None), "rest": P(None, None)},
        "shared_attn": TF.layer_param_specs(cfg, m, stacked=False),
        "final_norm": P(None),
        "lm_head": P(None, m),
    }
    if rest:
        specs["mamba_rest"] = TF._prepend(mspec, (None,))
    return specs


def _mamba_layer(x, lp, norm_w, cfg, rules, cache=None):
    h = rmsnorm(x, norm_w, cfg.norm_eps)
    out, new_cache = SSM.mamba2_block(h, lp, cfg, cache=cache)
    x = x + out
    return TF._constrain(x, rules.act(), rules), new_cache


def forward(params, tokens, cfg: ArchConfig, rules: TF.ShardingRules,
            prefix_embeds=None, window: int | None = None):
    g, a, rest = _group_shape(cfg)
    w = cfg.sliding_window if window is None else window
    x = TF.embed(params, tokens)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    x = TF._constrain(x, rules.act(), rules)
    shared = params["shared_attn"]

    def mamba_body(carry, lp, nw):
        return _mamba_layer(carry, lp, nw, cfg, rules)[0]

    mamba_body = TF.remat(mamba_body, cfg)
    norms = params["mamba_norms"]
    for gi in range(g):
        group = TF._layer(params["mamba_groups"], gi)
        for ai in range(a):
            x = mamba_body(x, TF._layer(group, ai), norms["groups"][gi, ai])
        x, _ = TF._layer_fwd(x, shared, cfg, positions, rules, w)
    for ri in range(rest):
        x = mamba_body(x, TF._layer(params["mamba_rest"], ri), norms["rest"][ri])

    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return dot_f32(x, params["lm_head"]), {}


def init_cache(cfg: ArchConfig, batch: int, capacity: int, dtype=torch.bfloat16,
               device=None):
    g, a, rest = _group_shape(cfg)
    dev = resolve_device(device)
    k, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    cache = {
        "mamba_groups": SSM.mamba_cache(cfg, batch, (g, a), dev),
        "attn": {
            "k": torch.zeros((g, batch, capacity, k, hd), dtype=dtype, device=dev),
            "v": torch.zeros((g, batch, capacity, k, hd), dtype=dtype, device=dev),
        },
    }
    if rest:
        cache["mamba_rest"] = SSM.mamba_cache(cfg, batch, (rest,), dev)
    return cache


def cache_specs(cfg: ArchConfig, rules: TF.ShardingRules, m: str = "model"):
    g, a, rest = _group_shape(cfg)

    def mspec(n_lead):
        lead = (None,) * n_lead
        return {
            "conv": {
                "x": P(*lead, rules.batch, None, m),
                "b": P(*lead, rules.batch, None, None),
                "c": P(*lead, rules.batch, None, None),
            },
            "state": P(*lead, rules.batch, m, None, None),
        }

    specs = {
        "mamba_groups": mspec(2),
        "attn": {
            "k": P(None, rules.batch, rules.seq, None, None),
            "v": P(None, rules.batch, rules.seq, None, None),
        },
    }
    if rest:
        specs["mamba_rest"] = mspec(1)
    return specs


def decode_step(params, token, cache, cache_index, cfg: ArchConfig,
                rules: TF.ShardingRules, window: int | None = None):
    g, a, rest = _group_shape(cfg)
    w = cfg.sliding_window if window is None else window
    x = TF.embed(params, token)
    positions = TF.decode_positions(cache_index, x.device)
    shared = params["shared_attn"]
    norms = params["mamba_norms"]
    groups, attn = [], []
    for gi in range(g):
        gp, gc = TF._layer(params["mamba_groups"], gi), TF._layer(cache["mamba_groups"], gi)
        layer_caches = []
        for ai in range(a):
            x, nc = _mamba_layer(x, TF._layer(gp, ai), norms["groups"][gi, ai], cfg, rules,
                                 cache=TF._layer(gc, ai))
            layer_caches.append(nc)
        groups.append(TF._stack(layer_caches))
        x, (nac, _) = TF._layer_fwd(x, shared, cfg, positions, rules, w,
                                    cache=TF._layer(cache["attn"], gi),
                                    cache_index=cache_index)
        attn.append(nac)
    new_cache = {"mamba_groups": TF._stack(groups), "attn": TF._stack(attn)}
    if rest:
        rest_caches = []
        for ri in range(rest):
            x, nc = _mamba_layer(x, TF._layer(params["mamba_rest"], ri), norms["rest"][ri],
                                 cfg, rules, cache=TF._layer(cache["mamba_rest"], ri))
            rest_caches.append(nc)
        new_cache["mamba_rest"] = TF._stack(rest_caches)

    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return dot_f32(x, params["lm_head"]), new_cache
