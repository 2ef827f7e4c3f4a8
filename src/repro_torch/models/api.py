"""Unified model interface over the five backbone families; counterpart of
`repro.models.api`, with the same fields and call signatures.

build_model(cfg) returns a Model whose functions take and return plain
trees of tensors:

  init_params(seed=0, device=None)     -> params (the reference takes a PRNG key)
  param_specs()                        -> partition-spec tree (mirrors params)
  loss_fn(params, batch, rules)        -> scalar (the train step's objective)
  forward_logits(params, batch, rules) -> logits (prefill / eval)
  init_cache(batch, capacity, dtype, device=None) -> decode cache tree
  cache_specs(rules)                   -> partition-spec tree of the cache
  decode_fn(params, batch, cache, index, rules) -> (logits, new_cache)

batch keys by family: tokens/targets (all), prefix_embeds (vlm),
src_embeds (audio / encdec; enc_out, the encoder's output, may stand in for
it in decode). `device=None` is the card; tests pass "cpu".
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import ssm_model as SM
from repro_torch.models import transformer as TF
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import NO_SHARDING, ShardingRules  # noqa: F401 (re-export)


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init_params: Callable
    param_specs: Callable
    loss_fn: Callable
    forward_logits: Callable
    init_cache: Callable
    cache_specs: Callable
    decode_fn: Callable
    supports_decode: bool = True


def _tf_model(cfg: ArchConfig) -> Model:
    def loss(params, batch, rules):
        return TF.loss_fn(params, batch, cfg, rules)

    def fwd(params, batch, rules):
        logits, _ = TF.forward(
            params, batch["tokens"], cfg, rules,
            prefix_embeds=batch.get("prefix_embeds"),
        )
        return logits

    def dec(params, batch, cache, index, rules):
        return TF.decode_step(params, batch["tokens"], cache, index, cfg, rules)

    return Model(
        cfg=cfg,
        init_params=lambda seed=0, device=None: TF.init_params(cfg, seed, device),
        param_specs=lambda m="model": TF.param_specs(cfg, m),
        loss_fn=loss,
        forward_logits=fwd,
        init_cache=lambda b, cap, dtype=torch.bfloat16, device=None: TF.init_cache(
            cfg, b, cap, dtype, device),
        cache_specs=lambda rules: TF.cache_specs(cfg, rules),
        decode_fn=dec,
    )


def _ssm_model(cfg: ArchConfig) -> Model:
    def loss(params, batch, rules):
        logits, _ = SM.forward(params, batch["tokens"], cfg, rules)
        return TF.xent_loss(logits, batch["targets"])

    def fwd(params, batch, rules):
        return SM.forward(params, batch["tokens"], cfg, rules)[0]

    def dec(params, batch, cache, index, rules):
        return SM.decode_step(params, batch["tokens"], cache, index, cfg, rules)

    return Model(
        cfg=cfg,
        init_params=lambda seed=0, device=None: SM.init_params(cfg, seed, device),
        param_specs=lambda m="model": SM.param_specs(cfg, m),
        loss_fn=loss,
        forward_logits=fwd,
        init_cache=lambda b, cap=0, dtype=torch.bfloat16, device=None: SM.init_cache(
            cfg, b, cap, dtype, device),
        cache_specs=lambda rules: SM.cache_specs(cfg, rules),
        decode_fn=dec,
    )


def _hybrid_model(cfg: ArchConfig) -> Model:
    def loss(params, batch, rules):
        logits, _ = HY.forward(params, batch["tokens"], cfg, rules)
        return TF.xent_loss(logits, batch["targets"])

    def fwd(params, batch, rules):
        return HY.forward(params, batch["tokens"], cfg, rules)[0]

    def dec(params, batch, cache, index, rules):
        return HY.decode_step(params, batch["tokens"], cache, index, cfg, rules)

    return Model(
        cfg=cfg,
        init_params=lambda seed=0, device=None: HY.init_params(cfg, seed, device),
        param_specs=lambda m="model": HY.param_specs(cfg, m),
        loss_fn=loss,
        forward_logits=fwd,
        init_cache=lambda b, cap, dtype=torch.bfloat16, device=None: HY.init_cache(
            cfg, b, cap, dtype, device),
        cache_specs=lambda rules: HY.cache_specs(cfg, rules),
        decode_fn=dec,
    )


def _encdec_model(cfg: ArchConfig) -> Model:
    def loss(params, batch, rules):
        logits, _ = ED.forward(params, batch, cfg, rules)
        return TF.xent_loss(logits, batch["targets"])

    def fwd(params, batch, rules):
        return ED.forward(params, batch, cfg, rules)[0]

    def dec(params, batch, cache, index, rules):
        # Serving encodes once a request (batch["enc_out"]); without it the
        # source is encoded inline.
        enc_out = batch.get("enc_out")
        if enc_out is None:
            enc_out = ED.encode(params, batch["src_embeds"], cfg, rules)
        return ED.decode_step(params, batch["tokens"], cache, index, enc_out, cfg, rules)

    return Model(
        cfg=cfg,
        init_params=lambda seed=0, device=None: ED.init_params(cfg, seed, device),
        param_specs=lambda m="model": ED.param_specs(cfg, m),
        loss_fn=loss,
        forward_logits=fwd,
        init_cache=lambda b, cap, dtype=torch.bfloat16, device=None: ED.init_cache(
            cfg, b, cap, dtype, device),
        cache_specs=lambda rules: ED.cache_specs(cfg, rules),
        decode_fn=dec,
    )


def build_model(cfg: ArchConfig) -> Model:
    if cfg.arch_type in ("dense", "moe", "vlm"):
        return _tf_model(cfg)
    if cfg.arch_type == "ssm":
        return _ssm_model(cfg)
    if cfg.arch_type == "hybrid":
        return _hybrid_model(cfg)
    if cfg.arch_type in ("encdec", "audio"):
        return _encdec_model(cfg)
    raise ValueError(f"unknown arch_type {cfg.arch_type}")
