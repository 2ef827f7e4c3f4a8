"""input_specs(): meta-tensor stand-ins and partition specs for every
(architecture x input-shape) combination, no allocation anywhere;
counterpart of `repro.launch.specs`.

A meta tensor (`torch.empty(shape, dtype=..., device="meta")`) is the
port's `jax.ShapeDtypeStruct`: shape and dtype, no storage. Partition
specs are tuples, as `transformer.P` builds them.

Modality frontends are stubs, as in the reference: VLM batches carry
precomputed patch embeddings (576 tokens, CLIP ViT-L/14 grid), audio
batches precomputed frame embeddings; both feed the backbone directly.

Sliding windows are a per-shape decision: the config's `sliding_window`
is the available variant and is engaged only for long_500k; every other
shape runs full attention.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist.mesh import Mesh
from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig
from repro_torch.models.transformer import P, ShardingRules

AUDIO_SRC_FRAMES = 4096  # stub frontend: fixed source frame budget


def cfg_for_shape(cfg: ArchConfig, shape: ShapeConfig) -> ArchConfig:
    """Engage the sliding-window variant only for long_500k."""
    if shape.name != "long_500k":
        return dataclasses.replace(cfg, sliding_window=0)
    return cfg


def supports_shape(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    if shape.name == "long_500k":
        if cfg.arch_type in ("encdec", "audio"):
            return False, (
                "enc-dec translation decoder: target length architecturally "
                "bounded far below 500k (DESIGN.md §6)"
            )
        if cfg.arch_type in ("dense", "moe", "vlm") and not cfg.sliding_window:
            return False, "pure full-attention arch without a sub-quadratic variant"
    return True, ""


def rules_for(mesh: Mesh, shape: ShapeConfig) -> ShardingRules:
    bt = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    if shape.kind == "decode":
        if shape.global_batch == 1:  # long_500k: shard the cache sequence
            seq = tuple(mesh.axis_names)  # all axes
            return ShardingRules(batch=None, model="model", seq=seq)
        return ShardingRules(batch=bt, model="model", seq="model")
    return ShardingRules(batch=bt, model="model", seq=None)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """The batch of this shape's step function, as meta tensors."""
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    i32, f32 = torch.int32, torch.float32

    if shape.kind in ("train", "prefill"):
        specs = {}
        if cfg.arch_type == "vlm":
            text = s - cfg.n_prefix_tokens
            specs["prefix_embeds"] = _meta((b, cfg.n_prefix_tokens, d), f32)
            specs["tokens"] = _meta((b, text), i32)
            if shape.kind == "train":
                specs["targets"] = _meta((b, text), i32)
        elif cfg.arch_type in ("audio", "encdec"):
            specs["src_embeds"] = _meta((b, min(s, AUDIO_SRC_FRAMES), d), f32)
            specs["tokens"] = _meta((b, s), i32)
            if shape.kind == "train":
                specs["targets"] = _meta((b, s), i32)
        else:
            specs["tokens"] = _meta((b, s), i32)
            if shape.kind == "train":
                specs["targets"] = _meta((b, s), i32)
        return specs

    # decode: ONE new token against a cache of seq_len (or window) entries.
    specs = {"tokens": _meta((b, 1), i32)}
    if cfg.arch_type in ("audio", "encdec"):
        # encoder output is precomputed at serve time (not re-encoded per step)
        specs["enc_out"] = _meta((b, min(s, AUDIO_SRC_FRAMES), d), f32)
    return specs


def batch_partition_specs(cfg: ArchConfig, shape: ShapeConfig,
                          rules: ShardingRules) -> dict:
    bt = rules.batch
    specs = {}
    for k in input_specs(cfg, shape):
        if k in ("tokens", "targets"):
            specs[k] = P(bt, None)
        else:  # embeddings (B, S, D)
            specs[k] = P(bt, None, None)
    return specs


def cache_capacity(cfg: ArchConfig, shape: ShapeConfig) -> int:
    """Decode cache capacity: full seq_len, or the sliding window when the
    SWA variant is engaged (long_500k)."""
    cfg = cfg_for_shape(cfg, shape)
    if cfg.sliding_window and shape.name == "long_500k":
        return cfg.sliding_window
    return shape.seq_len


def shape_by_name(name: str) -> ShapeConfig:
    return SHAPES[name]
