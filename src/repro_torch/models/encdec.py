"""Encoder-decoder backbone (seamless-m4t style, arXiv:2308.11596);
counterpart of `repro.models.encdec`.

The audio frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings (B, S_src, D) that feed the encoder through a
learned input projection. The encoder is bidirectional self-attention; the
text decoder is causal self-attention (KV cache in decode) plus
cross-attention to the encoder output, whose K/V are computed from it in
each layer.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as TF
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _sdpa, attention_gqa, dot, dot_f32, dot_tp_out, rmsnorm
from repro_torch.models.transformer import P


def _cross_attn(x, enc_kv, p, *, n_heads, n_kv_heads, head_dim):
    """Queries from the decoder stream, keys/values from the encoder (no
    mask, no rope)."""
    b, s, _ = x.shape
    q = dot(x, p["wq"]).reshape(b, s, n_heads, head_dim)
    out = _sdpa(q, enc_kv["k"], enc_kv["v"], None)
    return dot_tp_out(out.reshape(b, s, n_heads * head_dim), p["wo"])


def cross_kv(enc_out, p, *, n_kv_heads, head_dim):
    b, t, _ = enc_out.shape
    k = dot(enc_out, p["wk"]).reshape(b, t, n_kv_heads, head_dim)
    v = dot(enc_out, p["wv"]).reshape(b, t, n_kv_heads, head_dim)
    return {"k": k, "v": v}


def init_dec_layer(init, cfg: ArchConfig, lead=()):
    base = TF.init_layer_params(init, cfg, lead)
    base["ln_x"] = init.const((cfg.d_model,), 1.0, lead)
    base["cross"] = TF.init_attn_params(init, cfg, lead)
    return base


def init_params(cfg: ArchConfig, seed: int = 0, device=None):
    init = TF.Init(seed, device)
    return {
        "src_proj": init.glorot((cfg.d_model, cfg.d_model)),
        "enc_layers": TF.init_layer_params(init, cfg, lead=(cfg.n_enc_layers,)),
        "enc_norm": init.const((cfg.d_model,), 1.0),
        "embed": init.glorot((cfg.padded_vocab, cfg.d_model)),
        "dec_layers": init_dec_layer(init, cfg, lead=(cfg.n_layers,)),
        "final_norm": init.const((cfg.d_model,), 1.0),
        "lm_head": init.glorot((cfg.d_model, cfg.padded_vocab)),
    }


def param_specs(cfg: ArchConfig, m: str = "model"):
    dec = TF.layer_param_specs(cfg, m, stacked=True)
    dec["ln_x"] = P(None, None)
    dec["cross"] = TF._prepend(TF.attn_param_specs(cfg, m), (None,))
    return {
        "src_proj": P(None, None),
        "enc_layers": TF.layer_param_specs(cfg, m, stacked=True),
        "enc_norm": P(None),
        "embed": P(m, None),
        "dec_layers": dec,
        "final_norm": P(None),
        "lm_head": P(None, m),
    }


def encode(params, src_embeds, cfg: ArchConfig, rules: TF.ShardingRules):
    x = dot(src_embeds.to(torch.bfloat16), params["src_proj"])
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = TF._constrain(x, rules.act(), rules)

    def body(carry, lp):
        h = rmsnorm(carry, lp["ln1"], cfg.norm_eps)
        attn_out, _ = attention_gqa(
            h, lp["attn"], n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            positions=positions, causal=False,
        )
        y = carry + attn_out
        h = rmsnorm(y, lp["ln2"], cfg.norm_eps)
        return TF._constrain(y + TF.ffn_dense(h, lp["ffn"]), rules.act(), rules)

    body = TF.remat(body, cfg)
    for i in range(TF.n_stacked(params["enc_layers"])):
        x = body(x, TF._layer(params["enc_layers"], i))
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _dec_layer(x, lp, enc_kv, cfg, positions, rules, cache=None, cache_index=None):
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    attn_out, new_cache = attention_gqa(
        h, lp["attn"], n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        positions=positions, cache=cache, cache_index=cache_index,
    )
    x = x + attn_out
    h = rmsnorm(x, lp["ln_x"], cfg.norm_eps)
    x = x + _cross_attn(
        h, enc_kv, lp["cross"], n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
    )
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    x = TF._constrain(x + TF.ffn_dense(h, lp["ffn"]), rules.act(), rules)
    return x, new_cache


def forward(params, batch, cfg: ArchConfig, rules: TF.ShardingRules):
    """Training / prefill forward. batch: src_embeds (B, Ss, D), tokens
    (B, St)."""
    enc_out = encode(params, batch["src_embeds"], cfg, rules)
    x = TF.embed(params, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = TF._constrain(x, rules.act(), rules)

    def body(carry, lp):
        ekv = cross_kv(enc_out, lp["cross"], n_kv_heads=cfg.n_kv_heads,
                       head_dim=cfg.resolved_head_dim)
        return _dec_layer(carry, lp, ekv, cfg, positions, rules)[0]

    body = TF.remat(body, cfg)
    for i in range(TF.n_stacked(params["dec_layers"])):
        x = body(x, TF._layer(params["dec_layers"], i))
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return dot_f32(x, params["lm_head"]), {}


def init_cache(cfg: ArchConfig, batch: int, capacity: int, dtype=torch.bfloat16,
               device=None):
    dev = resolve_device(device)
    k, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((cfg.n_layers, batch, capacity, k, hd), dtype=dtype, device=dev),
        "v": torch.zeros((cfg.n_layers, batch, capacity, k, hd), dtype=dtype, device=dev),
    }


def cache_specs(cfg: ArchConfig, rules: TF.ShardingRules):
    return {
        "k": P(None, rules.batch, rules.seq, None, None),
        "v": P(None, rules.batch, rules.seq, None, None),
    }


def decode_step(params, token, cache, cache_index, enc_out,
                cfg: ArchConfig, rules: TF.ShardingRules):
    """One decode step; enc_out (B, Ss, D) from `encode`."""
    x = TF.embed(params, token)
    positions = TF.decode_positions(cache_index, x.device)
    new = []
    for i in range(TF.n_stacked(params["dec_layers"])):
        lp = TF._layer(params["dec_layers"], i)
        ekv = cross_kv(enc_out, lp["cross"], n_kv_heads=cfg.n_kv_heads,
                       head_dim=cfg.resolved_head_dim)
        x, nc = _dec_layer(x, lp, ekv, cfg, positions, rules,
                           cache=TF._layer(cache, i), cache_index=cache_index)
        new.append(nc)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return dot_f32(x, params["lm_head"]), TF._stack(new)
