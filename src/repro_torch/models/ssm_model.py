"""Pure-SSM LM (mamba2-2.7b): a stack of Mamba2 blocks, attention-free;
counterpart of `repro.models.ssm_model`. Decode carries O(1) float32 state
a layer, no KV cache."""
from __future__ import annotations

from repro_torch.device import resolve_device
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as TF
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dot_f32, rmsnorm
from repro_torch.models.transformer import P


def init_params(cfg: ArchConfig, seed: int = 0, device=None):
    init = TF.Init(seed, device)
    return {
        "embed": init.glorot((cfg.padded_vocab, cfg.d_model)),
        "layers": SSM.init_mamba2_params(init, cfg, lead=(cfg.n_layers,)),
        "layer_norms": init.const((cfg.n_layers, cfg.d_model), 1.0),
        "final_norm": init.const((cfg.d_model,), 1.0),
        "lm_head": init.glorot((cfg.d_model, cfg.padded_vocab)),
    }


def param_specs(cfg: ArchConfig, m: str = "model"):
    return {
        "embed": P(m, None),
        "layers": TF._prepend(SSM.mamba2_param_specs(m), (None,)),
        "layer_norms": P(None, None),
        "final_norm": P(None),
        "lm_head": P(None, m),
    }


def forward(params, tokens, cfg: ArchConfig, rules: TF.ShardingRules):
    x = TF.embed(params, tokens)
    x = TF._constrain(x, rules.act(), rules)

    def body(carry, lp, nw):
        h = rmsnorm(carry, nw, cfg.norm_eps)
        out, _ = SSM.mamba2_block(h, lp, cfg)
        return TF._constrain(carry + out, rules.act(), rules)

    body = TF.remat(body, cfg)
    for i in range(cfg.n_layers):
        x = body(x, TF._layer(params["layers"], i), params["layer_norms"][i])
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return dot_f32(x, params["lm_head"]), {}


def init_cache(cfg: ArchConfig, batch: int, capacity: int = 0, dtype=None, device=None):
    """Stacked (L, ...) conv histories and states, float32 whatever
    `dtype` says (as the reference's)."""
    return SSM.mamba_cache(cfg, batch, (cfg.n_layers,), resolve_device(device))


def cache_specs(cfg: ArchConfig, rules: TF.ShardingRules, m: str = "model"):
    return {
        "conv": {
            "x": P(None, rules.batch, None, m),
            "b": P(None, rules.batch, None, None),
            "c": P(None, rules.batch, None, None),
        },
        "state": P(None, rules.batch, m, None, None),
    }


def decode_step(params, token, cache, cache_index, cfg: ArchConfig,
                rules: TF.ShardingRules):
    x = TF.embed(params, token)
    new = []
    for i in range(cfg.n_layers):
        h = rmsnorm(x, params["layer_norms"][i], cfg.norm_eps)
        out, nc = SSM.mamba2_block(h, TF._layer(params["layers"], i), cfg,
                                   cache=TF._layer(cache, i))
        x = x + out
        new.append(nc)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return dot_f32(x, params["lm_head"]), TF._stack(new)
