"""Architecture config schema for the assigned-architecture substrate; the
port's own copy of `repro.models.config`, field for field.

One frozen dataclass drives parameter init, forward functions, sharding
specs and the dry-run input specs. Exact assigned configs live in
repro_torch/configs/<id>.py; reduced variants for smoke tests come from
ArchConfig.reduced().
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    attention: str = "gqa"  # gqa | mla | none (ssm)
    sliding_window: int = 0  # 0 = full attention; >0 = SWA (sub-quadratic)
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    # --- hybrid (zamba2): shared attention block every N mamba layers ---
    attn_every: int = 0
    # --- MLA (minicpm3) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 32
    nope_head_dim: int = 64
    v_head_dim: int = 0  # 0 -> nope_head_dim
    # --- encoder-decoder (seamless) ---
    n_enc_layers: int = 0
    # --- multimodal stubs: frontend provides this many embedding tokens ---
    n_prefix_tokens: int = 0
    # --- numerics ---
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    remat: bool = True
    # "full" = save only layer boundaries (recompute everything incl. dots);
    # "dots_saveable" = keep matmul outputs, recompute elementwise only
    # (§Perf iteration: trades HBM for ~25% fewer backward FLOPs and fewer
    # recomputed TP collectives). Default = the optimized setting; the
    # paper-faithful-style "full" baseline is archived in
    # experiments/dryrun_baseline/ (EXPERIMENTS.md §Perf).
    remat_policy: str = "dots_saveable"
    # KV-cache storage dtype for GQA decode: "bfloat16" (default) or "int8"
    # (per-token-per-head absmax quantisation — the paper's §2.2 compression
    # insight applied to the serving-side memory bottleneck; §Perf bonus).
    kv_cache_dtype: str = "bfloat16"
    tie_embeddings: bool = False
    source: str = ""  # paper / model card citation

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the vocab-sharded embed
        and lm_head divide evenly across the model axis (and stay 128-lane
        aligned). Standard practice (megatron's make_vocab_size_divisible);
        targets never index the padding."""
        return -(-self.vocab_size // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_v_head_dim(self) -> int:
        return self.v_head_dim or self.nope_head_dim

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def reduced(self, n_layers: int = 2, d_model: int = 256) -> "ArchConfig":
        """Reduced same-family variant for CPU smoke tests (brief: <=2
        layers, d_model<=512, <=4 experts)."""
        scale = d_model / self.d_model
        heads = max(2, min(4, self.n_heads))
        kv = max(1, min(heads, self.n_kv_heads))
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=d_model // heads,
            d_ff=max(64, int(self.d_ff * scale) // 64 * 64) if self.d_ff else 0,
            vocab_size=512,
            n_experts=min(self.n_experts, 4),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=32 if self.ssm_state else self.ssm_chunk,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            kv_lora_rank=64 if self.kv_lora_rank else 0,
            q_lora_rank=96 if self.q_lora_rank else 0,
            rope_head_dim=16 if self.kv_lora_rank else self.rope_head_dim,
            nope_head_dim=32 if self.kv_lora_rank else self.nope_head_dim,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_prefix_tokens=min(self.n_prefix_tokens, 8),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            remat=False,
        )


@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
