"""zamba2-7b [hybrid]: 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242]

81 Mamba2 layers with ONE weight-shared attention block applied every 6
mamba layers (13 applications + 3 trailing mamba layers). The shared block
keeps a separate KV cache per application. long_500k runs natively (SSM
state is O(1)); the shared attention uses its sliding window there.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    attn_every=6,
    sliding_window=8192,  # engaged for long_500k shared-attn blocks
    source="arXiv:2411.15242",
)
