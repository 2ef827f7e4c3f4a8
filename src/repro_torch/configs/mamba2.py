"""mamba2-2.7b [ssm]: 64L d_model=2560 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060]

Pure Mamba2 stack; decode state is O(1) per layer so long_500k is the
native use case (no KV cache at all).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    attention="none",
    ssm_state=128,
    ssm_head_dim=64,
    source="arXiv:2405.21060",
)
