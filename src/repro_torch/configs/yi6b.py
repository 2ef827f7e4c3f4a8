"""yi-6b [dense]: 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 —
llama-architecture GQA. [arXiv:2403.04652]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b",
    arch_type="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    sliding_window=8192,  # engaged only for long_500k
    source="arXiv:2403.04652",
)
