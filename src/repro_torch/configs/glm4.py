"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552 — RoPE, aggressive GQA (2 KV heads). [hf:THUDM/glm-4-9b]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    arch_type="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    sliding_window=8192,  # engaged only for long_500k
    source="hf:THUDM/glm-4-9b",
)
