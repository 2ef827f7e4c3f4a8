"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192, MoE 128 experts top-1, vocab=202048 — MoE, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]

All layers are MoE with switch (top-1) routing over 128 experts; experts
are sharded over the `model` mesh axis (8 experts/chip at model=16).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    n_experts=128,
    top_k=1,
    sliding_window=8192,  # engaged only for long_500k
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
