"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192,
MoE 16 experts top-1, vocab=202048 — MoE, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    n_experts=16,
    top_k=1,
    sliding_window=8192,  # engaged only for long_500k
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
