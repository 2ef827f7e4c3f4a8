"""stablelm-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352. [hf:stabilityai/stablelm-2-1_6b]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    arch_type="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    sliding_window=8192,  # engaged only for long_500k
    source="hf:stabilityai/stablelm-2-1_6b",
)
