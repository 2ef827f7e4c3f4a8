"""minicpm3-4b [dense]: 62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA
(multi-head latent attention). [hf:openbmb/MiniCPM3-4B]

MLA compresses the KV state to a rank-256 latent + one shared RoPE key:
the decode cache stores kv_lora_rank + rope_head_dim = 288 floats/token
instead of 2*40*64 = 5120 — an 17.8x KV-cache compression, the same
memory-per-token play as the paper's bit-packed quantised matrix (§2.2).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    arch_type="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attention="mla",
    kv_lora_rank=256,
    q_lora_rank=768,
    rope_head_dim=32,
    nope_head_dim=64,
    sliding_window=8192,  # engaged only for long_500k
    source="hf:openbmb/MiniCPM3-4B",
)
