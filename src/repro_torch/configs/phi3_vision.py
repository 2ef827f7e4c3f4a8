"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064 — phi3-mini LM backbone + CLIP vision frontend.
[hf:microsoft/Phi-3-vision-128k-instruct]

The vision frontend (CLIP ViT-L/14 + projector) is a STUB per the brief:
input_specs() provides 576 precomputed patch embeddings per image, consumed
through a learned projection by the decoder-only LM backbone implemented
here. For long_500k the backbone runs the sliding-window variant (the real
phi3 family uses blocksparse/LongRoPE for 128k; SWA is our documented
sub-quadratic carve-out, DESIGN.md §6).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    n_prefix_tokens=576,  # 24x24 CLIP patches per image
    sliding_window=8192,  # engaged only for the long_500k shape
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)
