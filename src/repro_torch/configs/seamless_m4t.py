"""seamless-m4t-medium [audio]: 12L d_model=1024 16H d_ff=4096
vocab=256206 — encoder-decoder, multimodal. [arXiv:2308.11596]

12 encoder + 12 decoder layers (the model card's text/speech stacks are
12L each; n_layers here counts the decoder, n_enc_layers the encoder).
The audio frontend (mel + conv feature extractor) is a STUB per the brief:
input_specs() provides precomputed frame embeddings. long_500k is SKIPPED
for this arch (DESIGN.md §6): the translation decoder's target length is
architecturally bounded far below 500k tokens.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    n_layers=12,
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    source="arXiv:2308.11596",
)
