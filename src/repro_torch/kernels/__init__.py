"""Hand-written CUDA kernels for Hopper (`csrc/`), their thin wrappers,
their plain PyTorch versions (`ref.py`) and the dispatch between them
(`ops.py`). Nothing is built or launched at import."""
