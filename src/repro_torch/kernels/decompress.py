"""Wrapper of the bit-unpack CUDA kernel (`csrc/decompress.cu`).

Counterpart of `repro.kernels.decompress.decompress`: packed words
(F, W) -> bins (n_rows, F) int32, row-major, equal to
`core.compress.unpack` (its plain version). Words are int32 tensors holding
the uint32 bit patterns.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as B


def decompress(packed: torch.Tensor, bits: int, n_rows: int) -> torch.Tensor:
    """Bins (n_rows, F) int32 unpacked on the card: any F, any bits in
    [1, 32], and outputs past 2^31 elements (n_rows itself below 2^31)."""
    B.expect(packed, "packed", torch.int32, 2)
    if not 1 <= bits <= 32:
        raise ValueError(f"bits must be in [1, 32], got {bits}")
    f, w = packed.shape
    if not 0 <= n_rows <= w * (32 // bits):
        raise ValueError(f"{w} words of {bits}-bit symbols hold fewer than "
                         f"{n_rows} rows")
    if max(n_rows, w) >= 2**31:
        raise ValueError(f"decompress takes fewer than 2^31 rows and words, got "
                         f"{n_rows} rows in {w} words")
    dev = packed.device
    out = torch.empty((n_rows, f), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    B.launch("rt_decompress", dev,
             packed.data_ptr(), out.data_ptr(), n_rows, f, w,
             bits)
    B.count(decompress)
    return out


decompress.launches = 0
