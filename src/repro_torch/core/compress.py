"""Bit-packed quantised matrix (paper §2.2); counterpart of `repro.core.compress`.

Bin ids are packed into 32-bit words with `bits = ceil(log2(max_value+1))`
bits each. The layout is bit-identical to `repro.core.compress.pack`:
column-major per feature (symbols of feature f occupy packed[f, :]),
`spw = 32 // bits` symbols per word, symbol j of a word at shift j*bits, no
symbol straddling two words, rows zero-padded to a multiple of spw.

Words are stored as int32 tensors holding the uint32 bit patterns: torch on
the CPU has no `>>` on uint32, so shifts run in int64 after masking with
0xFFFFFFFF. The CUDA kernels read the same memory as `uint32_t`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

_WORD_MASK = 0xFFFFFFFF


def bits_needed(max_value: int) -> int:
    """ceil(log2(max_value + 1)), minimum 1."""
    return max(1, int(max_value).bit_length())


def symbols_per_word(bits: int) -> int:
    if not 1 <= bits <= 32:
        raise ValueError(f"bits must be in [1, 32], got {bits}")
    return 32 // bits


def words_as_uint(packed: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values, as int64."""
    return packed.to(torch.int64) & _WORD_MASK


def pack(bins: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack (n_rows, n_features) int bins -> (n_features, n_words) int32 words."""
    n, f = bins.shape
    spw = symbols_per_word(bits)
    n_pad = (-n) % spw
    b = bins.to(torch.int64) & ((1 << bits) - 1)
    b = torch.nn.functional.pad(b, (0, 0, 0, n_pad))
    b = b.t().reshape(f, -1, spw)
    shifts = torch.arange(spw, dtype=torch.int64, device=bins.device) * bits
    words = (b << shifts).sum(dim=-1)  # disjoint bit fields: sum == or
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def unpack(packed: torch.Tensor, bits: int, n_rows: int) -> torch.Tensor:
    """Inverse of pack: (n_features, n_words) words -> (n_rows, n_features) int32."""
    spw = symbols_per_word(bits)
    shifts = torch.arange(spw, dtype=torch.int64, device=packed.device) * bits
    b = (words_as_uint(packed)[:, :, None] >> shifts) & ((1 << bits) - 1)
    return b.reshape(packed.shape[0], -1)[:, :n_rows].t().to(torch.int32)


@dataclass(frozen=True)
class PackedBins:
    """The bit-packed matrix as the training representation: the tree grows
    straight from these words, the dense (n, f) bins never exist."""

    packed: torch.Tensor  # (n_features, n_words) int32 bit patterns
    bits: int
    n_rows: int


def gather_feature_bins(packed: torch.Tensor, bits: int, feat: torch.Tensor) -> torch.Tensor:
    """bins[i, feat[i]] for every row i straight from the packed words: one
    word gather plus a shift/mask per row. feat is (n,) int."""
    spw = symbols_per_word(bits)
    row = torch.arange(feat.shape[0], dtype=torch.int64, device=feat.device)
    word = words_as_uint(packed[feat.to(torch.int64), row // spw])
    shift = (row % spw) * bits
    return ((word >> shift) & ((1 << bits) - 1)).to(torch.int32)


@dataclass(frozen=True)
class CompressedMatrix:
    """The quantised + bit-packed training matrix ("ELLPACK page" analogue)."""

    packed: torch.Tensor  # (n_features, n_words) int32 bit patterns
    cuts: torch.Tensor  # (n_features, n_cuts) float32
    bits: int
    n_rows: int
    max_bins: int

    @property
    def n_features(self) -> int:
        return self.packed.shape[0]

    def nbytes_compressed(self) -> int:
        return self.packed.numel() * 4

    def nbytes_dense_fp32(self) -> int:
        return self.n_rows * self.n_features * 4

    def compression_ratio(self) -> float:
        return self.nbytes_dense_fp32() / self.nbytes_compressed()

    def as_packed_bins(self) -> PackedBins:
        return PackedBins(packed=self.packed, bits=self.bits, n_rows=self.n_rows)


def compress(bins: torch.Tensor, cuts: torch.Tensor, max_bins: int) -> CompressedMatrix:
    """Quantised matrix -> compressed form with the minimal bit width for
    the largest bin id present (as the paper and the reference do)."""
    bits = bits_needed(int(bins.max()))
    return CompressedMatrix(
        packed=pack(bins, bits),
        cuts=cuts,
        bits=bits,
        n_rows=bins.shape[0],
        max_bins=max_bins,
    )
