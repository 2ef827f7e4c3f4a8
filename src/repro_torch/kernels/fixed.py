"""64-bit fixed-point (g, h): the arithmetic of the card's histograms.

Upstream XGBoost's deterministic GPU histogram (its `GradientQuantiser`)
makes a histogram a function of its inputs alone by adding integers, whose
sum does not depend on the order of the adds. The port does the same on the
card, with this arithmetic, which the CUDA kernels (`csrc/histogram.cu`),
their fixed-point plain versions (`kernels/ref.py`) and the dense scatter
(`core/histogram.py`) share bit for bit:

* the exponent of a call: with max(|g|, |h|) < 2^e over its n rows (e from
  `frexp`, 0 when every value is 0), k = 62 - ceil(log2 n) - e, clipped to
  [-1022, 1022] so that 2^k and 2^-k are normal doubles. The max and n do
  not depend on the rows' order or layout, so a flat, a chunked and a
  streamed pass over the same rows share k. k is an int32 scalar on the
  rows' device: nothing reads it on the host. A non-finite value anywhere
  gives k = NONFINITE;
* each row quantised before any addition: q = round-half-even(v * 2^k) as
  int64 (the product is exact in float64). Then |q| <= 2^(e + k), and a sum
  of n of them is at most n 2^(e + k) <= 2^62 in magnitude, in any order;
* each sum converted once, after the last addition: float32(float64(sum) *
  2^-k). A bin of `count` rows is within count 2^-(k + 1) of the exact sum
  of its float32 inputs before that rounding.

Under NONFINITE every q is 0 and every converted entry NaN: a non-finite
(g, h) anywhere in a call makes the whole histogram NaN, so every gain is
non-finite and no split is taken.
"""
from __future__ import annotations

import torch

SUM_BITS = 62  # the bound on |sum q|: 2^62, below int64's 2^63
K_MIN, K_MAX = -1022, 1022  # 2^k and 2^-k normal doubles
NONFINITE = -(2**31)  # the exponent of a call whose (g, h) holds inf or NaN


def ceil_log2(n: int) -> int:
    """ceil(log2 n) for n >= 1, 0 for n <= 1."""
    return (n - 1).bit_length() if n > 1 else 0


def exponent(gh: torch.Tensor) -> torch.Tensor:
    """The call's exponent k (int32, 0-d, on gh's device) for the (n, 2)
    (g, h) of its n rows; see the module docstring."""
    return exponent_from_max(_top(gh), gh.shape[0])


def exponent_from_max(top: torch.Tensor, n_rows: int) -> torch.Tensor:
    """k for n_rows rows whose largest |g| or |h| is the 0-d `top`."""
    e = torch.frexp(top).exponent.to(torch.int32)  # top < 2^e; 0 for 0
    k = torch.clamp(SUM_BITS - ceil_log2(n_rows) - e, K_MIN, K_MAX)
    return torch.where(torch.isfinite(top), k, NONFINITE).to(torch.int32)


def _top(gh: torch.Tensor) -> torch.Tensor:
    if gh.numel() == 0:
        return torch.zeros((), dtype=gh.dtype, device=gh.device)
    return gh.abs().amax()


# Rows a running slab given no pass exponent makes room for: the most that
# one pass of the kernels (int32 row counts) can add.
SLAB_ROWS = 2**31


def running_exponent(slab: torch.Tensor, gh: torch.Tensor) -> torch.Tensor:
    """The exponent at which one chunk's rows (`gh`) add into an int64 slab
    that was given no pass exponent. The slab keeps its own, as the tensor
    attribute `fixed_exponent`, made with room for SLAB_ROWS rows; a chunk
    whose values need a smaller one first rescales the slab to it (every
    sum shifted right, rounding half up). The result is the same bits for
    the same chunks in the same order, but not those of one call over all
    the rows: the streamed pass hands every chunk its whole pass's
    exponent instead (`core.histogram.slab_exponent`)."""
    k = exponent_from_max(_top(gh), SLAB_ROWS)
    held = getattr(slab, "fixed_exponent", None)
    if held is not None:
        k = torch.minimum(held, k)
        d = (held.to(torch.int64) - k.to(torch.int64)).clamp(0, SUM_BITS)
        half = torch.where(d > 0, torch.ones_like(d) << (d - 1).clamp(min=0), 0)
        slab.copy_((slab + half) >> d)
    slab.fixed_exponent = k
    return k


def pow2(k: torch.Tensor) -> torch.Tensor:
    """2^k as a float64 tensor, built from its bits (exact on every device),
    for int k in [K_MIN, K_MAX]; 0 where k is NONFINITE."""
    ok = k != NONFINITE
    biased = (torch.where(ok, k, 0).to(torch.int64) + 1023) << 52
    return torch.where(ok, biased.view(torch.float64), 0.0)


def quantise(gh: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """int64 round-half-even(gh * 2^k), elementwise; 0 everywhere under
    NONFINITE (as the kernels quantise)."""
    x = torch.round(gh.to(torch.float64) * pow2(k))
    return torch.where(x == x, x, 0.0).to(torch.int64)


def dequantise(acc: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """float32(float64(acc) * 2^-k), elementwise: the conversion pass's
    plain version; NaN everywhere under NONFINITE."""
    ok = k != NONFINITE
    out = (acc.to(torch.float64) * pow2(torch.where(ok, -k, 0))).to(torch.float32)
    return torch.where(ok, out, float("nan"))
