"""Resilience primitives shared across the training runtime; counterpart of
`repro.core.resilience`.

The vocabulary of failure: the exception taxonomy, the numeric-sentinel
policies, OOM classification, retry/backoff and chunk checksums, so that
booster.py, dmatrix.py and checkpoint/io.py speak the same language about
what failed and what the caller may do about it. `clamp_gradients` and
`finite_flags` run on the rows' device and read nothing on the host: the
round loop stacks the flags and reads them once a chunk.
"""
from __future__ import annotations

import time
import zlib
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.io import CheckpointError  # noqa: F401  (re-export)


class TrainingFault(RuntimeError):
    """Base class for failures the resilience layer detects and names."""


class NumericError(TrainingFault):
    """Non-finite gradients/hessians/leaf weights surfaced by the sentinel
    under the ``numeric_check="raise"`` policy."""


class DivergenceError(TrainingFault):
    """Eval metric became non-finite — the fit is diverging and later
    rounds can only make it worse."""


class ChunkIntegrityError(TrainingFault):
    """An external-memory chunk failed its crc32 on page-in: the bytes the
    device would train on are not the bytes recorded at build time."""


NUMERIC_POLICIES = ("off", "raise", "warn_skip", "clamp")

# Gradient/hessian magnitudes beyond this are treated as runaway under the
# "clamp" policy; generous enough that no healthy objective ever hits it.
CLAMP_LIMIT = 1e10


def validate_numeric_policy(policy: str) -> None:
    if policy not in NUMERIC_POLICIES:
        raise ValueError(
            f"numeric_check must be one of {NUMERIC_POLICIES}, got {policy!r}"
        )


def clamp_gradients(gh: torch.Tensor) -> torch.Tensor:
    """Replace NaN with 0 and clip +-inf / runaway magnitudes, keeping the
    round usable under the "clamp" policy. float32 rounds CLAMP_LIMIT to
    the same value the reference's clip gives."""
    gh = torch.nan_to_num(gh, nan=0.0, posinf=CLAMP_LIMIT, neginf=-CLAMP_LIMIT)
    return torch.clamp(gh, -CLAMP_LIMIT, CLAMP_LIMIT)


def finite_flags(*arrays: torch.Tensor) -> torch.Tensor:
    """0-d bool tensor on the arrays' device: True iff every element of
    every array is finite. Never read on the host here."""
    ok = None
    for a in arrays:
        fin = torch.isfinite(a).all()
        ok = fin if ok is None else ok & fin
    return ok if ok is not None else torch.ones((), dtype=torch.bool)


def is_oom(exc: BaseException) -> bool:
    """True for a device out-of-memory error: `torch.OutOfMemoryError`,
    CUDA's "out of memory" message, and the simulated stand-in from
    repro_torch.testing.faults (RESOURCE_EXHAUSTED, the reference's marker)."""
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    msg = str(exc)
    return ("RESOURCE_EXHAUSTED" in msg or "Out of memory" in msg
            or "CUDA out of memory" in msg)


def with_retries(
    fn: Callable[[], "object"],
    *,
    retries: int = 0,
    backoff: float = 0.0,
    retry_on: tuple = (IOError, OSError),
    describe: str = "operation",
    on_retry: Callable[[int, BaseException], None] | None = None,
):
    """Run `fn`, retrying up to `retries` times on `retry_on` exceptions with
    exponential backoff (backoff * 2**attempt seconds). The final failure is
    re-raised unchanged so callers keep the original type."""
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as exc:
            if attempt >= retries:
                raise
            if on_retry is not None:
                on_retry(attempt, exc)
            if backoff > 0:
                time.sleep(backoff * (2.0 ** attempt))
            attempt += 1


def crc32_chunks(stack: np.ndarray) -> tuple:
    """crc32 of each leading-axis slot of a host array (the per-chunk packed
    words of an ExternalDMatrix), as a tuple of ints."""
    arr = np.ascontiguousarray(stack)
    return tuple(zlib.crc32(arr[i].tobytes()) & 0xFFFFFFFF
                 for i in range(arr.shape[0]))


def verify_chunk_crcs(stack: np.ndarray, expected: Sequence[int],
                      context: str = "ExternalDMatrix") -> None:
    """Raise ChunkIntegrityError naming every chunk whose crc32 no longer
    matches the build-time record."""
    got = crc32_chunks(stack)
    bad = [i for i, (g, e) in enumerate(zip(got, expected)) if g != e]
    if bad:
        raise ChunkIntegrityError(
            f"{context}: chunk checksum mismatch on page-in for chunk(s) "
            f"{bad} — data corrupted between build and load "
            f"(expected crc32 {[expected[i] for i in bad]}, "
            f"got {[got[i] for i in bad]})"
        )
