"""Fault-injection harness for the resilience layer; counterpart of
`repro.testing.faults`, with the same sites, API and error types.

Production code exposes *failure points*: named sites where the failures
that matter at scale (device OOM, corrupted host-paged chunks, non-finite
gradients, failed checkpoint writes) can be provoked on demand. Each site
is a single cheap call (`check` or `corrupt_array`) that is a no-op unless
a fault has been armed for it, so the hooks cost nothing in normal
operation and nothing is monkeypatched in tests: a test arms a fault, runs
the real code path, and asserts the resilience machinery (detection,
retry, policy, fallback) responds.

Known sites (the production call points):

  * ``chunk_load``       — ExternalDMatrix page-in (host -> device copy);
                           raises a transient error, exercising retry/backoff.
  * ``chunk_corrupt``    — bit-flips one word of the host chunk stack on
                           page-in; the per-chunk crc32 must catch it.
  * ``checkpoint_write`` — checkpoint/io.save_pytree; raises an OSError
                           before any bytes are written (atomicity check).
  * ``oom``              — Booster training dispatch; raises SimulatedOOM
                           (its message carries RESOURCE_EXHAUSTED, so one
                           `resilience.is_oom` recognises it and a real
                           out-of-memory error), driving
                           ``fit(on_oom="external")``.
  * ``nan_grad``         — gradient corruption at a chosen boosting round
                           (payload: round=, value=); drives the numeric
                           sentinel's policies.

The port runs its rounds eagerly and caches no traced program, but
`trace_key` stays, so callers and tests keep the reference's names.

Usage::

    from repro_torch.testing import faults

    with faults.inject("chunk_load", error=faults.TransientLoadError, times=2):
        dmat.packed_bins()   # first two attempts fail, retry succeeds

Arming is process-local and NOT thread-safe — the harness is for tests.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

SITES = ("chunk_load", "chunk_corrupt", "checkpoint_write", "oom", "nan_grad")


class TransientLoadError(IOError):
    """A retryable chunk-load failure (the kind backoff should absorb)."""


class SimulatedOOM(RuntimeError):
    """Stands in for a device out-of-memory error, which cannot be provoked
    deterministically on a test-sized host. Its message keeps the
    reference's RESOURCE_EXHAUSTED marker."""

    def __init__(self, msg: str = "RESOURCE_EXHAUSTED: simulated device OOM"):
        super().__init__(msg)


@dataclass
class FaultSpec:
    """One armed fault: raise/corrupt at `site`, `times` activations
    (None = every hit), skipping the first `after` hits."""

    site: str
    error: Callable[[], BaseException] | type | None = None
    times: int | None = 1
    after: int = 0
    payload: dict = field(default_factory=dict)
    hits: int = 0  # times the site was reached
    fired: int = 0  # times the fault actually activated

    def should_fire(self) -> bool:
        self.hits += 1
        if self.hits <= self.after:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        self.fired += 1
        return True

    def make_error(self) -> BaseException:
        err = self.error or RuntimeError
        made = err() if isinstance(err, type) else err()
        if not isinstance(made, BaseException):
            raise TypeError(f"fault error factory returned {type(made)}")
        return made


_ACTIVE: dict[str, FaultSpec] = {}


def arm(site: str, *, error=None, times: int | None = 1, after: int = 0,
        **payload) -> FaultSpec:
    """Arm `site`. Unknown site names raise (catches typos in tests)."""
    if site not in SITES:
        raise ValueError(f"unknown fault site {site!r}; known: {SITES}")
    spec = FaultSpec(site=site, error=error, times=times, after=after,
                     payload=payload)
    _ACTIVE[site] = spec
    return spec


def disarm(site: str) -> None:
    _ACTIVE.pop(site, None)


def reset() -> None:
    _ACTIVE.clear()


def active(site: str) -> FaultSpec | None:
    return _ACTIVE.get(site)


@contextlib.contextmanager
def inject(site: str, *, error=None, times: int | None = 1, after: int = 0,
           **payload):
    """Context manager: arm on entry, disarm on exit. Yields the FaultSpec
    so tests can assert `spec.fired`."""
    spec = arm(site, error=error, times=times, after=after, **payload)
    try:
        yield spec
    finally:
        disarm(site)


# --- production-side hooks ---------------------------------------------------

def check(site: str) -> None:
    """Raise the armed fault's error at this failure point (no-op when the
    site is unarmed or its fire budget is exhausted)."""
    if not _ACTIVE:  # fast path: nothing armed anywhere
        return
    spec = _ACTIVE.get(site)
    if spec is not None and spec.should_fire():
        raise spec.make_error()


def corrupt_array(site: str, arr: np.ndarray) -> np.ndarray:
    """Bit-flip corruption hook: when `site` is armed, return a COPY of
    `arr` with one bit flipped (payload: chunk=, index=, bit= select the
    flat element within that chunk / leading slot). The input is never
    mutated — the corruption models damage in a transfer buffer, not in
    the caller's data."""
    if not _ACTIVE:
        return arr
    spec = _ACTIVE.get(site)
    if spec is None or not spec.should_fire():
        return arr
    out = np.array(arr, copy=True)
    chunk = int(spec.payload.get("chunk", 0))
    index = int(spec.payload.get("index", 0))
    bit = int(spec.payload.get("bit", 0))
    flat = out[chunk].reshape(-1)
    flat[index % flat.size] ^= np.asarray(
        1 << (bit % (flat.dtype.itemsize * 8)), flat.dtype
    )
    return out


def trace_key(site: str) -> tuple | None:
    """Hashable identity of the armed fault at `site` (None when unarmed).
    The reference keys its compiled programs by it; the port compiles no
    program per fault and keeps the function for callers that do."""
    spec = _ACTIVE.get(site)
    if spec is None:
        return None
    return (site, tuple(sorted(spec.payload.items())))
