"""Wrapper of the pairwise-gradient CUDA kernel (`csrc/pairwise.cu`).

The gradient of `rank:pairwise` over query groups. A port-only kernel: the
reference computes this function in XLA with no `pallas_call`
(`repro.core.objectives._pairwise_grad`, from an n x n pair mask). Its
plain version is `ref.pairwise_grad_ref`; `ops.query_groups` gives the
grouping it takes.

One call is two launches, counted as one: the query kernel (the queries of
at most `BLOCK_ROWS` rows, a block every `RANGE` sorted positions) and the
spread kernel (larger queries, tasks of two `CHUNK_ROWS`-row chunks dealt
out to a grid sized to the card). The sizes at which the work changes
hands, as in `pairwise.cu`: a query inside one aligned `WINDOW_ROWS`-position
window shares that window's warp with the others there; a query of at most
`BLOCK_ROWS` rows is one block's; a larger one is spread.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as B

WINDOW_ROWS = 32
BLOCK_ROWS = 256
CHUNK_ROWS = 256
RANGE = 256  # sorted positions of one query-kernel block


def pairwise_grad(
    scores: torch.Tensor,  # (n,) f32
    labels: torch.Tensor,  # (n,) f32
    order: torch.Tensor,  # (n,) int32: rows sorted stably by group id
    start: torch.Tensor,  # (n,) int32: each sorted position's group span
    end: torch.Tensor,  # (n,) int32
) -> torch.Tensor:
    """(n, 2) f32 (g, h) in row order, h floored at 1e-6; within
    2e-6 * (1 + the row's summed term magnitudes) of `ref.pairwise_grad_ref`,
    the same bits on every call."""
    B.expect(scores, "scores", torch.float32, 1)
    B.expect(labels, "labels", torch.float32, 1)
    for name, t in (("order", order), ("start", start), ("end", end)):
        B.expect(t, name, torch.int32, 1)
    n = scores.shape[0]
    if any(t.shape[0] != n for t in (labels, order, start, end)):
        raise ValueError(f"scores, labels, order, start and end must all have {n} rows")
    if n >= 2**31:
        raise ValueError(f"pairwise_grad takes fewer than 2^31 rows, got {n}")
    dev = scores.device
    out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    B.launch("rt_pairwise_grad", dev,
             scores.data_ptr(), labels.data_ptr(), order.data_ptr(),
             start.data_ptr(), end.data_ptr(), out.data_ptr(), scratch(n, dev).data_ptr(), n)
    B.count(pairwise_grad)
    return out


pairwise_grad.launches = 0


def scratch(n: int, device: torch.device) -> torch.Tensor:
    """The kernels' int64 scratch, written before it is read: the spread
    queries' fixed-point (g, h) and finished-task counts a sorted position,
    then two a query-kernel block (the rows and head of a spread query)."""
    return torch.empty(3 * n + 2 * -(-n // RANGE), dtype=torch.int64, device=device)
