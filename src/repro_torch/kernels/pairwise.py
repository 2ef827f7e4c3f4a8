"""Wrapper of the pairwise-gradient CUDA kernel (`csrc/pairwise.cu`).

The gradient of `rank:pairwise` over query groups. A port-only kernel: the
reference computes this function in XLA with no `pallas_call`
(`repro.core.objectives._pairwise_grad`, from an n x n pair mask). Its
plain version is `ref.pairwise_grad_ref`; `ops.query_groups` gives the
grouping it takes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as B


def pairwise_grad(
    scores: torch.Tensor,  # (n,) f32
    labels: torch.Tensor,  # (n,) f32
    order: torch.Tensor,  # (n,) int32: rows sorted stably by group id
    start: torch.Tensor,  # (n,) int32: each sorted position's group span
    end: torch.Tensor,  # (n,) int32
) -> torch.Tensor:
    """(n, 2) f32 (g, h) in row order, h floored at 1e-6; within
    2e-6 * (1 + the row's summed term magnitudes) of `ref.pairwise_grad_ref`."""
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
    err = B.lib().rt_pairwise_grad(scores.data_ptr(), labels.data_ptr(), order.data_ptr(),
                                   start.data_ptr(), end.data_ptr(), out.data_ptr(), n,
                                   B.stream(dev))
    B.check(err, "pairwise_grad")
    pairwise_grad.launches += 1
    return out


pairwise_grad.launches = 0
