"""Gradients and hessians of the objectives, in plain torch.

binary:logistic: p = sigmoid(m), g = p - y, h = p (1 - p) (the paper's
eqs 1-2). rank:pairwise: within each query, for every pair with
y_i > y_j, rho = sigmoid(s_j - s_i) is taken from g_i and added to g_j, and
rho (1 - rho) added to both hessians; h is floored at 1e-6, where a row has
no comparable pair. Rows are grouped by query, `sizes` giving each query's
rows in order. Computed in `dtype` (float64 for the judge; the control's
lower precision), the pairwise sums in padded blocks of queries of like
size so that no n x n mask is ever built.
"""
from __future__ import annotations

import torch

PAIR_BLOCK = 1 << 24  # padded pair entries a block


def logistic(m: torch.Tensor, y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    p = torch.sigmoid(m.to(dtype))
    return torch.stack([p - y.to(dtype), p * (1.0 - p)], dim=1)


class QueryBlocks:
    """Queries sorted by size and cut into blocks of at most PAIR_BLOCK
    padded pair entries: each block a (queries, width) row-index table."""

    def __init__(self, sizes: torch.Tensor):
        dev = sizes.device
        sizes = sizes.to(torch.int64)
        starts = torch.cumsum(sizes, 0) - sizes
        order = torch.argsort(sizes.cpu(), stable=True)
        s_host = sizes.cpu()[order].tolist()
        self.blocks = []
        a = 0
        while a < len(s_host):
            b = a + 1
            while b < len(s_host) and (b + 1 - a) * s_host[b] ** 2 <= PAIR_BLOCK:
                b += 1
            width = s_host[b - 1]
            q = order[a:b].to(dev)
            col = torch.arange(width, device=dev)
            valid = col[None, :] < sizes[q][:, None]
            rows = torch.where(valid, starts[q][:, None] + col[None, :], 0)
            self.blocks.append((rows, valid))
            a = b


def pairwise(m: torch.Tensor, y: torch.Tensor, blocks: QueryBlocks,
             dtype: torch.dtype) -> torch.Tensor:
    s_all = m.to(dtype)
    out = torch.zeros((m.shape[0], 2), dtype=dtype, device=m.device)
    for rows, valid in blocks.blocks:
        s, lab = s_all[rows], y[rows]
        pair = valid[:, :, None] & valid[:, None, :]
        worse = pair & (lab[:, None, :] > lab[:, :, None])  # y_j > y_i
        better = pair & (lab[:, :, None] > lab[:, None, :])  # y_i > y_j
        d = s[:, :, None] - s[:, None, :]  # s_i - s_j
        sig = torch.sigmoid(d)
        zero = torch.zeros((), dtype=dtype, device=m.device)
        g = (torch.where(worse, sig, zero).sum(2)
             - torch.where(better, torch.sigmoid(-d), zero).sum(2))
        h = torch.where(worse | better, sig * (1.0 - sig), zero).sum(2)
        out[rows[valid], 0] = g[valid]
        out[rows[valid], 1] = h[valid]
    out[:, 1] = torch.clamp(out[:, 1], min=1e-6)
    return out


def base_score(objective: str) -> float:
    """The margin every row starts from: 0 for both objectives."""
    if objective in ("binary:logistic", "rank:pairwise"):
        return 0.0
    raise ValueError(f"the reference has no objective {objective!r}")


def gradient(objective: str, m: torch.Tensor, y: torch.Tensor, dtype: torch.dtype,
             blocks: QueryBlocks | None = None) -> torch.Tensor:
    """(n, 2) (g, h) of `objective` at margins m."""
    if objective == "binary:logistic":
        return logistic(m, y, dtype)
    if objective == "rank:pairwise":
        return pairwise(m, y, blocks, dtype)
    raise ValueError(f"the reference has no objective {objective!r}")
