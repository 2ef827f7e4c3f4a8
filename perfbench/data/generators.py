"""Device generators of the benchmark's data, made from `--seed`.

Torch rewrites of the port's `repro_torch.data.datasets.make_dataset` (the
tabular stand-ins of the paper's Table 1) and of `chip_smoke.py`'s
`mslr_shaped` (MSLR-WEB's shape). The bulk (features, noise, the order of
the queries) comes from a `torch.Generator` on the device seeded by the run's
seed, in a few large calls. The structure of a data set (its informative
weights, its interactions, its query sizes) comes from a CPU generator
seeded by the configuration's name alone, so every seed draws a fresh sample
of the same data set and the same work: a seed changes the rows, not the
shape of the trees they grow or the sizes of the queries.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass

import torch


def name_seed(name: str) -> int:
    """A process-independent seed from a name (`hash()` is salted)."""
    return zlib.crc32(name.encode())


def run_seed(seed: int, name: str) -> int:
    """The device generator's seed: the run's seed mixed with the data set's
    name, kept inside 63 bits (seeds may exceed 32 bits)."""
    return (int(seed) * 1_000_003 + name_seed(name)) % (2**63 - 1)


def device_generator(seed: int, name: str, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(run_seed(seed, name))
    return g


@dataclass
class Tabular:
    x: torch.Tensor  # (n, f) float32
    y: torch.Tensor  # (n,) float32 labels 0 / 1
    informative: int  # the first k features carry the signal


def tabular(name: str, n_rows: int, n_features: int, seed: int, device) -> Tabular:
    """The binary tabular stand-in of `make_dataset`: standard normal
    features, a sparse linear signal on the first k = max(3, min(f // 5, 24))
    features plus three pairwise interactions (weight 0.5), noise 0.3, the
    label the sign of signal + noise."""
    struct = torch.Generator().manual_seed(name_seed(name))
    k = max(3, min(n_features // 5, 24))
    w = torch.randn(k, generator=struct)
    pairs = torch.randint(0, k, (3, 2), generator=struct).tolist()
    g = device_generator(seed, name, device)
    x = torch.randn((n_rows, n_features), generator=g, device=device)
    signal = torch.zeros(n_rows, device=device)
    for j in range(k):  # column by column: no n x k temporary, no TF32 matmul
        signal.add_(x[:, j], alpha=float(w[j]))
    for i, j in pairs:
        signal.addcmul_(x[:, i], x[:, j], value=0.5)
    signal.add_(torch.randn(n_rows, generator=g, device=device), alpha=0.3)
    return Tabular(x, (signal > 0).to(torch.float32), k)


@dataclass
class Ranking:
    x: torch.Tensor  # (n, f) float32
    y: torch.Tensor  # (n,) float32 relevance 0..len(shares)-1
    qid: torch.Tensor  # (n,) int32 query ids, rows grouped by query
    sizes: torch.Tensor  # (n_queries,) int64 in the rows' order, on the device


def query_sizes(name: str, n_queries: int, n_rows: int, mean: float, sigma: float,
                max_query: int) -> torch.Tensor:
    """(n_queries,) int64 query sizes on the CPU, fixed by the name:
    log-normal with the median that gives `mean` (median = mean /
    exp(sigma^2 / 2)), rounded, clipped to 1..max_query, then moved a row at
    a time on randomly drawn queries until they sum to n_rows, as
    `mslr_shaped` does."""
    struct = torch.Generator().manual_seed(name_seed(name) + 1)
    median = mean / math.exp(sigma * sigma / 2)
    z = torch.randn(n_queries, generator=struct, dtype=torch.float64)
    sizes = torch.clamp(torch.round(torch.exp(math.log(median) + sigma * z)), 1, max_query)
    sizes = sizes.to(torch.int64)
    while int(sizes.sum()) != n_rows:
        gap = n_rows - int(sizes.sum())
        step = 1 if gap > 0 else -1
        pick = torch.randperm(n_queries, generator=struct)[:min(abs(gap), n_queries)]
        moved = sizes[pick] + step
        sizes[pick] = torch.where((moved >= 1) & (moved <= max_query), moved, sizes[pick])
    return sizes


def ranking(name: str, n_queries: int, n_rows: int, n_features: int, seed: int, device,
            mean: float, sigma: float, max_query: int, shares: list[float],
            informative: int = 24) -> Ranking:
    """MSLR-WEB's shape: the fixed query sizes of `query_sizes` in an order
    drawn from the seed, rows grouped by query as the published files are;
    standard normal features; relevance from a hidden score (a fixed signal
    on the first `informative` features, a per-query offset 0.5, noise 0.7)
    cut at the quantiles of `shares`."""
    sizes = query_sizes(name, n_queries, n_rows, mean, sigma, max_query)
    struct = torch.Generator().manual_seed(name_seed(name) + 2)
    signal = torch.randn(informative, generator=struct) / math.sqrt(informative)
    g = device_generator(seed, name, device)
    order = torch.randperm(n_queries, generator=g, device=device)
    sizes = sizes.to(device)[order]
    qid = torch.repeat_interleave(torch.arange(n_queries, device=device, dtype=torch.int32),
                                  sizes)
    x = torch.randn((n_rows, n_features), generator=g, device=device)
    hidden = 0.5 * torch.randn(n_queries, generator=g, device=device)[qid.to(torch.int64)]
    for j in range(informative):
        hidden.add_(x[:, j], alpha=float(signal[j]))
    hidden.add_(torch.randn(n_rows, generator=g, device=device), alpha=0.7)
    srt = torch.sort(hidden).values
    cum = torch.cumsum(torch.tensor(shares, dtype=torch.float64), 0)[:-1]
    thresholds = srt[torch.round(cum * (n_rows - 1)).to(torch.int64).to(device)]
    y = torch.searchsorted(thresholds, hidden).to(torch.float32)
    return Ranking(x, y, qid, sizes)


def make(config: dict, seed: int, device):
    """The configuration's data set: `config["generator"]` names the
    function above."""
    kind = config["generator"]
    if kind == "tabular":
        return tabular(config["name"], config["rows"], config["features"], seed, device)
    if kind == "ranking":
        return ranking(config["name"], config["queries"], config["rows"], config["features"],
                       seed, device, config["query_mean"], config["query_sigma"],
                       config["query_max"], config["relevance_shares"],
                       config["informative"])
    raise ValueError(f"unknown generator {kind!r}")
