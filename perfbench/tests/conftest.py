"""Small cells for the CPU: each cell of BENCHMARK.json with its
configuration and traffic cut to a size a test run holds, its limits as
committed."""
import pytest
import torch

from perfbench import harness as H

SMALL = {
    "train": {"rounds": 4, "warm_rounds": 1, "trace_rounds": 2},
    "predict": {"n_trees": 24, "batch_min": 300, "batch_max": 3000, "cycle": 8,
                "keep_every": 3, "keep_max": 4, "trace_calls": 4},
}


def small_cell(name: str, seed: int = 7, rows: int = 12_000, root=H.ROOT) -> H.Cell:
    cell = H.load_cell(name, seed, "cpu", root=root)
    cell.config.update(rows=rows)
    if "queries" in cell.config:
        cell.config.update(queries=rows // 120, query_max=400)
    cell.traffic.update(SMALL[cell.traffic["driver"]])
    return cell


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
