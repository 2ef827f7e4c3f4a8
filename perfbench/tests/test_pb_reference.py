"""The plain reference against the port at a small size on the CPU, and the
import rule of the benchmark's files."""
import ast
from pathlib import Path

import pytest
import torch

from perfbench.data import generators as G
from perfbench.reference import growth as RG
from perfbench.reference import objectives as OBJ
from perfbench.reference import quantile as QT
from perfbench.reference import traversal as RT

HERE = Path(__file__).resolve().parents[1]
PARAMS = RG.Params(max_depth=4, max_bins=64, learning_rate=0.3, reg_lambda=1.0,
                   min_child_weight=1.0, objective="binary:logistic")


def _data(rows=6000, feats=7, seed=4, missing=0.0):
    d = G.tabular("higgs", rows, feats, seed, "cpu")
    if missing:
        g = torch.Generator().manual_seed(seed)
        d.x[torch.rand(d.x.shape, generator=g) < missing] = float("nan")
    return d


@pytest.mark.parametrize("max_bins", [256, 64, 5])
@pytest.mark.parametrize("missing", [0.0, 0.2])
def test_cuts_and_bins_are_the_ports(max_bins, missing):
    from repro_torch.core import quantile as Q

    d = _data(missing=missing)
    cut = QT.cuts(d.x, max_bins)
    assert torch.equal(cut, Q.compute_cuts(d.x, max_bins))
    assert torch.equal(QT.quantize(d.x, cut, max_bins).t().to(torch.int32),
                       Q.quantize(d.x, cut))


def test_logistic_gradient_is_the_ports():
    from repro_torch.core import objectives as O

    d = _data()
    m = torch.randn(d.y.shape[0], generator=torch.Generator().manual_seed(1))
    want = O.get_objective("binary:logistic").grad(m[:, None], d.y)[:, 0, :]
    got = OBJ.gradient("binary:logistic", m, d.y, torch.float64)
    assert torch.allclose(got, want.double(), rtol=1e-6, atol=1e-7)


def test_pairwise_gradient_is_the_ports():
    from repro_torch.core import objectives as O

    c = {"name": "mslr-web30k", "generator": "ranking", "rows": 5000, "queries": 60,
         "features": 3, "query_mean": 5000 / 60, "query_sigma": 0.75, "query_max": 400,
         "relevance_shares": [0.52, 0.32, 0.13, 0.02, 0.01], "informative": 3}
    d = G.make(c, 3, "cpu")
    m = torch.randn(5000, generator=torch.Generator().manual_seed(2))
    want = O.get_objective("rank:pairwise").grad(m[:, None], d.y, group_ids=d.qid)[:, 0, :]
    got = OBJ.gradient("rank:pairwise", m, d.y, torch.float64, OBJ.QueryBlocks(d.sizes))
    # The port adds float32 terms; the reference float64 terms.
    assert torch.allclose(got, want.double(), rtol=1e-5, atol=1e-5)


def test_traversal_is_the_ports():
    from repro_torch.kernels import ref

    d = _data(rows=3000, missing=0.1)
    g = torch.Generator().manual_seed(5)
    t, a = 9, 31
    feature = torch.randint(0, 7, (t, a), generator=g, dtype=torch.int32)
    threshold = torch.randn(t, a, generator=g)
    default_left = torch.rand(t, a, generator=g) < 0.5
    leaf = torch.randn(t, a, generator=g)
    is_leaf = torch.rand(t, a, generator=g) < 0.2
    is_leaf[:, 15:] = True
    want = ref.ensemble_leaves_ref(feature, threshold, default_left, leaf, is_leaf, d.x, 4)
    got = RT.margins(feature, threshold, default_left, leaf, is_leaf, d.x, 4, torch.float64)
    assert torch.allclose(got, want.double().sum(0), rtol=1e-6, atol=1e-6)


def _port_fit(d, rounds=4, p=PARAMS, group_ids=None):
    from repro_torch.core import Booster, DeviceDMatrix

    dm = DeviceDMatrix(d.x, label=d.y, group_ids=group_ids, max_bins=p.max_bins, device="cpu")
    bst = Booster(n_rounds=rounds, max_depth=p.max_depth, max_bins=p.max_bins,
                  learning_rate=p.learning_rate, objective=p.objective).fit(dm)
    e = bst.ensemble
    trees = RG.Trees(e.feature, e.split_bin, e.default_left, e.leaf_value, e.is_leaf,
                     e.threshold)
    return trees, bst.margins


def test_judge_reads_the_ports_fit_as_the_reference_own():
    d = _data(missing=0.05)
    cut = QT.cuts(d.x, PARAMS.max_bins)
    bins = QT.quantize(d.x, cut, PARAMS.max_bins)
    trees, margins = _port_fit(d)
    r = RG.judge(trees, margins, bins, cut, d.y, PARAMS)
    assert r.threshold_mismatch == 0
    assert r.split_regret < 1e-4 and r.leaf_gap < 1e-5 and r.margin_gap < 1e-5
    assert len(r.hist_rows) == 4 and r.hist_rows[0][0] == 6000
    assert all(0 <= h <= 3000 for rows in r.hist_rows for h in rows[1:])
    # The reference in the program's place reads the same; the same trees
    # with one leaf moved do not.
    own, m = RG.grow(bins, cut, d.y, PARAMS, 4, torch.float32)
    assert torch.equal(own.feature, trees.feature) and torch.equal(own.split_bin, trees.split_bin)
    moved = RG.Trees(**{**own.__dict__, "leaf_value": own.leaf_value.clone()})
    leaf = int(torch.nonzero(moved.is_leaf[2])[0, 0])
    moved.leaf_value[2, leaf] += 0.5
    assert RG.judge(moved, m, bins, cut, d.y, PARAMS).leaf_gap > 1e-3


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    files = [p for p in HERE.rglob("*.py") if "tests" not in p.relative_to(HERE).parts]
    assert len(files) > 10
    for p in files:
        tops = {n.split(".")[0] for n in _imports(p)}
        assert not tops & FORBIDDEN, (p, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for p in (HERE / "reference").glob("*.py"):
        tops = {n.split(".")[0] for n in _imports(p)}
        assert tops <= {"__future__", "dataclasses", "torch", "perfbench", "math"}, (p, tops)
        inner = {n for n in _imports(p) if n.startswith("perfbench")}
        assert all(n.startswith("perfbench.reference") for n in inner), (p, inner)
