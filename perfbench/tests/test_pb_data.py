"""The device generators on the CPU: shapes and counts, seeds, and moments
beside the numpy originals they rewrite."""
import numpy as np
import pytest
import torch

from perfbench.data import generators as G


def test_tabular_shapes_and_labels():
    d = G.tabular("higgs", 5000, 28, seed=3, device="cpu")
    assert d.x.shape == (5000, 28) and d.x.dtype == torch.float32
    assert d.y.shape == (5000,) and set(d.y.unique().tolist()) <= {0.0, 1.0}
    assert d.informative == 5


@pytest.mark.parametrize("name,rows,feats", [("higgs", 3000, 28), ("airline", 3000, 13)])
def test_same_seed_same_data_other_seed_other_data(name, rows, feats):
    a = G.tabular(name, rows, feats, seed=2**33 + 7, device="cpu")
    b = G.tabular(name, rows, feats, seed=2**33 + 7, device="cpu")
    c = G.tabular(name, rows, feats, seed=2**33 + 8, device="cpu")
    assert torch.equal(a.x, b.x) and torch.equal(a.y, b.y)
    assert not torch.equal(a.x, c.x)


def test_tabular_moments_beside_the_numpy_original():
    from repro_torch.data import make_dataset

    x_np, y_np, _ = make_dataset("higgs", 200_000, seed=0)
    d = G.tabular("higgs", 200_000, 28, seed=0, device="cpu")
    x = d.x.numpy()
    assert abs(x.mean() - x_np.mean()) < 0.01
    assert abs(x.std() - x_np.std()) < 0.01
    # Both label a sign of a linear signal plus interactions and noise:
    # about balanced, whatever the weights drawn.
    assert abs(float(d.y.mean()) - 0.5) < 0.2 and abs(float(y_np.mean()) - 0.5) < 0.2


def _mslr_config(rows=24_000, queries=200):
    return {"name": "mslr-web30k", "generator": "ranking", "rows": rows, "queries": queries,
            "features": 136, "query_mean": rows / queries, "query_sigma": 0.75,
            "query_max": 1251, "relevance_shares": [0.52, 0.32, 0.13, 0.02, 0.01],
            "informative": 24}


def test_ranking_counts_grouping_and_shares():
    c = _mslr_config()
    d = G.make(c, seed=5, device="cpu")
    assert d.x.shape == (24_000, 136) and d.y.shape == (24_000,)
    assert int(d.sizes.sum()) == 24_000 and d.sizes.shape == (200,)
    assert int(d.sizes.min()) >= 1 and int(d.sizes.max()) <= 1251
    # Rows grouped by query: ids ascend, each query's rows contiguous.
    assert bool((d.qid[1:] >= d.qid[:-1]).all())
    assert torch.equal(torch.bincount(d.qid.to(torch.int64)), d.sizes)
    shares = torch.bincount(d.y.to(torch.int64), minlength=5).double() / 24_000
    assert torch.allclose(shares, torch.tensor(c["relevance_shares"], dtype=torch.float64),
                          atol=0.002)


def test_ranking_sizes_fixed_by_name_order_by_seed():
    c = _mslr_config()
    a, b, z = (G.make(c, s, "cpu") for s in (1, 1, 2))
    assert torch.equal(a.x, b.x) and torch.equal(a.qid, b.qid)
    assert not torch.equal(a.sizes, z.sizes)  # another order...
    assert torch.equal(a.sizes.sort().values, z.sizes.sort().values)  # ...of the same sizes


def test_full_size_query_sizes_mean():
    s = G.query_sizes("mslr-web30k", 18_919, 2_262_675, 119.6, 0.75, 1251)
    assert int(s.sum()) == 2_262_675
    assert abs(float(s.double().mean()) - 119.6) < 0.01


def test_ranking_moments_beside_chip_smoke():
    import chip_smoke as CS

    rng = np.random.default_rng(0)
    signal = (rng.normal(size=136) * (np.arange(136) < 24) / np.sqrt(24)).astype(np.float32)
    x_np, rel_np, _, sizes_np, _ = CS.mslr_shaped(rng, 400, 48_000, 0, signal, None)
    d = G.make(_mslr_config(48_000, 400), seed=0, device="cpu")
    assert abs(float(d.x.mean()) - float(x_np.mean())) < 0.01
    assert abs(float(d.x.std()) - float(x_np.std())) < 0.01
    assert abs(float(d.y.mean()) - float(rel_np.mean())) < 0.02
    assert abs(float(d.sizes.double().mean()) - float(sizes_np.mean())) < 1e-9
