"""The sharded quantile sketch of the port (`repro_torch.dist.sketch`)
against the reference's (`repro.dist.sketch`), on the CPU.

The reference's device phase (`sharded_sketch_cuts(mesh=)`) needs its
virtual devices, and its own test of it fails under this jax
(`test_dist_sketch.py::test_device_phase_sharded_sketch`: its cuts equal
its host path's, but not `compute_cuts`', whose jitted `arange / nvb` is
not numpy's true division). So the port's mesh path is held against the
reference's host path (`n_shards=`), which the reference's own test holds
equal to its mesh path. Every comparison is bit for bit: the summaries,
their merges and `get_cuts` are the same host arithmetic in both.
"""
import numpy as np
import pytest
import torch

from repro.core import quantile as JQ
from repro.core.dmatrix import ExternalDMatrix as JExternal
from repro.dist import sharded_sketch_cuts as j_sharded_cuts
from repro.dist import tree_merge as j_tree_merge
from repro_torch import dist as D
from repro_torch.core import quantile as TQ
from repro_torch.core.dmatrix import ExternalDMatrix

CPU = {"device": "cpu"}


@pytest.fixture
def rng():
    return np.random.default_rng(2600)


def _x(rng, n=1600, f=5, missing=0.05):
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random((n, f)) < missing] = np.nan
    x[:, 2] = rng.integers(0, 4, n)  # low cardinality
    return x


def _shards(Q, x, shards, max_bins=128, capacity=4096):
    out = []
    for part in np.array_split(x, shards):
        sk = Q.StreamingQuantileSketch(x.shape[1], max_bins, capacity)
        sk.push(part)
        out.append(sk)
    return out


@pytest.mark.parametrize("shards", [2, 3, 4, 8])
def test_tree_merge_against_reference(rng, shards):
    """Exact summaries: the port's tree merge is the reference's bit for
    bit, and both are the one sequential sketch's cuts."""
    x = _x(rng)
    got = D.tree_merge(_shards(TQ, x, shards)).get_cuts("cpu").numpy()
    want = np.asarray(j_tree_merge(_shards(JQ, x, shards)).get_cuts())
    np.testing.assert_array_equal(got, want)
    seq = TQ.StreamingQuantileSketch(x.shape[1], 128, 4096).push(x).get_cuts("cpu").numpy()
    np.testing.assert_array_equal(got, seq)


def test_tree_merge_order_invariance(rng):
    x = _x(rng, n=1200, f=4, missing=0.0)
    base = D.tree_merge(_shards(TQ, x, 4)).get_cuts("cpu")
    for perm in ([3, 1, 0, 2], [2, 3, 0, 1], [1, 0, 3, 2]):
        sketches = _shards(TQ, x, 4)
        assert torch.equal(D.tree_merge([sketches[i] for i in perm]).get_cuts("cpu"), base)
    with pytest.raises(ValueError, match="at least one sketch"):
        D.tree_merge([])


@pytest.mark.parametrize("mesh_shape,axes", [((2,), ("data",)), ((4,), ("data",)),
                                             ((8,), ("data",)), ((4, 2), ("data", "pod"))])
def test_mesh_path_against_reference_host_path(rng, mesh_shape, axes):
    """Each shard sorted on its position's device, pushed sorted and merged:
    bit for bit the reference's host path at as many shards, exact and
    pruned, on the mesh's first device."""
    x = _x(rng, n=4096, f=6, missing=0.03)
    shards = int(np.prod(mesh_shape))
    mesh = D.make_mesh(mesh_shape, axes, **CPU)
    for capacity in (8192, 64):
        got = D.sharded_sketch_cuts(x, max_bins=64, capacity=capacity, mesh=mesh, data_axes=axes)
        assert got.device == torch.device("cpu")
        want = np.asarray(j_sharded_cuts(x, max_bins=64, capacity=capacity, n_shards=shards))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"capacity {capacity}")


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_host_path_against_reference(rng, shards):
    x = _x(rng, n=3000, f=4)
    got = D.sharded_sketch_cuts(x, max_bins=32, capacity=64, n_shards=shards, **CPU)
    want = np.asarray(j_sharded_cuts(x, max_bins=32, capacity=64, n_shards=shards))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sharded_cuts_rank_error_bound(rng):
    """`test_dist_sketch.py::test_sharded_cuts_rank_error_bound` on the
    port: a pruned 8-shard sketch's every finite cut within the GK-style
    rank bound of its target."""
    n, capacity, shards = 40000, 256, 8
    col = (rng.standard_normal(n) ** 3).astype(np.float32)
    cuts = D.sharded_sketch_cuts(col[:, None], max_bins=64, capacity=capacity,
                                 n_shards=shards, **CPU).numpy()[0]
    finite = cuts[np.isfinite(cuts)]
    nvb = TQ.n_value_bins(64)
    assert finite.size == nvb - 1
    srt = np.sort(col)
    eps = 2.0 * (shards + 3) / capacity
    for b, v in enumerate(finite):
        target = (b + 1) / nvb * (n - 1)
        assert abs(np.searchsorted(srt, v) - target) <= eps * n, b


@pytest.mark.parametrize("sketch_shards", [2, 3, 8])
def test_external_dmatrix_sketch_shards_against_reference(rng, sketch_shards):
    """ExternalDMatrix(sketch_shards=k): one sketch a shard of chunks, tree
    merged, bit for bit the reference's cuts, exact and pruned (k above the
    chunk count takes one shard a chunk)."""
    x = _x(rng, n=3000, f=4)
    y = rng.normal(size=3000).astype(np.float32)
    for capacity in (8192, 16):
        got = ExternalDMatrix.from_arrays(x, y, chunk_rows=500, sketch_capacity=capacity,
                                          sketch_shards=sketch_shards, **CPU)
        want = JExternal.from_arrays(x, y, chunk_rows=500, sketch_capacity=capacity,
                                     sketch_shards=sketch_shards)
        np.testing.assert_array_equal(got.cuts.numpy(), np.asarray(want.cuts))
    seq = ExternalDMatrix.from_arrays(x, y, chunk_rows=500, sketch_capacity=8192, **CPU)
    exact = ExternalDMatrix.from_arrays(x, y, chunk_rows=500, sketch_capacity=8192,
                                        sketch_shards=sketch_shards, **CPU)
    assert torch.equal(seq.cuts, exact.cuts)


def test_sketch_errors(rng):
    x = _x(rng, n=1001, f=3)
    with pytest.raises(ValueError, match="must divide evenly across 2 shards"):
        D.sharded_sketch_cuts(x, mesh=D.make_mesh((2,), ("data",), **CPU))
    with pytest.raises(ValueError, match="sketch_shards"):
        ExternalDMatrix.from_arrays(x, np.zeros(1001, np.float32), chunk_rows=500,
                                    sketch_shards=0, **CPU)
