"""Feature-sharded growth in the port (`grow_tree(feature_axis=)` under
`dist.spmd`) against the reference's (`repro.core.tree.grow_tree` with
`feature_axis` under `shard_map`), on the CPU; and its entry point, the
GBDT dry run (`repro_torch.launch.dryrun_gbdt`, `launch/mesh.py`).

The reference runs its feature-sharded trees on 8 virtual CPU devices
(`XLA_FLAGS=--xla_force_host_platform_device_count=8`), so every reference
output this file needs comes from one module-scoped subprocess, started
before the first test and read by the tests that compare with it (a run
that fails from XLA's CPU rendezvous timeout runs once more, alone, with a
warning). Both packages grow from the same bins and cuts, made with
numpy from a seed at the shapes of `tests/test_distributed.py`'s
`test_feature_sharded_equals_single_device` (512 rows, 8 features, 32
bins, depth 4; a few missing values). Tolerances: tree structure and
thresholds exact, leaves within 1e-4 (the reference's own tolerance for
its sharded fits); every position's tree `torch.equal`; structure equal to
the port's unsharded dense `grow_tree`.
"""
import json
import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch

from repro_torch import dist as D
from repro_torch.core import ExternalDMatrix
from repro_torch.core import compress as TC
from repro_torch.core import sampling as TSMP
from repro_torch.core import tree as TT
from repro_torch.core.booster import BoosterConfig
from repro_torch.core.stream import StreamedChunkedBins
from repro_torch.launch import dryrun_gbdt, mesh as LM

from _torch_parity import replay_uniform

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, F, MAX_BINS, DEPTH, MAX_LEAVES = 512, 8, 32, 4, 8
SEED, COLSAMPLE = 13, 0.5  # the colsample case's draw path (SEED, round 0, class 0)
STRUCTURE = ("feature", "split_bin", "default_left", "is_leaf")
LEAF_ATOL = 1e-4
# name: (mesh (data, model), growth, colsample_bylevel)
CASES = {
    "d4m2-depthwise": ((4, 2), "depthwise", 1.0),
    "d4m2-lossguide": ((4, 2), "lossguide", 1.0),
    "d2m4-depthwise": ((2, 4), "depthwise", 1.0),
    "d2m4-lossguide": ((2, 4), "lossguide", 1.0),
    "d1m8-depthwise": ((1, 8), "depthwise", 1.0),
    "d1m8-lossguide": ((1, 8), "lossguide", 1.0),
    "d4m2-colsample": ((4, 2), "depthwise", COLSAMPLE),
}
MONOTONE = (1, 0, 0, -1)  # a local-width constraint vector at (4, 2)
REFERENCE_PARTS = 4  # reference processes run at once, each compiling a share of CASES


def _inputs():
    """Dense bins (missing bin MAX_BINS - 1 for 2% of the entries), cuts and
    the logistic (g, h) at margin 0, from numpy."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(N, F)).astype(np.float32)
    y = (x @ rng.normal(size=F) > 0).astype(np.float32)
    q = np.linspace(0, 1, MAX_BINS - 1)[1:-1]
    cuts = np.stack([np.quantile(x[:, j], q) for j in range(F)]).astype(np.float32)
    bins = np.stack([np.searchsorted(cuts[j], x[:, j]) for j in range(F)], axis=1)
    bins[rng.random((N, F)) < 0.02] = MAX_BINS - 1
    p = np.float32(0.5)
    gh = np.stack([p - y, np.full(N, p * (1 - p))], axis=1).astype(np.float32)
    return bins.astype(np.int32), cuts, gh


REFERENCE = r'''
import json, sys, types
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import BoosterConfig
from repro.core import compress as C
from repro.core import sampling as SMP
from repro.core import tree as T
from repro.jaxcompat import shard_map

inp, out_npz, out_json = sys.argv[1:4]
spec = json.loads(open(sys.argv[4]).read())
part, n_parts = int(sys.argv[5]), int(sys.argv[6])  # part 0 also records the errors
data = dict(np.load(inp))
bins, cuts, gh = (jnp.asarray(data[k]) for k in ("bins", "cuts", "gh"))
depth, max_bins = spec["depth"], spec["max_bins"]
key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(spec["seed"]), 0), 0)
arrays, meta = {}, {"errors": {}}

for name, (shape, growth, colsample) in list(spec["cases"].items())[part::n_parts]:
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), ("data", "model"))
    f_local = bins.shape[1] // shape[1]
    params = (SMP.stochastic_params(BoosterConfig(colsample_bylevel=colsample))
              if colsample < 1 else None)

    def body(b, g, c, params=params, growth=growth, f_local=f_local):
        ctx = None
        if params is not None:
            ctx, g = SMP.make_tree_context(params, key, g, f_local, compact=False)
        return T.grow_tree(b, g, c, depth, max_bins, growth=growth,
                           max_leaves=spec["max_leaves"], axis_name="data",
                           feature_axis="model", ctx=ctx)

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data", "model"), P("data", None),
                                                       P("model", None)), out_specs=P()))
    tree = fn(bins, gh, cuts)
    for f in tree._fields:
        arrays[f"{name}/{f}"] = np.asarray(getattr(tree, f))

if part:
    np.savez(out_npz, **arrays)
    json.dump(meta, open(out_json, "w"))
    print("REFERENCE-OK")
    sys.exit(0)

def error(name, fn):
    try:
        fn()
        meta["errors"][name] = None
    except Exception as e:
        meta["errors"][name] = f"{type(e).__name__}: {e}"

grow = lambda b, g=gh, **kw: T.grow_tree(b, g, cuts, depth, max_bins, axis_name="data",
                                         feature_axis="model", **kw)
error("packed", lambda: grow(C.PackedBins(jnp.zeros((8, 128), jnp.uint32), 8, 512)))
error("chunked", lambda: grow(C.ChunkedPackedBins(jnp.zeros((2, 8, 64), jnp.uint32), 8,
                                                  256, 512)))
error("streamed", lambda: grow(types.SimpleNamespace(is_streamed=True)))
ctx = SMP.TreeContext(key=key, row_ids=jnp.arange(64, dtype=jnp.int32), feature_mask=None,
                      params=SMP.StochasticParams(subsample=0.5))
error("buffer", lambda: grow(bins, gh[:64], ctx=ctx))
# The reference's monotone lookup under feature_axis: a local-width vector
# indexed by global feature ids, which JAX clamps.
meta["clamped"] = np.asarray(jnp.asarray([1, -1, 0])[jnp.asarray([0, 4, 7])]).tolist()
np.savez(out_npz, **arrays)
json.dump(meta, open(out_json, "w"))
print("REFERENCE-OK")
'''


class _Reference:
    """The reference's REFERENCE_PARTS subprocesses, started at once;
    `result()` waits for them (running a part once more, alone, if XLA's
    CPU rendezvous timed out) and merges their outputs."""

    def __init__(self, tmp):
        self.tmp = tmp
        bins, cuts, gh = _inputs()
        np.savez(tmp / "in.npz", bins=bins, cuts=cuts, gh=gh)
        spec = {"cases": CASES, "depth": DEPTH, "max_bins": MAX_BINS,
                "max_leaves": MAX_LEAVES, "seed": SEED}
        (tmp / "spec.json").write_text(json.dumps(spec))
        self.env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                        JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
        self.procs = [self._start(k) for k in range(REFERENCE_PARTS)]
        self._out = None

    def _start(self, k: int):
        return subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(REFERENCE), str(self.tmp / "in.npz"),
             str(self.tmp / f"out{k}.npz"), str(self.tmp / f"out{k}.json"),
             str(self.tmp / "spec.json"), str(k), str(REFERENCE_PARTS)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=self.env)

    def result(self):
        if self._out is None:
            arrays, meta = {}, {"errors": {}}
            for k, proc in enumerate(self.procs):
                out, err = proc.communicate(timeout=600)
                if proc.returncode != 0 or "REFERENCE-OK" not in out:
                    warnings.warn(f"reference part {k} failed once, run again alone:\n"
                                  f"{err[-2000:]}")
                    out, err = self._start(k).communicate(timeout=600)
                assert "REFERENCE-OK" in out, out + err
                arrays.update(np.load(self.tmp / f"out{k}.npz"))
                part = json.loads((self.tmp / f"out{k}.json").read_text())
                meta["errors"].update(part.pop("errors"))
                meta.update(part)
            self._out = arrays, meta
        return self._out

    def close(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """Started before the file's first test, so the port's tests run while
    the reference compiles."""
    r = _Reference(tmp_path_factory.mktemp("feature_ref"))
    yield r
    r.close()


@pytest.fixture
def replay(monkeypatch):
    monkeypatch.setattr(TSMP, "uniform", replay_uniform)


@pytest.fixture(scope="module")
def port_trees():
    """`port_trees(name)`: every position's tree of a case, grown once for
    the file."""
    grown = {}

    def get(name: str) -> list:
        if name not in grown:
            grown[name] = _port_trees(name)
        return grown[name]

    return get


def _port_trees(name: str) -> list:
    """Every position's tree of a case: the bins and cuts sharded with
    `dist.shard_features`, the rows' (g, h) over "data", the row axis
    reduced by a psum collective."""
    shape, growth, colsample = CASES[name]
    bins, cuts, gh = (torch.from_numpy(a) for a in _inputs())
    mesh = D.make_mesh(shape, ("data", "model"), device="cpu")
    coll = D.PsumCollective(mesh, ("data",))
    parts = D.shard_features(bins, cuts, mesh, ("data",), "model")
    n_rows, shard_of, _ = mesh.shards(("data",))
    per = N // n_rows
    params = (TSMP.stochastic_params(BoosterConfig(colsample_bylevel=colsample))
              if colsample < 1 else None)

    def body(part, g):
        b, c = part
        ctx = None
        if params is not None:
            ctx, g = TSMP.make_tree_context(params, (SEED, 0, 0), g, b.shape[1], compact=False)
        return TT.grow_tree(b, g, c, DEPTH, MAX_BINS, growth=growth, max_leaves=MAX_LEAVES,
                            ctx=ctx, collective=coll, feature_axis="model")

    return D.spmd(mesh, body, parts, [gh[s * per:(s + 1) * per] for s in shard_of])


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[2] == 1.0])
def test_feature_sharded_structure_equals_unsharded(port_trees, name):
    """The port's sharded tree has its unsharded dense tree's structure and
    thresholds, as the reference's test holds its own."""
    _, growth, _ = CASES[name]
    bins, cuts, gh = (torch.from_numpy(a) for a in _inputs())
    one = TT.grow_tree(bins, gh, cuts, DEPTH, MAX_BINS, growth=growth, max_leaves=MAX_LEAVES)
    got = port_trees(name)[0]
    for f in (*STRUCTURE, "threshold"):
        assert torch.equal(getattr(got, f), getattr(one, f)), f
    torch.testing.assert_close(got.leaf_value, one.leaf_value, rtol=0, atol=LEAF_ATOL)


def test_shard_features_layout_and_errors():
    """Position (i, j) holds rows block i over "data" and feature block j
    over "model"; with no feature axis, rows over both axes and every
    feature. Uneven rows or features raise."""
    bins = torch.arange(12 * 6, dtype=torch.int32).reshape(12, 6)
    cuts = torch.arange(6 * 3, dtype=torch.float32).reshape(6, 3)
    mesh = D.make_mesh((2, 3), ("data", "model"), device="cpu")
    parts = D.shard_features(bins, cuts, mesh, ("data",), "model")
    for p, (b, c) in enumerate(parts):
        i, j = mesh.coords(p)["data"], mesh.coords(p)["model"]
        assert torch.equal(b, bins[6 * i:6 * (i + 1), 2 * j:2 * (j + 1)])
        assert torch.equal(c, cuts[2 * j:2 * (j + 1)])
    for p, (b, c) in enumerate(D.shard_features(bins, cuts, mesh, ("data", "model"), None)):
        assert torch.equal(b, bins[2 * p:2 * (p + 1)]) and torch.equal(c, cuts)
    with pytest.raises(ValueError, match="n_rows=11 must be divisible by the 2 row shards"):
        D.shard_features(bins[:11], cuts, mesh, ("data",), "model")
    with pytest.raises(ValueError, match="n_features=5 must be divisible by the 3 feature"):
        D.shard_features(bins[:, :5], cuts[:5], mesh, ("data",), "model")
    with pytest.raises(ValueError, match="also a row axis"):
        D.shard_features(bins, cuts, mesh, ("data", "model"), "model")
    with pytest.raises(ValueError, match="cuts cover 5 features"):
        D.shard_features(bins, cuts[:5], mesh, ("data",), "model")


def test_make_production_mesh_on_cpu():
    mesh = LM.make_production_mesh(device="cpu")
    assert mesh.shape == {"data": 16, "model": 16} and mesh.size == 256
    assert {d.type for d in mesh.devices.flat} == {"cpu"}
    assert LM.batch_axes(mesh) == ("data",)
    assert LM.seq_axes_long(mesh) == ("data", "model")
    pods = LM.make_production_mesh(multi_pod=True, device="cpu")
    assert pods.shape == {"pod": 2, "data": 16, "model": 16}
    assert LM.batch_axes(pods) == ("pod", "data")
    assert LM.seq_axes_long(pods) == ("pod", "data", "model")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LM.make_production_mesh()


def test_byte_tally_by_kind():
    """Each position tallies what it posts: a psum its tensor under
    "all-reduce", an all-gather under "all-gather", a ring's hops under
    "collective-permute"."""
    mesh = D.make_mesh((4,), ("data",), device="cpu")
    ring = D.RingCollective(mesh, ("data",))

    def body(x):
        D.group.psum(x, "data")
        D.group.all_gather(x[:3], "data")
        ring.allreduce(x)
        return D.group.current_shard().posted()

    got = D.spmd(mesh, body, [torch.zeros(10) for _ in range(4)])
    seg = -(-10 // 4)  # the ring's padded segment, posted at 2 (p - 1) hops
    assert got == [{"all-reduce": 40, "all-gather": 12,
                    "collective-permute": 2 * 3 * seg * 4}] * 4


def test_dry_run_tally_equals_the_shape_count(tmp_path):
    """`python -m repro_torch.launch.dryrun_gbdt --device cpu --mesh 2x2
    --rows 2048`: both modes run, every position grows the same tree, and a
    position posts what the shapes say. Baseline: the root sum (2 float32)
    and each level's full histogram (2^l nodes x 13 features x 256 bins x
    2 float32) psum'd. Feature mode (13 features padded to 14, 7 a
    position): the root sum, each level's histogram of 7 features psum'd
    over "data", an int8 route a row of the position's 1,024 at each of the
    6 levels, the arena's 127 float32 thresholds; and a record of 8 float32
    a node all-gathered at each level. A position posts 1/model of the
    histogram bytes per feature of the padded width."""
    recs = dryrun_gbdt.main(["--device", "cpu", "--mesh", "2x2", "--rows", "2048",
                             "--out", str(tmp_path)])
    assert [r["mode"] for r in recs] == ["baseline", "feature"]
    assert json.loads((tmp_path / "gbdt_round.json").read_text()) == recs
    nodes = sum(2**level for level in range(6))  # 63 nodes histogrammed in a round
    hist = {"baseline": nodes * 13 * 256 * 2 * 4, "feature": nodes * 7 * 256 * 2 * 4}
    base, feat = recs
    assert base["posted_bytes_per_position"] == {"all-reduce": 8 + hist["baseline"]}
    assert feat["posted_bytes_per_position"] == {
        "all-reduce": 8 + hist["feature"] + 6 * 1024 + 127 * 4,
        "all-gather": nodes * 8 * 4}
    assert hist["feature"] * 2 == hist["baseline"] // 13 * 14
    assert base["replicated"] and feat["replicated"] and feat["splits"] > 0
    assert (base["features"], feat["features"]) == (13, 14)


@pytest.mark.parametrize("name", list(CASES))
def test_feature_sharded_tree_against_reference(reference, replay, port_trees, name):
    """Structure and thresholds exact, leaves within 1e-4, on every
    position; every position's tree the same bit for bit."""
    trees = port_trees(name)
    arrays, _ = reference.result()
    for t in trees:
        for f in (*STRUCTURE, "threshold"):
            np.testing.assert_array_equal(getattr(t, f).numpy(), arrays[f"{name}/{f}"],
                                          err_msg=f"{name}: {f}")
        np.testing.assert_allclose(t.leaf_value.numpy(), arrays[f"{name}/leaf_value"],
                                   rtol=0, atol=LEAF_ATOL)
    for t in trees[1:]:
        for a, b in zip(trees[0], t):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["packed", "chunked", "streamed", "buffer"])
def test_refusals_have_the_reference_messages(reference, kind):
    bins, cuts, gh = (torch.from_numpy(a) for a in _inputs())
    kw = {}
    if kind == "packed":
        data = TC.PackedBins(torch.zeros((F, 128), dtype=torch.int32), 8, N)
    elif kind == "chunked":
        data = TC.ChunkedPackedBins(torch.zeros((2, F, 64), dtype=torch.int32), 8, 256, N)
    elif kind == "streamed":
        rng = np.random.default_rng(0)
        data = StreamedChunkedBins(ExternalDMatrix.from_arrays(
            rng.normal(size=(N, F)).astype(np.float32), np.zeros(N, np.float32),
            chunk_rows=256, max_bins=MAX_BINS, paging="stream", device="cpu"))
    else:
        data, gh = bins, gh[:64]
        kw["ctx"] = TSMP.TreeContext(key=(SEED, 0, 0), row_ids=torch.arange(64, dtype=torch.int32),
                                     feature_mask=None,
                                     params=TSMP.StochasticParams(subsample=0.5),
                                     device=torch.device("cpu"))
    with pytest.raises(NotImplementedError) as err:
        TT.grow_tree(data, gh, cuts, DEPTH, MAX_BINS, feature_axis="model", **kw)
    _, meta = reference.result()
    assert f"NotImplementedError: {err.value}" == meta["errors"][kind]


def test_monotone_under_feature_axis_is_refused(reference):
    """The reference reads a split's sign from a local-width vector by global
    feature id (`repro/core/tree.py:322`): JAX clamps the out-of-range
    gather, so a split on any shard but the first takes the sign of the
    last local feature. The port refuses instead, before any launch."""
    _, meta = reference.result()
    assert meta["clamped"] == [1, 0, 0]  # ids 4 and 7 read entry 2 of 3
    bins, cuts, gh = (torch.from_numpy(a) for a in _inputs())
    ctx = TSMP.TreeContext(key=(SEED, 0, 0), row_ids=None, feature_mask=None,
                           params=TSMP.StochasticParams(monotone=MONOTONE),
                           device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="tree.py:322"):
        TT.grow_tree(bins[:, :4], gh, cuts[:4], DEPTH, MAX_BINS, ctx=ctx,
                     feature_axis="model")
