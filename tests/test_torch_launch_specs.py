"""The port's launch specs (`repro_torch.launch.specs`) and the dry run's
argument side (`repro_torch.launch.dryrun`: `build_step`, the parameter
counts, `argument_bytes`, `partition.shard_shape`) against the
reference's (`repro.launch.specs`, `repro.launch.dryrun`), for all ten
architectures x four shapes x both production meshes, with no device and
no compile: the reference's shapes come from `jax.eval_shape`, its shards
from `NamedSharding(AbstractMesh(...), spec).shard_shape`.

The reference's `tests/test_launch_specs.py` cases are held here against
the port's functions, under the same names with `_port` appended.
"""
import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as jget
from repro.launch import specs as JSP
from repro.models import build_model as jbuild
from repro.models.config import SHAPES as JSHAPES
from repro.optimizer import adamw_init as jadamw_init
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch import dryrun as D
from repro_torch.launch import partition as PT
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.config import SHAPES

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(name):
    return make_production_mesh(multi_pod=name == "pod2x16x16", device="cpu")


def _jmesh(name):
    return AbstractMesh(*MESHES[name])


def _tuples(tree):
    """A reference spec tree with tuple(PartitionSpec) leaves."""
    return jax.tree.map(lambda s: tuple(s), tree, is_leaf=lambda x: isinstance(x, JP))


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str) or
        (isinstance(e, tuple) and all(isinstance(a, str) for a in e)) for e in x)


def _paths(tree, prefix=""):
    """{path: leaf} of a tree of dicts, lists, tuples and named tuples;
    a spec (a plain tuple of axis entries) is a leaf."""
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = ((k, getattr(tree, k)) for k in tree._fields)
    elif isinstance(tree, (tuple, list)) and not _is_spec(tree):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_paths(v, f"{prefix}/{k}"))
    return out


def _norm(spec) -> tuple:
    """A spec with one-name tuples as the name (PartitionSpec's own
    normalisation: P(("data",), None) reads back as ("data", None))."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _norm_tree(tree):
    return {k: _norm(v) for k, v in tree.items()}


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _ref_shard(shape, spec, name):
    """The reference's shard shape: NamedSharding's where the axes divide
    the dimension, the ceiling (XLA's padding) where they do not."""
    try:
        return tuple(NamedSharding(_jmesh(name), JP(*spec)).shard_shape(tuple(shape)))
    except ValueError:
        sizes = dict(zip(MESHES[name][1], MESHES[name][0]))
        ax = lambda e: () if e is None else (e,) if isinstance(e, str) else tuple(e)
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        return tuple(-(-s // math.prod(sizes[a] for a in ax(e))) for s, e in zip(shape, spec))


@pytest.fixture(scope="module")
def ref_structs():
    """Per architecture: the reference's parameter and AdamW structs."""
    out = {}
    for arch in ARCHS:
        model = jbuild(jget(arch))
        params = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
        out[arch] = (model, params, jax.eval_shape(jadamw_init, params))
    return out


# --- the reference's own cases, on the port's functions ----------------------


def test_window_engaged_only_for_long_port():
    cfg = get_arch("yi-6b")
    assert cfg.sliding_window == 8192
    assert SP.cfg_for_shape(cfg, SHAPES["train_4k"]).sliding_window == 0
    assert SP.cfg_for_shape(cfg, SHAPES["prefill_32k"]).sliding_window == 0
    assert SP.cfg_for_shape(cfg, SHAPES["decode_32k"]).sliding_window == 0
    assert SP.cfg_for_shape(cfg, SHAPES["long_500k"]).sliding_window == 8192


def test_cache_capacity_rules_port():
    yi = get_arch("yi-6b")
    assert SP.cache_capacity(yi, SHAPES["decode_32k"]) == 32768
    assert SP.cache_capacity(yi, SHAPES["long_500k"]) == 8192  # SWA window
    mam = get_arch("mamba2-2.7b")
    assert SP.cache_capacity(mam, SHAPES["decode_32k"]) == 32768  # unused by SSM


def test_seamless_long_skip_reason_port():
    ok, reason = SP.supports_shape(get_arch("seamless-m4t-medium"), SHAPES["long_500k"])
    assert not ok and "enc-dec" in reason


def test_padded_vocab_divisibility_port():
    for arch in ARCHS:
        cfg = get_arch(arch)
        assert cfg.padded_vocab % 256 == 0
        assert cfg.padded_vocab >= cfg.vocab_size
        assert cfg.padded_vocab - cfg.vocab_size < 256


def test_roofline_term_arithmetic_port():
    cfg = get_arch("llama4-scout-17b-a16e")
    total = 100_000
    moe = cfg.n_layers * 3 * cfg.n_experts * cfg.d_model * cfg.d_ff
    assert D.active_params(cfg, total + moe) == total + moe // cfg.n_experts
    assert D.model_flops(cfg, SHAPES["train_4k"], 1_000) == 6.0 * 1_000 * 256 * 4096
    assert D.model_flops(cfg, SHAPES["decode_32k"], 1_000) == 2.0 * 1_000 * 128


def test_batch_partition_specs_shapes_port():
    from repro_torch.models import ShardingRules

    cfg = get_arch("phi-3-vision-4.2b")
    shape = SHAPES["train_4k"]
    r = ShardingRules(batch=("data",), model="model", seq=None)
    specs = SP.batch_partition_specs(cfg, shape, r)
    assert set(specs) == {"prefix_embeds", "tokens", "targets"}
    si = SP.input_specs(cfg, shape)
    assert tuple(si["tokens"].shape) == (256, 4096 - 576)
    assert tuple(si["prefix_embeds"].shape) == (256, 576, cfg.d_model)
    assert all(t.device.type == "meta" for t in si.values())


# --- every architecture x shape x mesh ----------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_functions_match_reference(arch):
    """supports_shape, cfg_for_shape, cache_capacity, input_specs (keys,
    shapes, dtypes), rules_for and batch_partition_specs at every shape on
    both meshes; count_params, active_params and model_flops exactly."""
    for shape_name, shape in SHAPES.items():
        jshape = JSHAPES[shape_name]
        cfg, jcfg = get_arch(arch), jget(arch)
        assert SP.supports_shape(cfg, shape) == JSP.supports_shape(jcfg, jshape)
        assert (dataclasses.asdict(SP.cfg_for_shape(cfg, shape))
                == dataclasses.asdict(JSP.cfg_for_shape(jcfg, jshape)))
        assert SP.cache_capacity(cfg, shape) == JSP.cache_capacity(jcfg, jshape)
        assert SP.shape_by_name(shape_name) == shape
        got, want = SP.input_specs(cfg, shape), JSP.input_specs(jcfg, jshape)
        assert list(got) == list(want)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            assert _dtype(got[k]) == _dtype(want[k]), k
        for name in MESHES:
            rules, jrules = SP.rules_for(_mesh(name), shape), JSP.rules_for(_jmesh(name), jshape)
            assert (rules.batch, rules.model, rules.seq, rules.enabled) == \
                (jrules.batch, jrules.model, jrules.seq, jrules.enabled)
            assert _norm_tree(SP.batch_partition_specs(cfg, shape, rules)) == \
                _norm_tree(_tuples(JSP.batch_partition_specs(jcfg, jshape, jrules)))
    from repro.launch import dryrun as JD

    params = build_model(get_arch(arch)).init_params(0, "meta")
    jparams = jax.eval_shape(jbuild(jget(arch)).init_params, jax.random.PRNGKey(0))
    n = D.count_params(params)
    assert n == JD.count_params(jparams)
    assert D.active_params(get_arch(arch), n) == JD.active_params(jget(arch), n)
    for shape_name in SHAPES:
        assert D.model_flops(get_arch(arch), SHAPES[shape_name], n) == \
            JD.model_flops(jget(arch), JSHAPES[shape_name], n)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_leaves_match_reference(arch, mesh_name, ref_structs):
    """Every parameter, AdamW-state, batch and cache leaf of every shape's
    step: global shape, dtype, spec and shard shape equal the reference's
    (`jax.eval_shape`, `NamedSharding(AbstractMesh).shard_shape`, the
    ceiling where it refuses an uneven dimension), and `argument_bytes`
    (every leaf) equals the sum of the reference's local shard bytes."""
    jmodel, jparams, jopt = ref_structs[arch]
    jpspecs = _tuples(jmodel.param_specs())
    for shape_name, shape in SHAPES.items():
        jshape = JSHAPES[shape_name]
        if not SP.supports_shape(get_arch(arch), shape)[0]:
            continue
        cfg = SP.cfg_for_shape(get_arch(arch), shape)
        jcfg = JSP.cfg_for_shape(jget(arch), jshape)
        mesh = _mesh(mesh_name)
        _, structs, specs = D.build_step(build_model(cfg), cfg, shape, mesh)
        jrules = JSP.rules_for(_jmesh(mesh_name), jshape)
        jbatch = JSP.input_specs(jcfg, jshape)
        jbspecs = _tuples(JSP.batch_partition_specs(jcfg, jshape, jrules))
        if shape.kind == "train":
            want = (jparams, jopt, jbatch)
            wspecs = (jpspecs, type(jopt)(step=(), m=jpspecs, v=jpspecs), jbspecs)
        elif shape.kind == "prefill":
            want, wspecs = (jparams, jbatch), (jpspecs, jbspecs)
        else:
            cap = JSP.cache_capacity(jcfg, jshape)
            jm = jbuild(jcfg)
            jcache = jax.eval_shape(lambda: jm.init_cache(jshape.global_batch, cap, jnp.bfloat16))
            want = (jparams, jbatch, jcache, jax.ShapeDtypeStruct((), jnp.int32))
            wspecs = (jpspecs, jbspecs, _tuples(jm.cache_specs(jrules)), ())
        got_l, got_s = _paths(structs), _paths(specs)
        want_l, want_s = _paths(want), _paths(wspecs)
        assert sorted(got_l) == sorted(want_l), shape_name
        ref_bytes = 0
        for path, w in want_l.items():
            g = got_l[path]
            assert tuple(g.shape) == tuple(w.shape), path
            assert _dtype(g) == _dtype(w), path
            assert _norm(got_s[path]) == _norm(want_s[path]), path
            want_shard = _ref_shard(tuple(w.shape), want_s[path], mesh_name)
            assert PT.shard_shape(tuple(g.shape), got_s[path], mesh) == want_shard, path
            ref_bytes += math.prod(want_shard) * np.dtype(w.dtype).itemsize
        assert D.argument_bytes(structs, specs, mesh) == ref_bytes, shape_name


def test_uneven_leaves_of_the_production_meshes():
    """Every argument leaf whose axes do not divide a dimension on the
    production meshes (none today: GQA's K/V projections shard the flat
    K * head_dim width, which 16 divides): the list PERF.md states."""
    uneven = []
    for arch in ARCHS:
        for shape_name, shape in SHAPES.items():
            if not SP.supports_shape(get_arch(arch), shape)[0]:
                continue
            cfg = SP.cfg_for_shape(get_arch(arch), shape)
            for name in MESHES:
                mesh = _mesh(name)
                _, structs, specs = D.build_step(build_model(cfg), cfg, shape, mesh)
                for path, t in _paths(structs).items():
                    spec = _paths(specs)[path]
                    local = PT.shard_shape(tuple(t.shape), spec, mesh)
                    full = PT.shard_shape(tuple(t.shape), (), mesh)
                    n = [math.prod(mesh.shape[a] for a in PT._axes(e))
                         for e in tuple(spec) + (None,) * (t.dim() - len(spec))]
                    if any(f % k for f, k in zip(full, n)):
                        uneven.append((arch, shape_name, name, path, local))
    assert uneven == []


def test_modules_import_without_jax():
    """The dry run's modules import neither JAX nor the JAX package."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import repro_torch.launch.specs, repro_torch.launch.partition, "
        "repro_torch.launch.dryrun\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('IMPORT-OK')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0 and "IMPORT-OK" in out.stdout, out.stdout + out.stderr
