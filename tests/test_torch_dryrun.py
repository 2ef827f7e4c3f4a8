"""The port's partition model (`repro_torch.launch.partition`) and LM dry
run (`repro_torch.launch.dryrun`) on the CPU.

  * hand-made steps on a (2, 4) mesh: a column- then row-parallel MLP, a
    reduction over a sharded dimension, reshards each way, an op without a
    rule;
  * the depth extrapolation against a full-depth trace, exactly;
  * `_constrain` and `moe_ffn` under enabled rules: inside a trace the spec
    is set, outside one they raise ValueError;
  * reduced configs (`cfg.reduced()`) of one architecture per family (dense
    GQA, MoE, SSM, hybrid, enc-dec) at train, prefill and decode on a
    (2, 4) mesh, against the reference's own `build_step` compiled on 8 of
    its virtual CPU devices in one subprocess (`dryrun.py` sets 512 at
    import, so it never runs in a test worker): `argument_bytes` equals
    `memory_analysis().argument_size_in_bytes` exactly (XLA drops unused
    arguments, the trace counts the ones the step reads), and
    `dot_flops_per_device` is within FLOPS_RTOL of `hlo_analysis.analyze`'s
    (every case reads 0 today). Collective bytes by type are printed beside
    the reference's and not gated: XLA picks its own collectives.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.dist import make_mesh
from repro_torch.launch import dryrun as D
from repro_torch.launch import partition as PT
from repro_torch.launch import specs as SP
from repro_torch.models import NO_SHARDING, ShardingRules, build_model
from repro_torch.models import transformer as TF
from repro_torch.models.config import ShapeConfig
from repro_torch.models.moe import moe_ffn

ROOT = Path(__file__).resolve().parents[1]
FLOPS_RTOL = 0.10
FAMILIES = ["yi-6b", "llama4-scout-17b-a16e", "mamba2-2.7b", "zamba2-7b",
            "seamless-m4t-medium"]
KINDS = ["train", "prefill", "decode"]
SEQ, BATCH = 64, 8
MESH = {"data": 2, "model": 4}


def _shape(kind: str) -> ShapeConfig:
    return ShapeConfig(f"{kind}_x", SEQ, BATCH, kind)


def _mesh():
    return make_mesh((2, 4), ("data", "model"), device="cpu")


REFERENCE = r"""
import json, sys, time
from repro.launch import dryrun as D  # sets 512 virtual devices first
import jax, numpy as np
jax.config.update("jax_disable_most_optimizations", True)
from repro.configs import get_arch
from repro.launch.hlo_analysis import analyze
from repro.models import build_model
from repro.models.config import ShapeConfig

archs, kinds, seq, batch = sys.argv[1].split(","), sys.argv[2].split(","), int(sys.argv[3]), int(sys.argv[4])
mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
out, t0 = {}, time.time()
for arch in archs:
    for kind in kinds:
        cfg = get_arch(arch).reduced()
        shape = ShapeConfig(kind + "_x", seq, batch, kind)
        fn, structs, shardings = D.build_step(build_model(cfg), cfg, shape, mesh)
        with jax.set_mesh(mesh):
            compiled = jax.jit(fn, in_shardings=shardings).lower(*structs).compile()
        hlo = analyze(compiled.as_text())
        out[f"{arch}:{kind}"] = {
            "argument_bytes": int(compiled.memory_analysis().argument_size_in_bytes),
            "dot_flops_per_device": hlo["dot_flops_per_device"],
            "collective_bytes_per_device": hlo["collective_bytes_per_device"]}
print("REFERENCE-JSON " + json.dumps(out))
print("REFERENCE-OK", round(time.time() - t0, 1))
"""


class _Reference:
    """The reference's compiles of every case, in one subprocess started when
    the file's first test starts."""

    def __init__(self):
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
        env.pop("XLA_FLAGS", None)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(REFERENCE), ",".join(FAMILIES),
             ",".join(KINDS), str(SEQ), str(BATCH)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        self.out = None

    def get(self) -> dict:
        if self.out is None:
            stdout, stderr = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0 and "REFERENCE-OK" in stdout, \
                stdout + stderr[-4000:]
            line = next(l for l in stdout.splitlines() if l.startswith("REFERENCE-JSON "))
            self.out = json.loads(line.split(" ", 1)[1])
        return self.out

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def reference():
    """Started before the file's first test, so the port's tests run while
    the reference compiles."""
    r = _Reference()
    yield r
    r.close()


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# --- hand-made steps -----------------------------------------------------------


def test_column_then_row_parallel_mlp():
    """x (data, -) @ w1 (-, model) -> relu -> @ w2 (model, -): each position
    does 1/8 of the global FLOPs, and the row-parallel product's partial
    sums meet in one all-reduce of its output."""
    b, d, f = 64, 32, 128
    x, w1, w2 = _meta((b, d)), _meta((d, f)), _meta((f, d))
    with PT.trace(MESH) as tr:
        tr.place((x, w1, w2), (("data", None), (None, "model"), ("model", None)))
        y = torch.relu(x @ w1) @ w2
        y = tr.constrain(y, ("data", None))
        assert tr.spec(y) == ("data", None)
    s = PT.summary(tr, y)
    assert s["dot_flops_per_device"] == 2 * (2 * b * d * f) / 8
    assert s["collective_bytes_per_device"] == {
        "all-reduce": b // 2 * d * 4, "all-gather": 0, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 0}
    assert s["collective_bytes_by_link"] == {"nvlink": b // 2 * d * 4, "network": 0}
    assert s["fallback_ops"] == {}


def test_reduction_over_a_sharded_dimension():
    """A max over a sharded dimension is an all-reduce of its output; a sum
    is a partial sum, reduced where it is used."""
    x = _meta((16, 64))
    with PT.trace(MESH) as tr:
        tr.place(x, ("data", "model"))
        m = x.amax(dim=-1)
        s = x.sum(dim=-1)
        assert tr.info(s).pending == (("model", 4, 1),)
        out = m * s  # a product of two full values: s reduced first
    summ = PT.summary(tr, out)
    assert summ["collective_bytes_by_op"] == {"all-reduce amax": 8 * 4, "all-reduce mul": 8 * 4}


def test_reshards_each_way():
    """Dropping a sharding is an all-gather, moving one an all-to-all,
    adding one a local slice (free)."""
    x = _meta((16, 64))
    for target, kind, nbytes in [((None, None), "all-gather", 16 * 64 * 4),
                                 ((None, "data"), "all-to-all", 8 * 64 * 4),
                                 (("data", "model"), None, 0)]:
        with PT.trace(MESH) as tr:
            tr.place(x, ("data", None))
            y = tr.constrain(x, target)
            assert tr.spec(y) == target
        coll = PT.summary(tr)["collective_bytes_per_device"]
        assert sum(coll.values()) == nbytes
        if kind:
            assert coll[kind] == nbytes


def test_op_without_a_rule_is_gathered_and_listed():
    """GSPMD's fallback: the inputs gathered, the op replicated, its name
    listed."""
    x = _meta((16, 64))
    with PT.trace(MESH) as tr:
        tr.place(x, ("data", "model"))
        y = torch.cumprod(x, dim=0)
        assert tr.spec(y) == (None, None)
    s = PT.summary(tr, y)
    assert s["fallback_ops"] == {"cumprod": 1}
    assert s["collective_bytes_per_device"]["all-gather"] == 16 * 64 * 4


def test_long_decode_softmax_over_sharded_cache():
    """long_500k's decode shards the cache sequence over every axis: the
    decode softmax over it is one max all-reduce and one sum all-reduce
    of the (B, K, G, 1) scores' statistics, a layer."""
    cfg = dataclasses.replace(get_arch("yi-6b").reduced(), n_layers=1)
    shape = ShapeConfig("long_500k", SEQ, 1, "decode")
    s = D.trace_step(SP.cfg_for_shape(cfg, shape), shape, _mesh())
    stat = 1 * cfg.n_heads * 1 * 4  # (B, K, G, 1) float32
    assert s["collective_bytes_by_op"]["all-reduce amax"] == stat
    assert s["collective_bytes_by_op"]["all-reduce div"] == stat


# --- depth extrapolation --------------------------------------------------------

DEPTH_CASES = [
    ("yi-6b", "train", dict(n_layers=4, remat=True, remat_policy="dots_saveable")),
    ("llama4-scout-17b-a16e", "prefill", dict(n_layers=3)),
    ("mamba2-2.7b", "decode", dict(n_layers=3)),
    ("zamba2-7b", "train", dict(n_layers=7, remat=True, remat_policy="full")),
    ("seamless-m4t-medium", "prefill", dict(n_layers=3, n_enc_layers=4)),
]


# The temp peak is a maximum over the step, not a sum: the stacked layers'
# gradients and the remat schedule make it grow faster than linearly in
# depth, so its extrapolation (linear, never below a traced depth's peak)
# is an estimate. Readings at these cases: -14.41% (yi-6b, 4 layers,
# dots_saveable), 0, 0, 0, 0; the limit is the largest plus 2 points.
PEAK_RTOL = 0.165


@pytest.mark.parametrize("arch,kind,cut", DEPTH_CASES, ids=[c[0] for c in DEPTH_CASES])
def test_extrapolation_equals_full_depth_trace(arch, kind, cut):
    """Every count (FLOPs, bytes, collectives by type, link and op, output
    bytes, ops, fallbacks, arguments read) of the extrapolation equals a
    full-depth trace's exactly; the temp peak within PEAK_RTOL."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), **cut)
    assert len(D.depth_points(cfg)) > 1
    got = D.partition_of(cfg, _shape(kind), _mesh())
    want = D.trace_step(cfg, _shape(kind), _mesh())
    peak, want_peak = got.pop("temp_bytes_peak"), want.pop("temp_bytes_peak")
    assert got == want
    assert abs(peak / want_peak - 1) <= PEAK_RTOL, (peak, want_peak)


# --- constraints under enabled rules --------------------------------------------


def test_constrain_raises_outside_a_trace():
    x = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="needs a mesh"):
        TF._constrain(x, ShardingRules().act(), ShardingRules())
    assert TF._constrain(x, ShardingRules().act(), NO_SHARDING) is x
    cfg = get_arch("llama4-scout-17b-a16e").reduced(d_model=64)
    p = build_model(cfg).init_params(0, "cpu")["layers"]["ffn"]
    p = {k: v[0] for k, v in p.items()}
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
    with pytest.raises(ValueError, match="needs a mesh"):
        moe_ffn(torch.zeros(2, 4, 64), p, rules=ShardingRules(), **kw)
    out, _ = moe_ffn(torch.zeros(2, 4, 64), p, rules=NO_SHARDING, **kw)
    assert out.shape == (2, 4, 64)


def test_constrain_inside_a_trace_sets_the_spec():
    rules = ShardingRules(batch=("data",), model="model")
    x = _meta((8, 16, 32), torch.bfloat16)
    with PT.trace(MESH) as tr:
        tr.place(x, (None, None, None))
        y = TF._constrain(x, rules.act(), rules)
        assert y is x and tr.spec(x) == ("data", None, None)
        e = _meta((4, 16, 32))
        e = torch.zeros_like(e)
        eb = TF._constrain(e, TF.P(rules.model, rules.batch, None), rules)
        assert tr.spec(eb) == ("model", "data", None)


# --- reduced configs against the reference's compile ------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_step_against_reference(arch, kind, reference):
    cfg = get_arch(arch).reduced()
    shape = _shape(kind)
    mesh = _mesh()
    _, structs, specs = D.build_step(build_model(cfg), cfg, shape, mesh)
    part = D.partition_of(SP.cfg_for_shape(cfg, shape), shape, mesh)
    arg = D.argument_bytes(structs, specs, mesh, part.pop("arguments_read"))
    ref = reference.get()[f"{arch}:{kind}"]
    got_coll = {k: v for k, v in part["collective_bytes_per_device"].items() if v}
    print(f"{arch} {kind}: dot flops {part['dot_flops_per_device']:.6e} against "
          f"{ref['dot_flops_per_device']:.6e}; collectives {got_coll} against "
          f"{ref['collective_bytes_per_device']}")
    assert arg == ref["argument_bytes"]
    gap = abs(part["dot_flops_per_device"] / ref["dot_flops_per_device"] - 1)
    assert gap <= FLOPS_RTOL, gap
    assert part["fallback_ops"] == {}


@pytest.mark.parametrize("arch", ARCHS)
def test_every_architecture_traces_every_kind(arch):
    """Each architecture's reduced step at train, prefill, decode and a
    long_500k-like decode (batch 1, the cache sequence over every axis)
    traces with no op falling back."""
    cfg = get_arch(arch).reduced()
    for shape in [ShapeConfig("train_x", 16, 2, "train"), ShapeConfig("prefill_x", 16, 2, "prefill"),
                  ShapeConfig("decode_x", 16, 2, "decode"), ShapeConfig("long_500k", 16, 1, "decode")]:
        if not SP.supports_shape(cfg, shape)[0]:
            continue
        s = D.partition_of(SP.cfg_for_shape(cfg, shape), shape, _mesh())
        assert s["fallback_ops"] == {}, (shape.name, s["fallback_ops"])
        assert s["dot_flops_per_device"] > 0


def test_run_one_records(tmp_path):
    """run_one writes the reference's file names and records: a skip with
    the reference's reason, an ok record with every key."""
    rec = D.run_one("seamless-m4t-medium", "long_500k", False, str(tmp_path), device="cpu")
    assert rec["status"] == "skipped" and "enc-dec" in rec["reason"]
    assert (tmp_path / "seamless-m4t-medium__long_500k__pod16x16.json").exists()
    rec = D.run_one("mamba2-2.7b", "decode_32k", True, str(tmp_path), device="cpu")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 512 and rec["mesh"] == "pod2x16x16"
    assert set(rec["memory_analysis"]) >= {"argument_bytes", "output_bytes", "temp_bytes",
                                            "alias_bytes", "peak_hbm_bytes_est"}
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s", "dominant",
                                    "model_flops_global", "model_flops_per_device",
                                    "useful_flops_ratio"}
    on_disk = json.loads((tmp_path / "mamba2-2.7b__decode_32k__pod2x16x16.json").read_text())
    assert on_disk["partition"]["dot_flops_per_device"] == rec["partition"]["dot_flops_per_device"]
    assert "nvidia_smi" not in rec
