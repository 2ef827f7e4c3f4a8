"""The port's LM substrate (`repro_torch.models`, `repro_torch.configs`)
against the reference's (`repro.models`, `repro.configs`), all ten
architectures, on the CPU.

Configs are equal field by field, and partition specs leaf by leaf (the
port's tuples against `tuple(PartitionSpec)`). With the same parameters
(`test_torch_lm_common.inputs`: the port's initialisation, carried both
ways) and the same numpy batch, the port's `forward_logits`, `loss_fn`, gradients and
step-by-step decode are held against the reference's, which a module
fixture computes once in subprocesses with excess precision off
(`test_torch_lm_common.reference_outputs`). Tolerances (`python
tests/torch_parity_readings.py lm` reads them over data seeds 0-4; each
limit is at most 4x the largest reading). Most readings are float32
noise (~1e-7: the lm_head's float32 sums in another order; every bf16
rounding is the reference's), but now and then a float32 sum in another
order turns one bf16 rounding inside a layer the other way, and the
difference carries on through the later layers:

  * logits: max |diff| / max |ref| <= 1.5e-2 (readings up to 3.8e-3);
    the loss's relative gap <= 2.5e-4 (up to 6.5e-5);
  * gradients, each leaf: ||diff|| / ||ref|| <= 0.06 (up to 0.016): the
    backward's bf16 roundings follow torch's autograd formulas, not JAX's
    transposes, so some round the other way in every architecture;
  * decode: every step's logits max |diff| / max |ref| <= 1.5e-2 (up to
    4.0e-3), the final cache <= 3e-2 (up to 7.9e-3: one int8 level).
"""
import dataclasses

import jax
import pytest
import torch

import test_torch_lm_common as C
from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_arch as jget
from repro.models import ShardingRules as JRules
from repro.models import build_model as jbuild
from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import (
    NO_SHARDING,
    ShardingRules,
    build_model,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.pytree import leaves, unflatten_like

LOGITS_RTOL = 1.5e-2
LOSS_RTOL = 2.5e-4
GRAD_RTOL = 0.06
DECODE_RTOL = 1.5e-2
CACHE_RTOL = 3e-2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: at these small shapes torch's default of a thread
    a core spends most of a step waiting on its threads when the CPU is
    shared (a reduced train step 0.35 s at 1 thread, 2.3 s at 8)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return C.reference_outputs(tmp_path_factory.mktemp("lm_ref"))


def _setup(ref, name):
    ins, _ = ref
    cfg = C.config(get_arch, name)
    params = params_from_numpy(C.unflatten(ins, f"{name}/params"), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in C.unflatten(ins, f"{name}/batch").items()}
    return cfg, build_model(cfg), params, batch


def _specs_as_tuples(tree):
    from jax.sharding import PartitionSpec as P

    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


def test_arch_list_equal():
    assert ARCHS == J_ARCHS == C.ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equal(arch):
    """Every field, the source string too, and the reduced variant."""
    assert dataclasses.asdict(get_arch(arch)) == dataclasses.asdict(jget(arch))
    assert dataclasses.asdict(get_arch(arch).reduced()) == dataclasses.asdict(jget(arch).reduced())
    cfg, jcfg = get_arch(arch), jget(arch)
    assert (cfg.padded_vocab, cfg.resolved_v_head_dim, cfg.d_inner) == (
        jcfg.padded_vocab, jcfg.resolved_v_head_dim, jcfg.d_inner)
    if cfg.n_heads:
        assert cfg.resolved_head_dim == jcfg.resolved_head_dim


def test_exact_assigned_specs():
    """The counterpart of test_arch_smoke.py::test_exact_assigned_specs."""
    c = get_arch("glm4-9b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
            c.vocab_size) == (40, 4096, 32, 2, 13696, 151552)
    c = get_arch("zamba2-7b")
    assert (c.n_layers, c.d_model, c.d_ff, c.vocab_size, c.ssm_state) == (
        81, 3584, 14336, 32000, 64)
    c = get_arch("mamba2-2.7b")
    assert (c.n_layers, c.d_model, c.vocab_size, c.ssm_state) == (64, 2560, 50280, 128)
    c = get_arch("llama4-maverick-400b-a17b")
    assert (c.n_experts, c.top_k, c.vocab_size, c.d_model) == (128, 1, 202048, 5120)
    c = get_arch("llama4-scout-17b-a16e")
    assert (c.n_experts, c.top_k) == (16, 1)
    c = get_arch("minicpm3-4b")
    assert (c.n_layers, c.attention, c.vocab_size) == (62, "mla", 73448)
    c = get_arch("seamless-m4t-medium")
    assert (c.n_layers, c.n_enc_layers, c.vocab_size) == (12, 12, 256206)
    c = get_arch("phi-3-vision-4.2b")
    assert (c.n_layers, c.d_model, c.n_prefix_tokens) == (32, 3072, 576)
    c = get_arch("yi-6b")
    assert (c.n_kv_heads, c.d_ff, c.vocab_size) == (4, 11008, 64000)
    c = get_arch("stablelm-12b")
    assert (c.n_layers, c.d_model, c.vocab_size) == (40, 5120, 100352)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_equal(arch):
    """Partition specs leaf for leaf, at the full config (and zamba2 with a
    rest group), for both rule sets and an int8 cache; the parameter tree's
    paths, shapes and dtypes equal the reference's `jax.eval_shape`."""
    cfgs = [get_arch(arch), C.small(get_arch(arch))]
    for cfg in cfgs:
        jcfg = jget(arch).__class__(**dataclasses.asdict(cfg))
        model, jmodel = build_model(cfg), jbuild(jcfg)
        assert model.param_specs() == _specs_as_tuples(jmodel.param_specs())
        assert model.param_specs("mp") == _specs_as_tuples(jmodel.param_specs("mp"))
        for kw in ({}, {"batch": "data", "seq": "seq"}):
            assert model.cache_specs(ShardingRules(**kw)) == _specs_as_tuples(
                jmodel.cache_specs(JRules(**kw)))
        if cfg.attention == "gqa" and cfg.arch_type != "hybrid":
            i8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
            assert build_model(i8).cache_specs(ShardingRules()) == _specs_as_tuples(
                jbuild(jcfg.__class__(**dataclasses.asdict(i8))).cache_specs(JRules()))
    assert ShardingRules().act() == tuple(JRules().act())
    assert ShardingRules(seq="s").cache_kv() == tuple(JRules(seq="s").cache_kv())
    cfg = cfgs[1]
    shapes = jax.eval_shape(jbuild(jcfg).init_params, jax.random.PRNGKey(0))
    params = build_model(cfg).init_params(0, "cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
                       params_to_numpy(params))
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), shapes)
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(ref, arch):
    cfg, model, params, batch = _setup(ref, arch)
    _, out = ref
    logits = model.forward_logits(params, batch, NO_SHARDING)
    want = out[f"{arch}/logits"]
    extra = cfg.n_prefix_tokens if cfg.arch_type == "vlm" else 0
    assert logits.shape == (C.BATCH, C.SEQ + extra, cfg.padded_vocab) == want.shape
    assert C.rel_max(logits.numpy(), want) <= LOGITS_RTOL
    loss = float(model.loss_fn(params, batch, NO_SHARDING))
    assert abs(loss - float(out[f"{arch}/loss"])) <= LOSS_RTOL * abs(float(out[f"{arch}/loss"]))


@pytest.mark.parametrize("arch", C.GRAD_ARCHS)
def test_grads_match_reference(ref, arch):
    cfg, model, params, batch = _setup(ref, arch)
    _, out = ref
    flat = [p.requires_grad_(True) for p in leaves(params)]
    loss = model.loss_fn(params, batch, NO_SHARDING)
    grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
    want = jax.tree.leaves(C.unflatten(out, f"{arch}/grads"))
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        assert bool(torch.isfinite(g).all())
        assert C.rel_norm(g.numpy(), w) <= GRAD_RTOL


@pytest.mark.parametrize("name", C.DECODE_ARCHS)
def test_decode_matches_reference(ref, name):
    """Twelve decode steps from an empty float32 (or int8) cache: every
    step's logits, and the final cache, against the reference's; the decode
    also tracks the port's own forward within the reference's limits
    (test_arch_smoke.py: 2e-2; 0.05 for int8)."""
    cfg, model, params, batch = _setup(ref, name)
    _, out = ref
    cache = model.init_cache(C.BATCH, C.DECODE_STEPS, dtype=torch.float32, device="cpu")
    steps = []
    with torch.no_grad():
        for t in range(C.DECODE_STEPS):
            db = {"tokens": batch["tokens"][:, t:t + 1]}
            if "src_embeds" in batch:
                db["src_embeds"] = batch["src_embeds"]
            logits, cache = model.decode_fn(params, db, cache, t, NO_SHARDING)
            steps.append(logits[:, 0])
        got = torch.stack(steps, dim=1).numpy()
        full = model.forward_logits(params, {k: v[:, :C.DECODE_STEPS] if k == "tokens" else v
                                             for k, v in batch.items()}, NO_SHARDING).numpy()
    assert C.rel_max(got, out[f"{name}/decode"]) <= DECODE_RTOL
    want_cache = C.unflatten(out, f"{name}/cache")
    for g, w in zip(jax.tree.leaves(params_to_numpy(cache)), jax.tree.leaves(want_cache)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert C.rel_max(g, w) <= CACHE_RTOL
    assert C.rel_max(got, full) < (0.05 if cfg.kv_cache_dtype == "int8" else 2e-2)


@pytest.mark.parametrize("arch,policy", [("yi-6b", "dots_saveable"), ("yi-6b", "full"),
                                         ("llama4-scout-17b-a16e", "dots_saveable"),
                                         ("mamba2-2.7b", "dots_saveable"),
                                         ("zamba2-7b", "full"),
                                         ("seamless-m4t-medium", "dots_saveable")])
def test_remat_changes_no_value(arch, policy):
    """Remat on (either policy) against off: loss and every gradient leaf
    torch.equal on the CPU; only memory and recompute move."""
    cfg = C.small(get_arch(arch))
    batch = {k: torch.from_numpy(v) for k, v in C.batch(cfg, 3).items()}
    params = build_model(cfg).init_params(3, "cpu")
    results = []
    for remat in (False, True):
        model = build_model(dataclasses.replace(cfg, remat=remat, remat_policy=policy))
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        live = unflatten_like(params, flat)
        loss = model.loss_fn(live, batch, NO_SHARDING)
        grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
        results.append((loss.detach(), grads))
    assert torch.equal(results[0][0], results[1][0])
    for a, b in zip(results[0][1], results[1][1]):
        assert torch.equal(a, b)


def test_sharded_rules_raise():
    """The LM runs on one device: a constraint under enabled rules raises
    before any work, naming the slice that brings the partition model."""
    cfg = C.small(get_arch("yi-6b"))
    model = build_model(cfg)
    params = model.init_params(0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in C.batch(cfg, 0).items()}
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 4"):
        model.forward_logits(params, batch, ShardingRules())
