"""The port's LM training path against the reference's, on the CPU: the
token stream, the optimizers, train steps, the `launch.train` driver and
its checkpoints.

The reference runs in this process, jitted (XLA may keep float32 between
fused bf16 operations there; `test_torch_lm_common.py`). Tolerances
(`python
tests/torch_parity_readings.py lm` reads them over seeds 0-4; each limit at
most 4x the largest reading):

  * `TokenStream`: bit for bit;
  * optimizer arithmetic on float32 inputs: AdamW without clipping, SGD,
    the global norm and clipping bit for bit (readings 0.0); AdamW with
    clipping and decay 7e-7 relative (up to 1.8e-7); the cosine schedule
    5e-7 (up to 1.3e-7);
  * three train steps from carried weights (reduced yi-6b, width 64): each
    loss's relative gap <= 1.6e-3, each parameter leaf's ||diff|| / ||ref||
    after them <= 3.3e-3 (readings up to 4.0e-4 and 8.4e-4: excess
    precision in the reference's forward and torch's backward roundings,
    then AdamW's m / sqrt(v), which maps a small gradient gap to a sign);
  * the driver's losses from the reference's initial weights (reduced
    yi-6b at its default width): <= 1.6e-3 relative (up to 4.1e-4); the
    logits of a checkpoint the reference wrote, against the reference's
    own: <= 2e-2 (up to 1.3e-2; the reference's own bf16 limit), and
    torch.equal to the port's logits from the same weights carried with
    `params_from_numpy`.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm_common as C
from repro.checkpoint import load_pytree as jload
from repro.checkpoint import save_pytree as jsave
from repro.configs import get_arch as jget
from repro.data import TokenStream as JTokenStream
from repro.launch import train as JT
from repro.models import NO_SHARDING as JNS
from repro.models import build_model as jbuild
from repro.optimizer import AdamWConfig as JAdamWConfig
from repro.optimizer import adamw_init as jadamw_init
from repro.optimizer import adamw_update as jadamw_update
from repro.optimizer import sgd_init as jsgd_init
from repro.optimizer import sgd_update as jsgd_update
from repro.optimizer.util import clip_by_global_norm as jclip
from repro.optimizer.util import cosine_schedule as jcosine
from repro.optimizer.util import global_norm as jglobal_norm
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs import get_arch
from repro_torch.data import TokenStream
from repro_torch.launch import train as TT
from repro_torch.models import NO_SHARDING, build_model, params_from_numpy, params_to_numpy
from repro_torch.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    sgd_init,
    sgd_update,
)
from repro_torch.pytree import leaves

ROOT = Path(__file__).resolve().parents[1]
OPT_RTOL = 7e-7
SCHEDULE_RTOL = 5e-7
STEP_LOSS_RTOL = 1.6e-3
STEP_PARAM_RTOL = 3.3e-3
DRIVER_LOSS_RTOL = 1.6e-3
CKPT_LOGITS_RTOL = 2e-2
# When a list, the parity checks append (limit, reading) instead of
# asserting: `torch_parity_readings.py lm` runs them over seeds 0-4 so.
READINGS = None


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: at these small shapes torch's default of a thread
    a core spends most of a step waiting on its threads when the CPU is
    shared (a reduced train step 0.35 s at 1 thread, 2.3 s at 8)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _check(value: float, limit: float) -> None:
    if READINGS is not None:
        READINGS.append((limit, value))
    else:
        assert value <= limit, (value, limit)


@pytest.mark.parametrize("vocab,batch,seq,seed", [(512, 2, 32, 0), (64000, 3, 17, 5),
                                                  (32, 4, 8, 11)])
def test_token_stream_bit_for_bit(vocab, batch, seq, seed):
    a, b = TokenStream(vocab, batch, seq, seed=seed), JTokenStream(vocab, batch, seq, seed=seed)
    for _ in range(3):
        (ta, ga), (tb, gb) = a.next_batch(), b.next_batch()
        assert ta.dtype == tb.dtype == np.int32
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(ga, gb)
        np.testing.assert_array_equal(ta[:, 1:], ga[:, :-1])


def _tree(rng):
    """A nested tree whose dict keys are not in sorted order, as a model's."""
    return {"w": rng.normal(size=(5, 3)).astype(np.float32),
            "b": {"z": rng.normal(size=(3,)).astype(np.float32),
                  "a": rng.normal(size=(2, 2)).astype(np.float32) * 10}}


def _rel(got, want) -> float:
    return C.rel_max(np.asarray(got, np.float32), np.asarray(want, np.float32))


def _tree_rel(got, want) -> float:
    return max(_rel(g.numpy(), w) for g, w in zip(leaves(got), jax.tree.leaves(want)))


@pytest.mark.parametrize("seed", [0, 1])
def test_global_norm_and_clip(seed):
    rng = np.random.default_rng(seed)
    g = _tree(rng)
    _check(_rel(global_norm(params_from_numpy(g, "cpu")), jglobal_norm(g)), 0.0)
    for max_norm in (1.0, 1e3):
        clipped, norm = clip_by_global_norm(params_from_numpy(g, "cpu"), max_norm)
        jclipped, jnorm = jclip(g, max_norm)
        _check(_rel(norm, jnorm), 0.0)
        _check(_tree_rel(clipped, jclipped), 0.0)
    # the reference's own check (test_optimizer_checkpoint.py::test_grad_clip)
    clipped, norm = clip_by_global_norm({"a": torch.full((10,), 10.0)}, 1.0)
    assert abs(float(global_norm(clipped)) - 1.0) < 1e-3 and float(norm) > 30


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("grad_clip,wd", [(0.0, 0.0), (1.0, 0.1)])
def test_adamw_steps_match_reference(seed, grad_clip, wd):
    """Four AdamW steps on float32 trees, the rate from cosine_schedule:
    parameters and both moments bit for bit without clipping, within
    OPT_RTOL with it (the norm's sum in another order); the step count
    equal."""
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    acfg = dict(lr=0.01, weight_decay=wd, grad_clip=grad_clip)
    tp, ts = params_from_numpy(params, "cpu"), None
    ts = adamw_init(tp)
    jp, js = params, jadamw_init(params)
    for i in range(4):
        g = _tree(rng)
        tp, ts = adamw_update(tp, params_from_numpy(g, "cpu"), ts, AdamWConfig(**acfg),
                              lr=cosine_schedule(ts.step, 0.01, 2, 4))
        jp, js = jadamw_update(jp, g, js, JAdamWConfig(**acfg), lr=jcosine(js.step, 0.01, 2, 4))
        assert int(ts.step) == int(js.step) == i + 1 and ts.step.dtype == torch.int32
        for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
            _check(_tree_rel(got, want), OPT_RTOL if grad_clip else 0.0)


def test_adamw_first_step_and_convergence():
    """The reference's own checks: one step from zero moments moves each
    coordinate by lr in the gradient's sign; 300 steps solve a quadratic."""
    params = {"w": torch.tensor([1.0, 1.0])}
    new, _ = adamw_update(params, {"w": torch.tensor([0.5, -2.0])}, adamw_init(params),
                          AdamWConfig(lr=0.01, weight_decay=0.0, grad_clip=0))
    np.testing.assert_allclose((params["w"] - new["w"]).numpy(), [0.01, -0.01], rtol=1e-3)
    params = {"w": torch.tensor([5.0, -3.0]), "b": torch.tensor(2.0)}
    cfg, state = AdamWConfig(lr=0.1, weight_decay=0.0, grad_clip=0), adamw_init(params)
    for _ in range(300):
        params, state = adamw_update(params, {k: 2 * v for k, v in params.items()}, state, cfg)
    assert float((params["w"] ** 2).sum() + params["b"] ** 2) < 1e-3


@pytest.mark.parametrize("seed", [0, 1])
def test_sgd_matches_reference(seed):
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    tp, ts = params_from_numpy(params, "cpu"), None
    ts = sgd_init(tp)
    jp, js = params, jsgd_init(params)
    for _ in range(3):
        g = _tree(rng)
        tp, ts = sgd_update(tp, params_from_numpy(g, "cpu"), ts, lr=0.1)
        jp, js = jsgd_update(jp, g, js, lr=0.1)
        _check(_tree_rel(tp, jp), 0.0)
        _check(_tree_rel(ts.momentum, js.momentum), 0.0)
    assert int(ts.step) == int(js.step) == 3


def test_cosine_schedule_matches_reference():
    for warmup, total in ((20, 100), (0, 10), (5, 5)):
        for step in range(0, 130, 3):
            want = float(jcosine(jnp.asarray(step), 3e-4, warmup, total))
            got = float(cosine_schedule(torch.tensor(step, dtype=torch.int32), 3e-4, warmup, total))
            _check(abs(got - want) / max(abs(want), 1e-30), SCHEDULE_RTOL)
            assert float(cosine_schedule(step, 3e-4, warmup, total)) == got
    assert float(cosine_schedule(0, 1.0, 10, 100)) == 0.0
    assert abs(float(cosine_schedule(10, 1.0, 10, 100)) - 1.0) < 1e-5
    assert float(cosine_schedule(100, 1.0, 10, 100)) < 0.11


def _yi(width=True):
    cfg = get_arch("yi-6b")
    return C.small(cfg) if width else cfg.reduced()


@pytest.mark.parametrize("seed", [0])
def test_train_steps_match_reference(seed):
    """Three `make_train_step` steps from the same weights on the same
    TokenStream batches: losses and the parameters after them."""
    cfg = _yi()
    jcfg = jget("yi-6b").__class__(**dataclasses.asdict(cfg))
    params = params_to_numpy(build_model(cfg).init_params(seed, "cpu"))
    acfg = dict(lr=1e-2)
    jstep = JT.make_train_step(jbuild(jcfg), JNS, JAdamWConfig(**acfg), 3)
    tstep = TT.make_train_step(build_model(cfg), NO_SHARDING, AdamWConfig(**acfg), 3)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadamw_init(jp)
    tp = params_from_numpy(params, "cpu")
    ts = adamw_init(tp)
    stream = TokenStream(cfg.vocab_size, 2, 16, seed=seed)
    for _ in range(3):
        toks, tgts = stream.next_batch()
        jp, js, jl = jstep(jp, js, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)})
        tp, ts, tl = tstep(tp, ts, {"tokens": torch.from_numpy(toks),
                                    "targets": torch.from_numpy(tgts)})
        _check(abs(float(tl) - float(jl)) / abs(float(jl)), STEP_LOSS_RTOL)
    for g, w in zip(leaves(tp), jax.tree.leaves(jp)):
        _check(C.rel_norm(g.numpy(), np.asarray(w)), STEP_PARAM_RTOL)


@pytest.mark.parametrize("seed", [0])
def test_driver_matches_reference_from_its_weights(seed, capsys):
    """The port's train_loop from the reference's initial weights (reduced
    yi-6b, the drivers' default width) against the reference's train_loop:
    the same TokenStream batches, the same losses."""
    cfg = _yi(width=False)
    _, jhist = JT.train_loop(jget("yi-6b").reduced(), 3, 2, 16, lr=3e-4, seed=seed, log_every=1)
    jinit = jbuild(jget("yi-6b").reduced()).init_params(jax.random.PRNGKey(seed))
    params = params_from_numpy(jax.tree.map(np.asarray, jinit), "cpu")
    _, hist = TT.train_loop(cfg, 3, 2, 16, lr=3e-4, seed=seed, log_every=1, device="cpu",
                            params=params)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == [0, 1, 2]
    for h, j in zip(hist, jhist):
        _check(abs(h["loss"] - j["loss"]) / j["loss"], DRIVER_LOSS_RTOL)
    capsys.readouterr()


def test_driver_main_and_checkpoint_bytes(tmp_path, capsys):
    """`main([... "--device", "cpu", "--checkpoint", path])` trains, prints
    the reference's last line, and writes {"params", "step"} through the
    port's save_pytree: the reference's load_pytree reads the same leaves,
    and the reference's save_pytree of those values writes the same bytes."""
    path = tmp_path / "lm.ckpt"
    hist = TT.main(["--device", "cpu", "--arch", "yi-6b", "--reduced", "--steps", "3",
                    "--batch", "2", "--seq", "16", "--checkpoint", str(path)])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("loss ") and ("improved" in out[-1])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    tree = jload(str(path))
    assert tree["step"] == 3 and set(tree) == {"params", "step"}
    ours = load_pytree(str(path), device="cpu")
    for g, w in zip(leaves(ours["params"]), jax.tree.leaves(tree["params"])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    jsave(str(tmp_path / "ref.ckpt"), {"params": tree["params"], "step": 3})
    assert (tmp_path / "ref.ckpt").read_bytes() == path.read_bytes()


@pytest.mark.parametrize("seed", [7])
def test_reference_checkpoint_loads_into_port(seed, tmp_path):
    """The reference saves a reduced model's parameters; the port loads them
    and computes the reference's logits."""
    cfg = _yi()
    jcfg = jget("yi-6b").__class__(**dataclasses.asdict(cfg))
    jm = jbuild(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    jsave(str(tmp_path / "p.ckpt"), {"params": jp, "step": 0})
    loaded = load_pytree(str(tmp_path / "p.ckpt"), device="cpu")["params"]
    carried = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    model = build_model(cfg)
    got = model.forward_logits(loaded, {"tokens": torch.from_numpy(toks)}, NO_SHARDING)
    assert torch.equal(got, model.forward_logits(carried, {"tokens": torch.from_numpy(toks)},
                                                 NO_SHARDING))
    want = jax.jit(lambda p, t: jm.forward_logits(p, {"tokens": t}, JNS))(jp, jnp.asarray(toks))
    _check(C.rel_max(got.numpy(), np.asarray(want)), CKPT_LOGITS_RTOL)
    # and back: the port saves, the reference reads the same leaves
    save_pytree(str(tmp_path / "back.ckpt"), {"params": loaded, "step": 1})
    back = jload(str(tmp_path / "back.ckpt"))
    for g, w in zip(jax.tree.leaves(back["params"]), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_lm_modules_import_without_jax():
    """The LM substrate imports, builds and runs a reduced forward with
    `sys.modules["jax"] = None`, and names nothing of the JAX package."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "from repro_torch.configs import ARCHS, get_arch\n"
        "from repro_torch.models import build_model, NO_SHARDING\n"
        "from repro_torch.models import layers, moe, ssm, ssm_model, hybrid, encdec, api, convert\n"
        "from repro_torch.optimizer import adamw, sgd, util\n"
        "from repro_torch.data.tokens import TokenStream\n"
        "from repro_torch.launch import train\n"
        "cfg = get_arch('zamba2-7b').reduced(n_layers=3, d_model=64)\n"
        "m = build_model(cfg)\n"
        "out = m.forward_logits(m.init_params(0, 'cpu'), {'tokens': torch.zeros(1, 4, dtype=torch.int64)}, NO_SHARDING)\n"
        "assert out.shape == (1, 4, cfg.padded_vocab)\n"
        "bad = [k for k in sys.modules if k == 'repro' or k.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('OK', len(ARCHS))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK 10"
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "from repro." not in text and "import repro." not in text, path
