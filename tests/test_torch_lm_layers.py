"""The port's LM layers (`repro_torch.models.layers`, `moe`, `ssm`) against
the reference's, function by function, on the CPU.

The reference's functions run under `jax.jit` in this process, so XLA may
keep float32 between fused bf16 operations where the port rounds each
(excess precision; `test_torch_lm_common.py`): that shows in
`mamba2_block`'s gated norm. Inputs are made with numpy from a seed at a width of 64 and at most
64 positions.
Tolerances (`python tests/torch_parity_readings.py lm` reads them over
seeds 0-4, as max |diff| / max |ref|; each limit at most 4x the largest
reading):

  * bit for bit (every reading 0.0): `dot`, bf16 `rmsnorm`, `apply_rope`,
    `silu`, `attention_gqa` full, windowed, cached and int8 (its int8
    values too), `attention_mla` full and cached, the written caches;
  * within the limits below, where a float32 sum in another order (or
    XLA's excess precision) turns one bf16 rounding the other way.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import ssm as JS
from repro_torch.configs import get_arch
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TS
from repro_torch.models.convert import params_from_numpy

import test_torch_lm_common as C

# Limits, each at most 4x the largest reading over seeds 0-4, exact where
# every reading is 0 (the port rounds as the reference's ops do):
F32_RTOL = 5e-7  # float32 sums of exact bf16 products in another order (1.4e-7)
SDPA_RTOL = 1.4e-3  # _sdpa, flash: a softmax weight rounds to bf16 the other way (3.6e-4)
MLA_FLASH_RTOL = 4e-3  # the MLA prefill's flash branch (1.1e-3)
MOE_RTOL = 1.5e-2  # moe_ffn's output (4.4e-3)
AUX_RTOL = 2e-3  # its aux losses: XLA's softmax of the router's unrounded logits (5.0e-4)
SSD_RTOL = 6e-6  # ssd_chunked (1.5e-6)
MAMBA_RTOL = 2.5e-2  # mamba2_block: XLA keeps float32 through the gated norm (7.1e-3)
SEEDS = [0, 1]
# When a list, `_close` appends (limit, reading) to it instead of asserting:
# `torch_parity_readings.py lm` runs the tests' bodies over seeds 0-4 so.
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


@functools.cache
def _jitted(fn, static: tuple):
    return jax.jit(functools.partial(fn, **dict(static)))


def J(fn, *args, static=None, **dyn):
    """`fn` of the reference under `jax.jit` (compiled once for its static
    keywords), the arrays traced, never folded as constants."""
    return _jitted(fn, tuple(sorted((static or {}).items())))(*args, **dyn)


def _rng(seed):
    return np.random.default_rng(seed)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol):
    """max |got - want| / max |want| <= rtol (equal arrays when rtol is 0)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if READINGS is not None:
        READINGS.append((rtol, C.rel_max(got, want)))
    elif rtol == 0:
        np.testing.assert_array_equal(got, want)
    else:
        assert C.rel_max(got, want) <= rtol


@pytest.mark.parametrize("seed", SEEDS)
def test_dot_rmsnorm_rope(seed):
    rng = _rng(seed)
    a = rng.normal(size=(2, 16, 64)).astype(np.float32)
    b = (rng.normal(size=(64, 96)) / 8).astype(np.float32)
    _close(TL.dot(_t(a), _t(b)), J(JL.dot, a, b), 0)
    _close(TL.dot_f32(_t(a), _t(b)), J(JL.dot_f32, a, b), F32_RTOL)
    w = rng.normal(size=(64,)).astype(np.float32)
    _close(TL.rmsnorm(_t(a).bfloat16(), _t(w), 1e-5),
           J(JL.rmsnorm, jnp.asarray(a).astype(jnp.bfloat16), w, static={"eps": 1e-5}), 0)
    _close(TL.rmsnorm(_t(a), _t(w), 1e-6), J(JL.rmsnorm, a, w, static={"eps": 1e-6}), F32_RTOL)
    pos = np.arange(40)[None]
    jc, js = J(JL.rope_angles, pos, static={"head_dim": 32, "theta": 10000.0})
    tc, ts = TL.rope_angles(_t(pos), 32, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2.5e-7)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=2.5e-7)
    x = rng.normal(size=(2, 40, 4, 32)).astype(np.float32)
    _close(TL.apply_rope(_t(x).bfloat16(), _t(np.asarray(jc)), _t(np.asarray(js))),
           J(JL.apply_rope, jnp.asarray(x).astype(jnp.bfloat16), jc, js), 0)
    g = rng.normal(size=(4, 96)).astype(np.float32) * 3
    _close(TL.silu(_t(g).bfloat16()), jax.nn.silu(jnp.asarray(g).astype(jnp.bfloat16)), 0)
    _close(TL.softplus(_t(g)), jax.nn.softplus(g), F32_RTOL)
    _close(TL.softmax(_t(g)), jax.nn.softmax(g), F32_RTOL)


def _qkv(rng, s, t, h=4, kh=2, d=16):
    q = rng.normal(size=(2, s, h, d)).astype(np.float32)
    k = rng.normal(size=(2, t, kh, d)).astype(np.float32)
    v = rng.normal(size=(2, t, kh, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("seed", SEEDS)
def test_sdpa_and_flash(seed):
    """`_sdpa` with a causal, a windowed and no mask; `flash_attention_gqa`
    at 16-position blocks over s = 64: causal, windowed, t > s (queries at
    t - s + i), and a block whose rows the window masks fully."""
    rng = _rng(seed)
    q, k, v = _qkv(rng, 24, 24)
    for window in (0, 5):
        _close(TL._sdpa(_t(q), _t(k), _t(v), TL.causal_mask(24, 24, window)),
               J(JL._sdpa, q, k, v, JL.causal_mask(24, 24, window)), SDPA_RTOL)
    _close(TL._sdpa(_t(q), _t(k), _t(v), None), J(JL._sdpa, q, k, v, jnp.ones((), bool)),
           SDPA_RTOL)
    for s, t, causal, window in [(64, 64, True, 0), (64, 64, True, 20), (64, 64, False, 0),
                                 (32, 64, True, 0), (32, 64, True, 10)]:
        q, k, v = _qkv(rng, s, t)
        got = TL.flash_attention_gqa(_t(q), _t(k), _t(v), causal=causal, window=window,
                                     q_blk=16, kv_blk=16)
        want = J(JL.flash_attention_gqa, q, k, v,
                 static=dict(causal=causal, window=window, q_blk=16, kv_blk=16))
        _close(got, want, SDPA_RTOL)
        assert bool(torch.isfinite(got.float()).all())


def _gqa_params(rng, d=64, h=4, kh=2, hd=16):
    return {"wq": rng.normal(size=(d, h * hd)) / 8, "wk": rng.normal(size=(d, kh * hd)) / 8,
            "wv": rng.normal(size=(d, kh * hd)) / 8, "wo": rng.normal(size=(h * hd, d)) / 8}


def _f32(tree):
    return {k: np.asarray(v, np.float32) for k, v in tree.items()}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode", ["full", "windowed", "cached", "int8"])
def test_attention_gqa(seed, mode):
    """Full and windowed sequences, and 3 positions written at index 5 of an
    8-position bf16 or int8 cache holding earlier entries."""
    rng = _rng(seed)
    p = _f32(_gqa_params(rng))
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=16, rope_theta=10000.0)
    window = 6 if mode == "windowed" else 0
    if mode in ("full", "windowed"):
        x = rng.normal(size=(2, 20, 64)).astype(np.float32)
        pos = np.arange(20)[None]
        got, _ = TL.attention_gqa(_t(x).bfloat16(), params_from_numpy(p, "cpu"),
                                  positions=_t(pos), window=window, **kw)
        want, _ = J(JL.attention_gqa, jnp.asarray(x).astype(jnp.bfloat16), p,
                    static=dict(kw, window=window), positions=jnp.asarray(pos))
        _close(got, want, 0)
        return
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    pos = 5 + np.arange(3)[None]
    if mode == "int8":
        kv = rng.normal(size=(2, 2, 8, 2, 16)).astype(np.float32)
        kq, ks = J(JL._quantize_kv, kv[0])
        vq, vs = J(JL._quantize_kv, kv[1])
        tkq, tks = TL._quantize_kv(_t(kv[0]))
        _close(tkq, kq, 0)
        # XLA multiplies by 1/127 under jit where the port divides: an ulp
        _close(tks, ks, F32_RTOL)
        cache = {"k": np.asarray(kq), "v": np.asarray(vq), "k_scale": np.asarray(ks),
                 "v_scale": np.asarray(vs)}
    else:
        cache = {"k": rng.normal(size=(2, 8, 2, 16)).astype(np.float32),
                 "v": rng.normal(size=(2, 8, 2, 16)).astype(np.float32)}
    jcache = {k: jnp.asarray(v) for k, v in cache.items()}
    if mode == "cached":
        jcache = {k: v.astype(jnp.bfloat16) for k, v in jcache.items()}
    tcache = params_from_numpy({k: np.asarray(v) for k, v in jcache.items()}, "cpu")
    got, gc = TL.attention_gqa(_t(x).bfloat16(), params_from_numpy(p, "cpu"),
                               positions=_t(pos), cache=tcache, cache_index=5, **kw)
    want, wc = J(JL.attention_gqa, jnp.asarray(x).astype(jnp.bfloat16), p, static=kw,
                 positions=jnp.asarray(pos), cache=jcache, cache_index=5)
    _close(got, want, 0)
    for key in wc:
        assert gc[key].dtype == getattr(torch, str(wc[key].dtype))
        exact = gc[key].dtype != torch.float32
        _close(gc[key].float(), wc[key].astype(jnp.float32), 0 if exact else F32_RTOL)


def _mla_cfg():
    return C.small(get_arch("minicpm3-4b"))


def _mla_params(rng, cfg):
    d, h, r, q = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank, cfg.q_lora_rank
    dq = cfg.nope_head_dim + cfg.rope_head_dim
    shapes = {"w_dq": (d, q), "w_uq": (q, h * dq), "w_dkv": (d, r),
              "w_krope": (d, cfg.rope_head_dim), "w_uk": (r, h * cfg.nope_head_dim),
              "w_uv": (r, h * cfg.resolved_v_head_dim), "wo": (h * cfg.resolved_v_head_dim, d)}
    return {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32) for k, s in shapes.items()}


def _mla_kw(cfg):
    return dict(n_heads=cfg.n_heads, kv_lora_rank=cfg.kv_lora_rank, q_lora_rank=cfg.q_lora_rank,
                rope_head_dim=cfg.rope_head_dim, nope_head_dim=cfg.nope_head_dim,
                v_head_dim=cfg.resolved_v_head_dim, rope_theta=cfg.rope_theta)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode", ["full", "cached", "flash"])
def test_attention_mla(seed, mode, monkeypatch):
    """Full, cached (2 positions at index 4 of a 6-position cache), and the
    flash branch: FLASH_THRESHOLD lowered to 32 in both packages, so a
    64-position prefill folds nope and rope into one head dim there."""
    rng = _rng(seed)
    cfg = _mla_cfg()
    p = _mla_params(rng, cfg)
    kw = _mla_kw(cfg)
    tp = params_from_numpy(p, "cpu")
    if mode == "cached":
        x = rng.normal(size=(2, 2, 64)).astype(np.float32)
        pos = 4 + np.arange(2)[None]
        cache = {"ckv": rng.normal(size=(2, 6, cfg.kv_lora_rank)).astype(np.float32),
                 "krope": rng.normal(size=(2, 6, cfg.rope_head_dim)).astype(np.float32)}
        got, gc = TL.attention_mla(_t(x).bfloat16(), tp, positions=_t(pos),
                                   cache=params_from_numpy(cache, "cpu"), cache_index=4, **kw)
        want, wc = J(JL.attention_mla, jnp.asarray(x).astype(jnp.bfloat16), p, static=kw,
                     positions=jnp.asarray(pos), cache=cache, cache_index=4)
        _close(got, want, 0)
        for key in wc:
            _close(gc[key], wc[key], 0)
        return
    s = 64 if mode == "flash" else 20
    if mode == "flash":
        monkeypatch.setattr(JL, "FLASH_THRESHOLD", 32)
        monkeypatch.setattr(TL, "FLASH_THRESHOLD", 32)
    x = rng.normal(size=(2, s, 64)).astype(np.float32)
    pos = np.arange(s)[None]
    got, _ = TL.attention_mla(_t(x).bfloat16(), tp, positions=_t(pos), **kw)
    want, _ = J(JL.attention_mla, jnp.asarray(x).astype(jnp.bfloat16), p, static=kw,
                positions=jnp.asarray(pos))
    _close(got, want, MLA_FLASH_RTOL if mode == "flash" else 0)


def _moe_params(rng, d=64, e=4, f=128):
    return {"router": (rng.normal(size=(d, e)) / 8).astype(np.float32),
            "w_gate": (rng.normal(size=(e, d, f)) / 8).astype(np.float32),
            "w_up": (rng.normal(size=(e, d, f)) / 8).astype(np.float32),
            "w_down": (rng.normal(size=(e, f, d)) / 11).astype(np.float32)}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("top_k,cf", [(1, 1.25), (2, 1.0), (1, 0.3)])
def test_moe_ffn(seed, top_k, cf):
    """Top-1 and top-2 routing; at capacity factor 0.3 the queues overflow
    (capacity 4 for 48 routed tokens over 4 experts) and the dropped tokens
    add nothing, as in the reference."""
    rng = _rng(seed)
    p = _moe_params(rng)
    x = rng.normal(size=(2, 24, 64)).astype(np.float32)
    kw = dict(n_experts=4, top_k=top_k, capacity_factor=cf)
    got, gaux = TM.moe_ffn(_t(x).bfloat16(), params_from_numpy(p, "cpu"), **kw)
    want, waux = J(JM.moe_ffn, jnp.asarray(x).astype(jnp.bfloat16), p, static=kw)
    _close(got, want, MOE_RTOL)
    for key in ("lb_loss", "z_loss"):
        _close(gaux[key], waux[key], AUX_RTOL)
    if cf < 1:  # some routing slots overflowed: count them in both packages
        logits = J(JL.dot, jnp.asarray(x).astype(jnp.bfloat16).reshape(48, 64), p["router"])
        idx = np.asarray(jnp.argmax(logits, -1))
        assert np.bincount(idx, minlength=4).max() > max(int(cf * 48 / 4), 4)


def _ssm_cfg():
    return C.small(get_arch("mamba2-2.7b"))


def _ssd_inputs(rng, l, h=4, p=32, n=16):
    x = rng.normal(size=(2, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(2, l, h)))).astype(np.float32) * 0.5
    a_log = (rng.normal(size=(h,)) * 0.3).astype(np.float32)
    bm = rng.normal(size=(2, l, n)).astype(np.float32)
    cm = rng.normal(size=(2, l, n)).astype(np.float32)
    return x, dt, a_log, bm, cm


@pytest.mark.parametrize("seed", SEEDS)
def test_ssd(seed):
    """`ssd_chunked` over 40 positions in chunks of 16 (8 padded) and of 8,
    and one `ssd_decode_step` from its final state."""
    rng = _rng(seed)
    x, dt, a_log, bm, cm = _ssd_inputs(rng, 40)
    for chunk in (16, 8):
        got, gs = TS.ssd_chunked(*map(_t, (x, dt, a_log, bm, cm)), chunk)
        want, ws = J(JS.ssd_chunked, x, dt, a_log, bm, cm, static={"chunk": chunk})
        _close(got, want, SSD_RTOL)
        _close(gs, ws, SSD_RTOL)
    x1, dt1, _, bm1, cm1 = _ssd_inputs(rng, 1)
    got, gs2 = TS.ssd_decode_step(*map(_t, (x1, dt1, a_log, bm1, cm1)), _t(np.asarray(ws)))
    want, ws2 = J(JS.ssd_decode_step, x1, dt1, a_log, bm1, cm1, ws)
    _close(got, want, F32_RTOL)
    _close(gs2, ws2, F32_RTOL)


def _mamba_params(rng, cfg):
    from repro_torch.models.transformer import Init

    p = TS.init_mamba2_params(Init(int(rng.integers(1 << 30)), "cpu"), cfg)
    p["a_log"] = torch.from_numpy((rng.normal(size=p["a_log"].shape) * 0.3).astype(np.float32))
    p["dt_bias"] = torch.from_numpy((rng.normal(size=p["dt_bias"].shape) * 0.5).astype(np.float32))
    return p


@pytest.mark.parametrize("seed", SEEDS)
def test_mamba2_block(seed):
    """The full block over 20 positions (chunk 32: padded), then three
    cached single-token steps from float32 conv histories and a state."""
    rng = _rng(seed)
    cfg = _ssm_cfg()
    tp = _mamba_params(rng, cfg)
    p = {k: v.numpy() for k, v in tp.items()}
    x = rng.normal(size=(2, 20, 64)).astype(np.float32)
    got, _ = TS.mamba2_block(_t(x).bfloat16(), tp, cfg)
    want, _ = J(JS.mamba2_block, jnp.asarray(x).astype(jnp.bfloat16), p, static={"cfg": cfg})
    _close(got, want, MAMBA_RTOL)
    k, n, di = cfg.ssm_conv, cfg.ssm_state, cfg.d_inner
    cache = {"conv": {"x": rng.normal(size=(2, k - 1, di)).astype(np.float32),
                      "b": rng.normal(size=(2, k - 1, n)).astype(np.float32),
                      "c": rng.normal(size=(2, k - 1, n)).astype(np.float32)},
             "state": rng.normal(size=(2, cfg.ssm_heads, cfg.ssm_head_dim, n)).astype(np.float32)}
    tcache = params_from_numpy(cache, "cpu")
    jcache = cache
    for step in range(3):
        xs = rng.normal(size=(2, 1, 64)).astype(np.float32)
        got, tcache = TS.mamba2_block(_t(xs).bfloat16(), tp, cfg, cache=tcache)
        want, jcache = J(JS.mamba2_block, jnp.asarray(xs).astype(jnp.bfloat16), p,
                         static={"cfg": cfg}, cache=jcache)
        _close(got, want, MAMBA_RTOL)
        _close(tcache["state"], jcache["state"], MAMBA_RTOL)
        for key in ("x", "b", "c"):
            assert tcache["conv"][key].dtype == torch.float32
            _close(tcache["conv"][key], jcache["conv"][key], MAMBA_RTOL)


def test_mamba_init_ties_conv_b_and_c():
    """The reference draws conv_w_b and conv_w_c from one key, so they start
    equal; the port's initialisation keeps that (stacked too)."""
    from repro_torch.models.transformer import Init

    p = TS.init_mamba2_params(Init(0, "cpu"), _ssm_cfg(), lead=(3,))
    assert torch.equal(p["conv_w_b"], p["conv_w_c"])
    assert p["conv_w_b"].data_ptr() != p["conv_w_c"].data_ptr()


@pytest.mark.parametrize("index,s", [(7, 2), (8, 1), (-1, 1)])
def test_cache_overrun_refused_beside_reference_clamp(index, s):
    """A write past the cache's end: the reference's dynamic_update_slice
    clamps its start (index 7 with 2 positions into 8 writes at 6 and
    overwrites entry 6), the port raises ValueError before the write."""
    rng = _rng(0)
    p = _f32(_gqa_params(rng))
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=16, rope_theta=10000.0)
    x = rng.normal(size=(2, s, 64)).astype(np.float32)
    cache = {"k": np.ones((2, 8, 2, 16), np.float32), "v": np.ones((2, 8, 2, 16), np.float32)}
    pos = index + np.arange(s)[None]
    if index >= 0:
        _, wc = J(JL.attention_gqa, jnp.asarray(x), p, static=kw, positions=jnp.asarray(pos),
                  cache={k: jnp.asarray(v) for k, v in cache.items()}, cache_index=index)
        changed = np.flatnonzero(np.any(np.asarray(wc["k"]) != 1.0, axis=(0, 2, 3)))
        assert changed.tolist() == list(range(8 - s, 8))  # clamped to the end
    with pytest.raises(ValueError, match="runs past the cache"):
        TL.attention_gqa(_t(x), params_from_numpy(p, "cpu"), positions=_t(pos),
                         cache=params_from_numpy(cache, "cpu"), cache_index=index, **kw)
    mla = _mla_cfg()
    mcache = {"ckv": np.zeros((2, 8, mla.kv_lora_rank), np.float32),
              "krope": np.zeros((2, 8, mla.rope_head_dim), np.float32)}
    with pytest.raises(ValueError, match="runs past the cache"):
        TL.attention_mla(_t(x), params_from_numpy(_mla_params(rng, mla), "cpu"),
                         positions=_t(pos), cache=params_from_numpy(mcache, "cpu"),
                         cache_index=index, **_mla_kw(mla))
