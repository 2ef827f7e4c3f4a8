"""Shared transformer layers: RMSNorm, RoPE, GQA / MLA attention, SwiGLU;
counterpart of `repro.models.layers`.

Mixed precision as in the reference: parameters are stored float32,
matmuls take bf16 operands. `dot` returns bf16 (float32 sums rounded once),
`dot_f32` and every contraction the reference asks `preferred_element_type=
float32` of return float32 sums of the exact bf16 products. The CPU has no
bf16 matmul with a float32 output, so those contractions run on the bf16
values upcast to float32: the products of two bf16 numbers are exact in
float32 (and in TF32), so the result is the float32 sum either way. On the
card `dot` is cuBLAS's bf16 GEMM (float32 accumulation; whether cuBLAS may
reduce in lower precision is `torch.backends.cuda.matmul.
allow_bf16_reduced_precision_reduction`, which this module leaves as the
caller set it).

Attention runs three modes, as the reference's: full causal (train /
prefill, the blocked online softmax from FLASH_THRESHOLD tokens on), a KV
cache (decode, bf16 or int8 entries) and a sliding window. Masked scores
are -1e30 in float32, never -inf, so a fully masked row is the reference's
uniform softmax, not NaN. A cache write that would run past the cache's
end raises ValueError; JAX's `dynamic_update_slice` would clamp the write's
start instead (ROADMAP queue 3).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BF16 = torch.bfloat16
F32 = torch.float32
NEG = -1e30  # masked score, float32 (layers.py:81 of the reference)


def _f32_of_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, as float32: an exact operand for float32 sums."""
    return x.to(BF16).to(F32)


def dot(a, b):
    """bf16 matmul, bf16 out: float32 sums of the bf16 products, rounded to
    bf16 once. On meta tensors (the dry run) it takes the card's path."""
    if a.is_cuda or a.is_meta:
        return torch.matmul(a.to(BF16), b.to(BF16))
    return torch.matmul(_f32_of_bf16(a), _f32_of_bf16(b)).to(BF16)


def dot_f32(a, b):
    """bf16 operands, float32 sums out (the lm_head: logits stay float32)."""
    return torch.matmul(_f32_of_bf16(a), _f32_of_bf16(b))


# Row-parallel output projections (wo / w_down / out_proj): the same
# contract, named apart for intent, as in the reference.
dot_tp_out = dot


def einsum_f32(eq: str, *ops):
    """`jnp.einsum(eq, *(o.astype(bf16)), preferred_element_type=float32)`."""
    return torch.einsum(eq, *(_f32_of_bf16(o) for o in ops))


def einsum_bf16(eq: str, *ops):
    """`jnp.einsum(eq, *(o.astype(bf16)), preferred_element_type=bf16)`."""
    return einsum_f32(eq, *ops).to(BF16)


def silu(x):
    """`jax.nn.silu`: x * (1 / (1 + exp(-x))), each operation rounded to x's
    dtype (in bf16 XLA rounds after every step; `F.silu` rounds once)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def softplus(x):
    """`jax.nn.softplus`, i.e. logaddexp(x, 0)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def softmax(x, dim: int = -1):
    """`jax.nn.softmax`: exp(x - max) divided by its sum."""
    e = torch.exp(x - torch.amax(x, dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


def rmsnorm(x, w, eps):
    dt = x.dtype
    x = x.to(F32)
    s = torch.mean(x * x, dim=-1, keepdim=True)
    # stats in float32; output back in the stream dtype (bf16 in training)
    return (x * torch.rsqrt(s + eps) * w).to(dt)


def rope_angles(positions, head_dim: int, theta: float):
    """positions (...,) int -> cos/sin (..., head_dim // 2), float32."""
    dev = positions.device
    exps = torch.arange(0, head_dim, 2, dtype=F32, device=dev) / torch.tensor(
        float(head_dim), dtype=F32, device=dev)
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=F32, device=dev), exps)
    ang = positions.to(F32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., S, H, D); cos/sin (..., S, D // 2) broadcast over heads.
    Rotation in float32, the result back in the stream dtype."""
    dt = x.dtype
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


def swiglu(x, w_gate, w_up, w_down):
    g = dot(x, w_gate)
    u = dot(x, w_up)
    return dot(silu(g) * u, w_down)


def _rsqrt_dim(d: int, device) -> torch.Tensor:
    return torch.tensor(1.0, dtype=F32, device=device) / torch.sqrt(
        torch.tensor(float(d), dtype=F32, device=device))


def _sdpa(q, k, v, mask):
    """q (B, S, H, D), k/v (B, T, K, D) with H = G * K query groups per kv
    head; mask broadcast to (B, K, G, S, T), or None for no mask."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    q = q.reshape(b, s, kh, g, d)
    scores = einsum_f32("bskgd,btkd->bkgst", q, k) / torch.sqrt(
        torch.tensor(float(d), dtype=F32, device=q.device))
    if mask is not None:
        scores = torch.where(mask, scores, NEG)
    p = softmax(scores, dim=-1)
    out = einsum_bf16("bkgst,btkd->bskgd", p, v)
    return out.reshape(b, s, h, d)


def flash_attention_gqa(q, k, v, *, causal: bool, window: int = 0,
                        q_blk: int = 512, kv_blk: int = 512):
    """Online-softmax attention over (q block, kv block) pairs: the
    reference's nested scans as Python loops, activation memory
    O(q_blk * kv_blk) a head. Every block pair is computed, the causal and
    window masks applied inside blocks, as in the reference; query i sits at
    absolute position t - s + i."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    q_blk, kv_blk = min(q_blk, s), min(kv_blk, t)
    assert s % q_blk == 0 and t % kv_blk == 0, (s, t, q_blk, kv_blk)
    nq, nk = s // q_blk, t // kv_blk
    off = t - s
    dev = q.device
    scale = _rsqrt_dim(d, dev)
    outs = []
    for qi in range(nq):
        qb = q[:, qi * q_blk:(qi + 1) * q_blk].reshape(b, q_blk, kh, g, d)
        qpos = off + qi * q_blk + torch.arange(q_blk, device=dev)
        m = torch.full((b, kh, g, q_blk), NEG, dtype=F32, device=dev)
        l = torch.zeros((b, kh, g, q_blk), dtype=F32, device=dev)
        acc = torch.zeros((b, kh, g, q_blk, d), dtype=F32, device=dev)
        for ki in range(nk):
            kb = k[:, ki * kv_blk:(ki + 1) * kv_blk]
            vb = v[:, ki * kv_blk:(ki + 1) * kv_blk]
            kpos = ki * kv_blk + torch.arange(kv_blk, device=dev)
            sc = einsum_f32("bqkgd,btkd->bkgqt", qb, kb) * scale
            mask = torch.ones((q_blk, kv_blk), dtype=torch.bool, device=dev)
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window > 0:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            sc = torch.where(mask, sc, NEG)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + einsum_f32("bkgqt,btkd->bkgqd", p, vb)
            m = m_new
        out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(BF16)
        outs.append(out.permute(0, 3, 1, 2, 4))  # (b, q_blk, kh, g, d)
    return torch.cat(outs, dim=1).reshape(b, s, h, d)


# From this token count on, full-sequence attention takes the flash path.
FLASH_THRESHOLD = 2048


def causal_mask(s: int, t: int, window: int = 0, device=None):
    """(1, 1, 1, s, t) bool; query i attends key j iff j <= i + (t - s)
    (and j > i + (t - s) - window with a window)."""
    return _cached_mask(t - s, s, t, window, device)[None, None, None]


def _quantize_kv(x):
    """(B, S, K, D) float -> (int8 values, (B, S, K) float32 scales):
    absmax a (token, head), round half to even as `jnp.round`."""
    xf = x.to(F32)
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp(amax, min=1e-6) / torch.tensor(127.0, dtype=F32, device=x.device)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _check_write(cache_len: int, cache_index: int, s: int) -> None:
    if cache_index < 0 or cache_index + s > cache_len:
        raise ValueError(
            f"a cache write of {s} position(s) at index {cache_index} runs past "
            f"the cache's {cache_len} positions; the reference's "
            "dynamic_update_slice would clamp its start to "
            f"{max(0, min(cache_index, cache_len - s))} and overwrite earlier "
            "entries (ROADMAP queue 3 item 18)")


def _write(buf, new, cache_index: int):
    """`buf` with `new` written along axis 1 from `cache_index` (a copy)."""
    out = buf.clone()
    out[:, cache_index:cache_index + new.shape[1]] = new.to(buf.dtype)
    return out


def _cached_mask(cache_index: int, s: int, t: int, window: int, device):
    """(s, t) bool: query i, at position cache_index + i, attends key j iff
    j <= cache_index + i (and j > cache_index + i - window with a window)."""
    kj = torch.arange(t, device=device)[None, :]
    qi = cache_index + torch.arange(s, device=device)[:, None]
    m = kj <= qi
    if window > 0:
        m = m & (kj > qi - window)
    return m


def attention_gqa(x, p, *, n_heads: int, n_kv_heads: int, head_dim: int,
                  rope_theta: float, positions, cache=None, cache_index=None,
                  window: int = 0, causal: bool = True):
    """Returns (out, new_cache). Full sequence when cache is None; a short
    decode step against the cache (dict k, v of (B, T, K, D), plus k_scale,
    v_scale for an int8 cache) at `cache_index` otherwise."""
    b, s, _ = x.shape
    q = dot(x, p["wq"]).reshape(b, s, n_heads, head_dim)
    k = dot(x, p["wk"]).reshape(b, s, n_kv_heads, head_dim)
    v = dot(x, p["wv"]).reshape(b, s, n_kv_heads, head_dim)

    cos, sin = rope_angles(positions, head_dim, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    new_cache = None
    if cache is None:
        if s >= FLASH_THRESHOLD:
            out = flash_attention_gqa(q, k, v, causal=causal, window=window)
        else:
            mask = causal_mask(s, s, window, x.device) if causal else None
            out = _sdpa(q, k, v, mask)
    else:
        cache_index = int(cache_index)
        _check_write(cache["k"].shape[1], cache_index, s)
        if cache["k"].dtype == torch.int8:
            # int8 KV cache: per-(token, head) absmax quantisation, dequant
            # on read, as the reference's.
            kq, ks = _quantize_kv(k)
            vq, vs = _quantize_kv(v)
            new_cache = {"k": _write(cache["k"], kq, cache_index),
                         "v": _write(cache["v"], vq, cache_index),
                         "k_scale": _write(cache["k_scale"], ks, cache_index),
                         "v_scale": _write(cache["v_scale"], vs, cache_index)}
            ck = new_cache["k"].to(BF16) * new_cache["k_scale"][..., None].to(BF16)
            cv = new_cache["v"].to(BF16) * new_cache["v_scale"][..., None].to(BF16)
        else:
            ck = _write(cache["k"], k, cache_index)
            cv = _write(cache["v"], v, cache_index)
            new_cache = {"k": ck, "v": cv}
        m = _cached_mask(cache_index, s, ck.shape[1], window, x.device)
        out = _sdpa(q, ck, cv, m[None, None, None])

    out = dot_tp_out(out.reshape(b, s, n_heads * head_dim), p["wo"])
    return out, new_cache


def attention_mla(x, p, *, n_heads: int, kv_lora_rank: int, q_lora_rank: int,
                  rope_head_dim: int, nope_head_dim: int, v_head_dim: int,
                  rope_theta: float, positions, cache=None, cache_index=None,
                  window: int = 0):
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style): the KV
    state is a rank-R latent plus one shared RoPE key; the cache (dict ckv
    (B, T, R), krope (B, T, Dr)) stores the latent, up-projected every
    step, as the reference does."""
    b, s, _ = x.shape
    dq = nope_head_dim + rope_head_dim

    cq = dot(x, p["w_dq"])
    q = dot(cq, p["w_uq"]).reshape(b, s, n_heads, dq)
    q_nope, q_rope = q[..., :nope_head_dim], q[..., nope_head_dim:]

    ckv = dot(x, p["w_dkv"])
    krope = dot(x, p["w_krope"]).reshape(b, s, 1, rope_head_dim)

    cos, sin = rope_angles(positions, rope_head_dim, rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    krope = apply_rope(krope, cos, sin)

    new_cache = None
    if cache is not None:
        cache_index = int(cache_index)
        _check_write(cache["ckv"].shape[1], cache_index, s)
        ckv = _write(cache["ckv"], ckv, cache_index)
        krope_t = _write(cache["krope"], krope[:, :, 0], cache_index)
        new_cache = {"ckv": ckv, "krope": krope_t}
        krope_full = krope_t[:, :, None, :]
        t = ckv.shape[1]
        m = _cached_mask(cache_index, s, t, window, x.device)
    else:
        krope_full = krope
        t = s
        m = _cached_mask(0, s, t, window, x.device)

    k_nope = dot(ckv, p["w_uk"]).reshape(b, t, n_heads, nope_head_dim)
    value = dot(ckv, p["w_uv"]).reshape(b, t, n_heads, v_head_dim)

    if cache is None and s >= FLASH_THRESHOLD:
        # Long prefill: nope and rope folded into one head dim on the flash
        # path (v zero-padded to the q/k head dim, sliced after).
        qf = torch.cat([q_nope, q_rope], dim=-1)
        kf = torch.cat([k_nope, krope_full.expand(b, t, n_heads, rope_head_dim)], dim=-1)
        vf = F.pad(value, (0, dq - v_head_dim))
        out = flash_attention_gqa(qf, kf, vf, causal=True, window=window)
        out = out[..., :v_head_dim]
        out = dot_tp_out(out.reshape(b, s, n_heads * v_head_dim), p["wo"])
        return out, new_cache

    scale = _rsqrt_dim(dq, x.device)
    s_nope = einsum_f32("bshd,bthd->bhst", q_nope, k_nope)
    s_rope = einsum_f32("bshd,btxd->bhst", q_rope, krope_full)
    scores = (s_nope + s_rope) * scale
    scores = torch.where(m[None, None], scores, NEG)
    pattn = softmax(scores, dim=-1)
    out = einsum_bf16("bhst,bthd->bshd", pattn, value)
    out = dot_tp_out(out.reshape(b, s, n_heads * v_head_dim), p["wo"])
    return out, new_cache
