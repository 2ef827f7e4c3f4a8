"""Mamba2 blocks via SSD, state-space duality (arXiv:2405.21060);
counterpart of `repro.models.ssm`.

The chunked SSD algorithm: the sequence is split into chunks of Q tokens;
within a chunk the recurrence is an attention-like quadratic form, across
chunks a short loop carries the (H, P, N) state. Decode is the O(1)
recurrence, in float32.

Shapes: x (B, L, H, P) heads x head_dim, B/C (B, L, N) (single group),
dt (B, L, H), A (H,) negative reals (stored as log magnitude).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dot, dot_tp_out, einsum_f32, rmsnorm, silu, softplus


def _segsum_exp(dA_cs):
    """dA_cs (..., Q) inclusive cumsum -> exp lower-triangular decay
    (..., Q, Q): L[i, j] = exp(cs[i] - cs[j]) for i >= j else 0."""
    q = dA_cs.shape[-1]
    diff = dA_cs[..., :, None] - dA_cs[..., None, :]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dA_cs.device))
    # Mask BEFORE exp: exp of a large positive (upper-triangle) diff is inf,
    # and where(tri, inf, 0) poisons the backward with 0 * inf = NaN.
    return torch.exp(torch.where(tri, diff, float("-inf")))


def ssd_chunked(x, dt, a_log, bm, cm, chunk: int):
    """Full-sequence SSD. Returns y (B, L, H, P) and the final state
    (B, H, P, N)."""
    bsz, l, h, p = x.shape
    n = bm.shape[-1]
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, pad))
    lp = l + pad
    nc = lp // chunk
    a = -torch.exp(a_log.float())  # (H,) negative

    xr = x.reshape(bsz, nc, chunk, h, p)
    dtr = dt.reshape(bsz, nc, chunk, h)
    br = bm.reshape(bsz, nc, chunk, n)
    cr = cm.reshape(bsz, nc, chunk, n)

    dA = dtr * a  # (b, c, q, h)
    cs = torch.cumsum(dA, dim=2)

    # --- intra-chunk (quadratic, attention-like) ---------------------------
    decay = _segsum_exp(cs.transpose(-1, -2))  # (b, c, h, q, q)
    scores = einsum_f32("bcqn,bckn->bcqk", cr, br)
    w = scores[:, :, None] * decay * dtr.transpose(-1, -2)[:, :, :, None, :]
    y_intra = einsum_f32("bchqk,bckhp->bcqhp", w, xr)

    # --- chunk states -------------------------------------------------------
    last = cs[:, :, -1:, :]  # (b, c, 1, h)
    sdecay = torch.exp(last - cs)  # (b, c, q, h)
    wx = xr * (sdecay * dtr)[..., None]  # (b, c, q, h, p)
    states = einsum_f32("bcqn,bcqhp->bchpn", br, wx)

    # --- inter-chunk recurrence: the state entering each chunk -------------
    chunk_decay = torch.exp(last[:, :, 0])  # (b, c, h)
    s = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)  # (b, c, h, p, n)

    # --- inter-chunk contribution -------------------------------------------
    qdecay = torch.exp(cs)  # (b, c, q, h)
    y_inter = einsum_f32("bcqn,bchpn->bcqhp", cr, prev)
    y_inter = y_inter * qdecay[..., None]

    y = (y_intra + y_inter).reshape(bsz, lp, h, p)[:, :l]
    return y, s


def ssd_decode_step(x, dt, a_log, bm, cm, state):
    """One-token recurrence in float32. x (B, 1, H, P), dt (B, 1, H),
    bm/cm (B, 1, N), state (B, H, P, N) -> (y (B, 1, H, P), new_state)."""
    a = -torch.exp(a_log.float())
    dA = torch.exp(dt[:, 0] * a)  # (B, H)
    upd = torch.einsum("bn,bhp->bhpn", bm[:, 0], x[:, 0] * dt[:, 0, :, None])
    new_state = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, cm[:, 0])
    return y[:, None], new_state


def _causal_conv(inp, w, b, k: int, hist=None):
    """Depthwise causal conv1d over the sequence, then SiLU. With `hist`
    (B, k - 1, C), the history goes in front and the new history comes
    back."""
    l = inp.shape[1]
    if hist is None:
        padded = F.pad(inp, (0, 0, k - 1, 0))
        out = sum(padded[:, i:i + l] * w[i][None, None, :] for i in range(k))
        return silu(out + b), None
    full = torch.cat([hist, inp.to(hist.dtype)], dim=1)  # (B, k - 1 + l, C)
    out = sum(full[:, i:i + l] * w[i][None, None, :] for i in range(k))
    return silu(out + b), full[:, -(k - 1):]


def mamba2_block(x, p, cfg, *, cache=None):
    """Full Mamba2 block: in_proj -> conv -> SSD -> gated norm -> out_proj.

    cache: None (full sequence) or dict(conv {x, b, c} (B, K - 1, C),
    state (B, H, P, N)) for single-token decode. Returns (out, new_cache)."""
    bsz, l, _ = x.shape
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim
    di = cfg.d_inner

    # One projection a stream, as the reference's (no fused zxbcdt matmul).
    z = dot(x, p["w_z"])
    xin = dot(x, p["w_x"])
    bm = dot(x, p["w_b"])
    cm = dot(x, p["w_c"])
    dt = dot(x, p["w_dt"])
    dt = softplus(dt + p["dt_bias"])

    k = cfg.ssm_conv
    hists = (cache or {}).get("conv", {})
    xs, hx = _causal_conv(xin, p["conv_w_x"], p["conv_b_x"], k, hists.get("x"))
    bm, hb = _causal_conv(bm, p["conv_w_b"], p["conv_b_b"], k, hists.get("b"))
    cm, hc = _causal_conv(cm, p["conv_w_c"], p["conv_b_c"], k, hists.get("c"))
    xs = xs.reshape(bsz, l, h, pdim)

    new_cache = None
    if cache is None:
        y, _ = ssd_chunked(xs, dt, p["a_log"], bm, cm, cfg.ssm_chunk)
    else:
        y, final = ssd_decode_step(xs, dt, p["a_log"], bm, cm, cache["state"])
        new_cache = {"conv": {"x": hx, "b": hb, "c": hc}, "state": final}

    y = y + xs * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, l, di)
    y = rmsnorm(y * silu(z), p["norm_w"], cfg.norm_eps)
    return dot_tp_out(y, p["out_proj"]), new_cache


def init_mamba2_params(init, cfg, lead=()):
    """One Mamba2 block's parameters (stacked in front by `lead`), the
    reference's shapes and scales, drawn by the port's `Init`."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    d = cfg.d_model
    nrm = functools.partial(init.normal, lead=lead)
    const = functools.partial(init.const, lead=lead)
    conv_w_b = nrm((cfg.ssm_conv, n)) * 0.1
    return {
        "w_z": nrm((d, di)) / d ** 0.5,
        "w_x": nrm((d, di)) / d ** 0.5,
        "w_b": nrm((d, n)) / d ** 0.5,
        "w_c": nrm((d, n)) / d ** 0.5,
        "w_dt": nrm((d, h)) / d ** 0.5,
        "out_proj": nrm((di, d)) / di ** 0.5,
        "conv_w_x": nrm((cfg.ssm_conv, di)) * 0.1,
        "conv_b_x": const((di,), 0.0),
        "conv_w_b": conv_w_b,
        "conv_b_b": const((n,), 0.0),
        # The reference draws conv_w_b and conv_w_c from the same key
        # (src/repro/models/ssm.py:180-182), so they start equal.
        "conv_w_c": conv_w_b.clone(),
        "conv_b_c": const((n,), 0.0),
        "dt_bias": const((h,), 0.0),
        "a_log": const((h,), 0.0),  # A = -1
        "d_skip": const((h,), 1.0),
        "norm_w": const((di,), 1.0),
    }


def mamba2_param_specs(mesh_model_axis: str = "model"):
    """Partition specs of `init_mamba2_params`: the wide streams (z, x, dt,
    heads) over `model`; the small shared B/C streams replicated."""
    from repro_torch.models.transformer import P

    m = mesh_model_axis
    return {
        "w_z": P(None, m),
        "w_x": P(None, m),
        "w_b": P(None, None),
        "w_c": P(None, None),
        "w_dt": P(None, m),
        "out_proj": P(m, None),
        "conv_w_x": P(None, m),
        "conv_b_x": P(m),
        "conv_w_b": P(None, None),
        "conv_b_b": P(None),
        "conv_w_c": P(None, None),
        "conv_b_c": P(None),
        "dt_bias": P(m),
        "a_log": P(m),
        "d_skip": P(m),
        "norm_w": P(m),
    }


def mamba_cache(cfg, batch: int, lead: tuple, device) -> dict:
    """A Mamba2 layer's float32 decode cache, stacked in front by `lead`."""
    kk, n = cfg.ssm_conv, cfg.ssm_state
    z = functools.partial(torch.zeros, dtype=torch.float32, device=device)
    return {
        "conv": {
            "x": z((*lead, batch, kk - 1, cfg.d_inner)),
            "b": z((*lead, batch, kk - 1, n)),
            "c": z((*lead, batch, kk - 1, n)),
        },
        "state": z((*lead, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)),
    }
