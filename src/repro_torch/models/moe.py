"""Mixture-of-Experts FFN (llama4-style top-k routing); counterpart of
`repro.models.moe`.

Dispatch is scatter/gather, sort-free, as the reference's: each routed
token's place in its expert's capacity-bounded queue is a float32 prefix
sum over the one-hot routing matrix, an `index_add_` places it in an
(E * C + 1, D) float32 buffer whose last row takes the overflow, and a
gather at the clipped slot brings the expert outputs back. Aux losses:
switch-style load balance and the router z-loss.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dot, einsum_f32, silu, softmax


def _top_k(probs, k: int):
    """`jax.lax.top_k`: the k largest along the last axis, descending, the
    lower index first among equal values (a stable sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(x, p, *, n_experts: int, top_k: int, capacity_factor: float,
            rules=None):
    """x (B, S, D) -> (out (B, S, D), aux dict).

    p: router (D, E), w_gate/w_up (E, D, F), w_down (E, F, D). A sharded
    `rules` raises, as every sharding constraint of the port does."""
    if rules is not None and rules.enabled:
        from repro_torch.models.transformer import _constrain

        _constrain(x, None, rules)
    b, s, d = x.shape
    n_tok = b * s
    xt = x.reshape(n_tok, d)

    logits = dot(xt, p["router"])  # (N, E) bf16
    probs = softmax(logits.float(), dim=-1)

    gate_vals, gate_idx = _top_k(probs, top_k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    capacity = max(int(capacity_factor * n_tok * top_k / n_experts), 4)

    # Queue position of each routing slot within its expert: a float32
    # prefix sum over the (N * k, E) one-hot routing matrix.
    flat_idx = gate_idx.reshape(n_tok * top_k)
    onehot = F.one_hot(flat_idx, n_experts).to(torch.float32)
    pos = (torch.cumsum(onehot, dim=0) - 1.0).gather(1, flat_idx[:, None])[:, 0]
    pos = pos.to(torch.int64)
    keep = pos < capacity

    # Tokens into the expert buffers, the overflow into the dump row.
    slot = torch.where(keep, flat_idx * capacity + pos,
                       torch.full_like(pos, n_experts * capacity))
    xrep = torch.repeat_interleave(xt, top_k, dim=0).float()
    buf = torch.zeros((n_experts * capacity + 1, d), dtype=torch.float32,
                      device=x.device).index_add(0, slot, xrep)
    ebuf = buf[:-1].reshape(n_experts, capacity, d)

    # Per-expert SwiGLU, batched over the expert axis.
    g = einsum_f32("ecd,edf->ecf", ebuf, p["w_gate"])
    u = einsum_f32("ecd,edf->ecf", ebuf, p["w_up"])
    h = silu(g) * u
    eout = einsum_f32("ecf,efd->ecd", h, p["w_down"])

    # Expert outputs back to their tokens, weighted by the gates, top-k folded.
    flat_out = eout.reshape(n_experts * capacity, d)
    tok_out = flat_out[torch.clamp(slot, 0, n_experts * capacity - 1)]
    tok_out = tok_out * (keep.to(torch.float32) * gate_vals.reshape(-1))[:, None]
    out = tok_out.reshape(n_tok, top_k, d).sum(dim=1)

    frac_tokens = F.one_hot(gate_idx[:, 0], n_experts).to(torch.float32).mean(dim=0)
    frac_probs = probs.mean(dim=0)
    lb_loss = n_experts * torch.sum(frac_tokens * frac_probs)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits.float(), dim=-1)))

    # back to the residual-stream dtype (bf16 in training)
    return out.reshape(b, s, d).to(x.dtype), {"lb_loss": lb_loss, "z_loss": z_loss}
