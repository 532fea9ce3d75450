"""Mixture-of-Experts layer (the port of `repro/models/moe.py`): token-choice
top-k routing with capacity-based one-hot dispatch (overflow dropped), in
plain PyTorch. `repro` has no Pallas kernel for it, so the port has none.

The dense formulation is `repro`'s: routing and capacity are per
(sequence, chunk of MOE_CHUNK tokens), each (token, pick) assignment takes
the next free slot of its expert's buffer in flattened (token, pick) order,
and every expert runs over its whole buffer (empty slots hold zeros), so a
call reads every expert's weights whatever the routing. `repro`'s
"tp" / "ep" parallelism modes shard over a mesh; on one card they compute
the same thing and the field is only carried.

Ties: `jax.lax.top_k` orders equal router probabilities lowest expert
first, and the order of the k picks sets the capacity positions of the
cumulative sum, so the picks are taken from a stable descending sort
(`torch.topk` promises no tie order).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def init_moe(create, cfg, layers: int) -> dict:
    """Stacked router [L, d, E] and expert weights wi / wg [L, E, d, f], wo
    [L, E, f, d] (wg for SwiGLU only), in `repro`'s draw order."""
    d, m = cfg.d_model, cfg.moe
    p = {
        "router": create((layers, d, m.n_experts), fan_in=d),
        "wi": create((layers, m.n_experts, d, m.d_ff), fan_in=d),
        "wo": create((layers, m.n_experts, m.d_ff, d), fan_in=m.d_ff),
    }
    if cfg.mlp_kind == "swiglu":
        p["wg"] = create((layers, m.n_experts, d, m.d_ff), fan_in=d)
    return p


def _capacity(cfg, chunk_tokens: int) -> int:
    """Slots an expert's buffer has for a chunk: `repro`'s int() truncation,
    rounded up to a multiple of 8 from 8 on, within [1, chunk_tokens]."""
    m = cfg.moe
    cap = int(chunk_tokens * m.top_k * m.capacity_factor / m.n_experts)
    cap = max(1, min(chunk_tokens, (cap + 7) // 8 * 8 if cap >= 8 else cap))
    return cap


MOE_CHUNK = 4096  # sequence chunk for per-chunk capacity


def route(probs: torch.Tensor, top_k: int):
    """The top-k picks of float32 router probabilities [..., E] -> (gates
    [..., k], renormalised to sum 1; expert ids [..., k] int64), in
    descending order with ties to the lowest expert id, as `jax.lax.top_k`
    breaks them."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :top_k], idx[..., :top_k]
    return vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9), idx


def apply_moe(cfg, p: dict, x: torch.Tensor):
    """x [B, S, d] -> (y [B, S, d], the Switch load-balancing aux loss, a
    float32 scalar). Routing and capacity are per (sequence, chunk): a
    decode row or a spec-verify row is a sequence of one token (capacity
    1, nothing dropped), a padded prefill bucket routes its pad tokens too
    (after the real ones, so they never take a real token's slot)."""
    m = cfg.moe
    B, S, d = x.shape
    Sc = min(S, MOE_CHUNK)
    assert S % Sc == 0, (S, Sc)
    nc, E, K = S // Sc, m.n_experts, m.top_k
    cap = _capacity(cfg, Sc)
    xc = x.reshape(B * nc, Sc, d)

    probs = torch.softmax((xc @ p["router"]).float(), dim=-1)  # [B*nc, Sc, E]
    gate_vals, expert_idx = route(probs, K)  # [B*nc, Sc, K]

    # the position of each (token, pick) in its expert's buffer: a running
    # count over the flattened (token, pick) order, token-major
    onehot = F.one_hot(expert_idx, E)  # [B*nc, Sc, K, E] int64
    pos_flat = torch.cumsum(onehot.reshape(B * nc, Sc * K, E), dim=1) - 1
    pos = (pos_flat.reshape(B * nc, Sc, K, E) * onehot).sum(-1)  # [B*nc, Sc, K]
    keep = pos < cap

    onehot_e = onehot.to(x.dtype)
    slot = F.one_hot(torch.where(keep, pos, torch.full_like(pos, cap)), cap + 1)
    slot = slot[..., :cap].to(x.dtype)  # a dropped pick has no slot
    disp = torch.einsum("tske,tskc->tsec", onehot_e, slot)  # [B*nc, Sc, E, cap]
    gates_e = torch.einsum("tsk,tske->tse", gate_vals.to(x.dtype), onehot_e)
    combine = disp * gates_e[..., None]

    # dispatch: each (expert, slot) row gathers its token (one-hot: exact)
    disp_f = disp.reshape(B * nc, Sc, E * cap)
    xe = (disp_f.transpose(1, 2) @ xc).reshape(B * nc, E, cap, d)
    xe = xe.permute(1, 0, 2, 3).reshape(E, B * nc * cap, d)  # expert-major rows
    h = torch.bmm(xe, p["wi"])
    if cfg.mlp_kind == "swiglu":
        g = torch.bmm(xe, p["wg"])
        h = F.silu(g.float()).to(x.dtype) * h
    else:
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)  # jax.nn.gelu's default
    ye = torch.bmm(h, p["wo"])  # [E, B*nc*cap, d]
    ye = ye.reshape(E, B * nc, cap, d).permute(1, 0, 2, 3).reshape(B * nc, E * cap, d)
    yt = combine.reshape(B * nc, Sc, E * cap) @ ye  # [B*nc, Sc, d]

    # Switch-style load balancing: the first pick's share of tokens times the
    # mean router probability, per expert
    frac_tokens = F.one_hot(expert_idx[..., 0], E).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_probs)
    return yt.reshape(B, S, d), aux
