"""RG-LRU recurrent block (Griffin / RecurrentGemma), the port of
`repro/models/rglru.py`.

Block structure (arXiv:2402.19427, Fig. 2):
    u -> [linear -> temporal conv1d -> RG-LRU] ⊙ [linear -> GeLU] -> linear -> out

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)            recurrence gate (block-diag W_a)
    i_t = sigmoid(W_x x_t + b_x)            input gate      (block-diag W_x)
    a_t = exp(c * r_t * log(Lambda))        Lambda = sigmoid(lambda_param)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

A prefill runs the linear recurrence as a log-depth doubling scan over the
sequence (ceil(log2 S) steps of whole [B, S, W] tensors), where `repro` runs
`jax.lax.associative_scan`: the sums are taken in another order, so the two
agree to float32 rounding. A decode step carries (h, conv window) state. The
recurrent state h stays float32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

_C = 8.0  # Griffin's fixed gate temperature
_N_BLOCKS = 16  # block-diagonal gate weight blocks, as in `repro`


class RGLRUState(NamedTuple):
    h: torch.Tensor  # [B, W] recurrent state (float32)
    conv: torch.Tensor  # [B, conv_width - 1, W] temporal-conv lookback


def init_rglru(create, cfg, layers: int) -> dict:
    """`repro`'s RG-LRU parameters, in its draw order and shapes."""
    d = cfg.d_model
    w = cfg.rglru.lru_width or d
    cw = cfg.rglru.conv_width
    bw = w // _N_BLOCKS
    return {
        "w_in": create((layers, d, w), fan_in=d),
        "w_gate_branch": create((layers, d, w), fan_in=d),
        "conv_w": create((layers, cw, w), fan_in=cw),
        "conv_b": create((layers, w), mode="zeros"),
        "w_a": create((layers, _N_BLOCKS, bw, bw), fan_in=bw),
        "b_a": create((layers, w), mode="zeros"),
        "w_x": create((layers, _N_BLOCKS, bw, bw), fan_in=bw),
        "b_x": create((layers, w), mode="zeros"),
        "lam": create((layers, w), mode="ones"),
        "w_out": create((layers, w, d), fan_in=w),
    }


def init_rglru_state(cfg, batch: int, dtype, device, layers: int = 0) -> RGLRUState:
    """Zero state: h [B, W] float32, conv [B, cw - 1, W] in `dtype`, with a
    leading [layers] dim when `layers` > 0."""
    w = cfg.rglru.lru_width or cfg.d_model
    lead = (layers,) if layers else ()
    return RGLRUState(torch.zeros(lead + (batch, w), dtype=torch.float32, device=device),
                      torch.zeros(lead + (batch, cfg.rglru.conv_width - 1, w), dtype=dtype,
                                  device=device))


def _block_diag_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., W] @ block-diagonal w [NB, W/NB, W/NB] -> [..., W]."""
    nb, bw, _ = w.shape
    xs = x.reshape(*x.shape[:-1], nb, bw)
    return torch.einsum("...ni,nij->...nj", xs, w).reshape(x.shape)


def _gates(p: dict, x: torch.Tensor):
    """x [..., W] -> (a, gated input), both float32."""
    xf = x.float()
    r = torch.sigmoid(_block_diag_mm(xf, p["w_a"].float()) + p["b_a"])
    i = torch.sigmoid(_block_diag_mm(xf, p["w_x"].float()) + p["b_x"])
    log_lam = F.logsigmoid(p["lam"].float())
    a = torch.exp(_C * r * log_lam)  # log a <= 0
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, gated


def _conv1d(p: dict, x: torch.Tensor, lookback: Optional[torch.Tensor] = None):
    """Causal temporal conv of width cw. x [B, S, W]; lookback [B, cw-1, W]
    -> (out [B, S, W], the new lookback)."""
    cw = p["conv_w"].shape[0]
    if lookback is None:
        lookback = x.new_zeros(x.shape[0], cw - 1, x.shape[2])
    xp = torch.cat([lookback, x], dim=1)  # [B, S + cw - 1, W]
    S = x.shape[1]
    out = sum(xp[:, i:i + S, :] * p["conv_w"][i][None, None, :] for i in range(cw))
    new_lookback = xp[:, -(cw - 1):, :] if cw > 1 else lookback
    return out + p["conv_b"][None, None, :], new_lookback


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t with h_{-1} = 0 over dim 1 of [B, S, W], as a
    doubling scan: after the step of offset k every h_t holds the
    recurrence over its last 2k inputs, so ceil(log2 S) steps cover all."""
    S = a.shape[1]
    k = 1
    while k < S:
        b = torch.cat([b[:, :k], torch.addcmul(b[:, k:], a[:, k:], b[:, :-k])], dim=1)
        if 2 * k < S:  # the last step needs no composed a
            a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b


def apply_rglru_seq(cfg, p: dict, u: torch.Tensor, state: Optional[RGLRUState] = None):
    """Full-sequence (prefill) path. u [B, S, d] -> (out [B, S, d], state)."""
    x = u @ p["w_in"]
    gate = u @ p["w_gate_branch"]
    x, new_lookback = _conv1d(p, x, None if state is None else state.conv)
    a, gated = _gates(p, x)  # [B, S, W] float32
    if state is not None:
        gated = torch.cat([gated[:, :1] + a[:, :1] * state.h[:, None], gated[:, 1:]], dim=1)
    h = linear_scan(a, gated)  # [B, S, W] float32
    y = h.to(u.dtype) * F.gelu(gate.float(), approximate="tanh").to(u.dtype)
    return y @ p["w_out"], RGLRUState(h[:, -1], new_lookback)


def apply_rglru_step(cfg, p: dict, u: torch.Tensor, state: RGLRUState):
    """One decode token. u [B, 1, d] -> (out [B, 1, d], the new state)."""
    x = u @ p["w_in"]  # [B, 1, W]
    gate = u @ p["w_gate_branch"]
    xp = torch.cat([state.conv, x], dim=1)  # [B, cw, W]
    cw = p["conv_w"].shape[0]
    xc = torch.einsum("bcw,cw->bw", xp[:, -cw:], p["conv_w"]) + p["conv_b"]
    a, gated = _gates(p, xc)  # [B, W]
    h = a * state.h + gated
    y = h[:, None, :].to(u.dtype) * F.gelu(gate.float(), approximate="tanh").to(u.dtype)
    return y @ p["w_out"], RGLRUState(h, xp[:, 1:] if cw > 1 else state.conv)
