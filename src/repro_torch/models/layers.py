"""Shared building blocks (the port of `repro/models/layers.py`): parameter
creation, norms, rotary embeddings, MLPs, the embedding and the LM head.

Parameters are plain dicts of tensors with `repro`'s names and shapes
(stacked over layers), so the JAX package's parameters carry across one to
one (`repro_torch.convert.model_params_from_numpy`). The initialiser draws
from one `torch.Generator` in `repro`'s order with `repro`'s fan-in scaling;
the numbers differ from JAX's (another generator), the distribution does not.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


class Creator:
    """Concrete parameter creation on `device` in `dtype`: normal draws
    scaled by fan_in**-0.5 (0.02 without a fan-in), or zeros / ones. The
    `repro` creator's logical sharding axes are accepted and ignored."""

    def __init__(self, generator: torch.Generator, dtype=torch.float32, device=None):
        self.generator = generator
        self.dtype = dtype
        self.device = device if device is not None else generator.device

    def __call__(self, shape, axes=None, fan_in: Optional[int] = None, mode: str = "normal"):
        del axes
        if mode == "zeros":
            return torch.zeros(shape, dtype=self.dtype, device=self.device)
        if mode == "ones":
            return torch.ones(shape, dtype=self.dtype, device=self.device)
        scale = 0.02 if fan_in is None else fan_in**-0.5
        x = torch.randn(shape, generator=self.generator, device=self.device)
        return (x * scale).to(self.dtype)


# ----------------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------------


def init_norm(create, cfg, layers: int) -> dict:
    if cfg.norm_kind == "nonparam_ln":
        return {}
    p = {"scale": create((layers, cfg.d_model), mode="ones")}
    if cfg.norm_kind == "layernorm":
        p["bias"] = create((layers, cfg.d_model), mode="zeros")
    return p


def apply_norm(cfg, p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """rmsnorm, layernorm or nonparam_ln over the last dim, in float32."""
    xf = x.float()
    if cfg.norm_kind == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        out = xf * p["scale"].float()
    else:  # layernorm / nonparam_ln
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + eps)
        if cfg.norm_kind == "layernorm":
            xf = xf * p["scale"].float() + p["bias"].float()
        out = xf
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Rotary embeddings
# ----------------------------------------------------------------------------


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split RoPE. x [B, S, H, D]; pos [S] or [B, S]."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = pos.float()[..., None] * inv  # [S, half] or [B, S, half]
    if ang.ndim == 2:
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


# ----------------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------------


def init_mlp(create, cfg, layers: int) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    p = {"wi": create((layers, d, ff), fan_in=d), "wo": create((layers, ff, d), fan_in=ff)}
    if cfg.mlp_kind == "swiglu":
        p["wg"] = create((layers, d, ff), fan_in=d)
    return p


def apply_mlp(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["wi"]
    if cfg.mlp_kind == "swiglu":
        g = x @ p["wg"]
        h = F.silu(g.float()).to(x.dtype) * h
    else:
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)  # jax.nn.gelu's default
    return h @ p["wo"]


# ----------------------------------------------------------------------------
# Embedding / head
# ----------------------------------------------------------------------------


def init_embed(create, cfg) -> dict:
    v, d = cfg.padded_vocab, cfg.d_model
    p = {"tok": create((v, d), fan_in=d)}
    if not cfg.tie_embeddings:
        p["head"] = create((d, v), fan_in=d)
    return p


def embed_tokens(cfg, p: dict, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
    out = p["tok"][tokens]
    return out if dtype is None else out.to(dtype)


def lm_logits(cfg, p: dict, h: torch.Tensor) -> torch.Tensor:
    """Logits over the padded vocabulary; tied embeddings use tok^T."""
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    return h @ w
