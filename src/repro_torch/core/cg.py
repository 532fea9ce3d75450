"""Conjugate-gradient solve of H x = b for the CHEF head Hessian
(paper Section 4.1.1: 'we leverage the conjugate gradient method [26] to
approximately compute ∇F_valᵀ H⁻¹').

H is strongly convex (λ-regularized), symmetric positive definite, so plain
CG converges; the loop runs at most `iters` iterations and stops early once
the residual norm falls to `tol`, as the JAX package's while-loop does.
"""
from __future__ import annotations

from typing import Callable

import torch


def cg_solve(hvp_fn: Callable, b: torch.Tensor, *, iters: int = 64, tol: float = 1e-6):
    """Solve H x = b with hvp_fn(v) -> H v. Returns (x, {"residual", "iters"})."""
    x = torch.zeros_like(b)
    r = b
    p = b
    rs = torch.sum(r * r)
    it = 0
    while it < iters and bool(rs > tol * tol):
        Hp = hvp_fn(p)
        alpha = rs / torch.clamp_min(torch.sum(p * Hp), 1e-30)
        x = x + alpha * p
        r = r - alpha * Hp
        rs_new = torch.sum(r * r)
        beta = rs_new / torch.clamp_min(rs, 1e-30)
        p = r + beta * p
        rs = rs_new
        it += 1
    return x, {"residual": torch.sqrt(rs), "iters": it}


def inverse_hvp(w, grad_val, Xa, weights, l2, *, iters=64, tol=1e-6, backend=None):
    """v = H(w)⁻¹ grad_val for the LR head. P is precomputed once only for
    the reference backend; the kernel recomputes probs inside each HVP."""
    from repro_torch.core import lr_head
    from repro_torch.core.backend import get_backend

    backend = get_backend(backend)
    P = lr_head.probs(w, Xa) if backend.name == "reference" else None
    return cg_solve(lambda v: lr_head.hvp(w, v, Xa, weights, l2, P=P, backend=backend),
                    grad_val, iters=iters, tol=tol)
