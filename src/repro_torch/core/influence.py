"""INFL — the paper's modified influence function (Eq. 6).

Closed forms for the cross-entropy LR head (see core/lr_head.py):

    v        = -H(w)⁻¹ ∇F(w, Z_val)                    (CG solve)
    u_i      = v x̃_i                                   [C]   (one matmul)
    Eq. 6:   I(i, c) = (ỹ_i - e_c + (1-γ)(p_i - ỹ_i)) · u_i

Sample priority = min_c I(i,c) (most negative = most harmful = clean first,
paper Section 4.1.1); the argmin class is the suggested cleaned label. The
u_i matmul + score epilogue is the `infl_scores` kernel. The baselines INFL-D
(Eq. 2) and INFL-Y (Eq. 7) are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import lr_head
from repro_torch.core.backend import Backend, get_backend
from repro_torch.core.cg import inverse_hvp
from repro_torch.kernels.infl_scores import infl_scores_plain as infl_scores_reference

__all__ = ["InflResult", "influence_vector", "infl_scores_reference", "infl_scores", "infl",
           "top_b"]


class InflResult(NamedTuple):
    priority: torch.Tensor  # [N] min-over-class score (ascending = clean first)
    suggested: torch.Tensor  # [N] argmin class (INFL's proposed cleaned label)
    scores: torch.Tensor  # [N, C] full score matrix


def influence_vector(w, Xa_val, Y_val, Xa, weights, l2, *, cg_iters=64, cg_tol=1e-6,
                     backend: Optional[Backend] = None):
    """v = -H⁻¹ ∇F_val (shared by INFL and Increm-INFL). Returns (v, stats)."""
    backend = get_backend(backend)
    g_val = lr_head.grad(w, Xa_val, Y_val, Xa_val.new_ones(Xa_val.shape[0]), 0.0,
                         backend=backend.unsharded())
    v, stats = inverse_hvp(w, g_val, Xa, weights, l2, iters=cg_iters, tol=cg_tol,
                           backend=backend)
    return -v, stats


def infl_scores(v, Xa, P, Y, gamma: float, backend: Optional[Backend] = None) -> torch.Tensor:
    """Eq. 6 score matrix [N, C]. P = probs at the current w; Y = current
    probabilistic labels."""
    return get_backend(backend).infl_scores(v, Xa, P, Y, gamma)


def infl(w, v, Xa, Y, gamma: float, P: Optional[torch.Tensor] = None,
         backend: Optional[Backend] = None) -> InflResult:
    """INFL priorities, suggested labels and scores of every sample."""
    backend = get_backend(backend)
    if P is None:
        S = backend.probs_scores(w, v, Xa, Y, gamma)
    else:
        S = infl_scores(v, Xa, P, Y, gamma, backend=backend)
    return InflResult(torch.amin(S, dim=-1), torch.argmin(S, dim=-1), S)


def top_b(priority: torch.Tensor, eligible: torch.Tensor, b: int) -> torch.Tensor:
    """Indices of the b smallest priorities among eligible samples, lowest
    index first among equal values (as `jax.lax.top_k` orders them; a stable
    ascending sort gives that order, `torch.topk` promises none)."""
    masked = torch.where(eligible, priority, torch.full_like(priority, float("inf")))
    return torch.sort(masked, stable=True).indices[:b]
